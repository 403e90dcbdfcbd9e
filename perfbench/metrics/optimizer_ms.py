"""optimizer_ms: device time of the kernels launched inside the program's
``train_optimizer`` profiler range (clipping and AdamW) in the traced
step."""


def read(run):
    if run.trace is None or run.kind != "train":
        return None
    s = run.trace.ranges.get("train_optimizer", 0.0)
    return 1e3 * s if s > 0 else None
