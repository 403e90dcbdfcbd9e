"""idle_share.serve: 1 less the union of the device's operation intervals
over the traced stretch of a serving window, as a share."""


def read(run):
    if run.trace is None or run.kind != "serve":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.span_s)
