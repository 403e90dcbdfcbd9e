"""k7_roofline: K7 (``selective_scan``) in the traced stretch: the least
time its launches could take on the card (the benchmark's count of their
float32 operations at the CUDA cores' peak and bytes at the HBM rate, of
the real tokens) over their device time summed by kernel name, as a
share."""
from harness import counts, peaks, serve_rows

NAME = "selective_scan"


def read(run):
    if run.trace is None or run.widths["kind"] != "mamba":
        return None
    progs = serve_rows.stretch_programs(run)
    device_s = run.trace.kernel_s(NAME)
    if not progs or device_s <= 0 or not serve_rows.launches_match(run, NAME, len(progs)):
        return None
    bound = sum(counts.bound_s(*counts.k7_launch(run.widths, [t for t, _ in prog]),
                               peaks.FP32_FLOPS)
                for prog in progs) * run.widths["layers"]
    return 100.0 * bound / device_s
