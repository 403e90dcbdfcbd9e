"""k5_roofline: K5 (``prefix_prefill``) in the traced stretch: the least
time its launches could take on the card (the benchmark's count of their
operations at the bf16 peak and bytes at the HBM rate, of what the
inputs need) over their device time summed by kernel name, as a share."""
from harness import counts, peaks, serve_rows

NAME = "prefix_prefill"


def read(run):
    if run.trace is None or run.widths["kind"] != "gqa":
        return None
    progs = serve_rows.stretch_programs(run)
    device_s = run.trace.kernel_s(NAME)
    if not progs or device_s <= 0 or not serve_rows.launches_match(run, NAME, len(progs)):
        return None
    bound = sum(counts.bound_s(*counts.k5_launch(run.widths, prog), peaks.BF16_FLOPS)
                for prog in progs) * run.widths["layers"]
    return 100.0 * bound / device_s
