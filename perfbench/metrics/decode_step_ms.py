"""decode_step_ms: the program's own host time of a decode step
(``ServeStats.decode_step_s``: a call to its sampled tokens on the host,
device time included), every step of the window over their count; the
traced stretch, which the profiler slows, left out."""
from harness import serve_rows


def read(run):
    d = serve_rows.untraced_decode_steps(run)
    return 1e3 * sum(d) / len(d) if d else None
