"""prefill_ms_per_ktok: the program's own host time of its prefill
programs in the window (``ServeStats.prefill_s``, to the sampled tokens
on the host), over the thousands of prompt tokens they prefilled (each
row's prompt less its reused context, never bucket padding); the traced
stretch, which the profiler slows, left out."""
from harness import serve_rows


def read(run):
    progs = serve_rows.untraced_programs(run)
    tokens = sum(tail for rows, _ in progs for tail, _ in rows)
    if not tokens:
        return None
    return 1e3 * sum(s for _, s in progs) / (tokens / 1e3)
