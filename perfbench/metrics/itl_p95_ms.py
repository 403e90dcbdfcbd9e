"""itl_p95_ms: the 95th percentile of every gap between consecutive output
tokens of every request in the window, the open gap of each request
still producing at the close included."""
from harness import stats


def read(run):
    recs = run.records
    s = stats.itl_samples([r.times for r in recs], [r.done_by(run.end) for r in recs], run.end)
    return 1e3 * stats.percentile(s, 95) if s else None
