"""ttft_p95_ms: the 95th percentile, over every request due in the window,
of the time from its due time (open loop) to its first token on the
host; a request with no first token when the window closes counts its
age then."""
from harness import stats


def read(run):
    recs = run.records
    s = stats.ttft_samples([r.due for r in recs], [r.first for r in recs], run.end)
    return 1e3 * stats.percentile(s, 95) if s else None
