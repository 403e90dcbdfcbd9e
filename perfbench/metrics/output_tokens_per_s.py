"""output_tokens_per_s: every output token the session delivered to the
host inside the window (first tokens included), over the window's
seconds.  The serving cells offer load above the knee, so the queue never
empties and this is what the system completes."""
from harness import stats


def read(run):
    n = sum(1 for r in run.records for t in r.times if t <= run.end)
    return stats.rate(n, run.seconds) if n else None
