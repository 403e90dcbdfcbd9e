"""idle_in_scheduler.serve: the device's idle time over the traced
stretch inside a scheduler tick (``serve.tick``) but outside every
program launch span: admission and seating, argument copies to the
card, the end of each wait for a program's tokens, the token
bookkeeping and the ``on_token`` callbacks; over the stretch's seconds,
as a share."""
from harness import spans


def read(run):
    split = spans.idle_split(run, "idle_in_scheduler.serve")
    return None if split is None else 100.0 * split["scheduler"] / run.trace.span_s
