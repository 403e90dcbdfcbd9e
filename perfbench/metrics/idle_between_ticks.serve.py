"""idle_between_ticks.serve: the device's idle time over the traced
stretch outside every scheduler tick (``serve.tick``): the pump's
hand-off of the session lock between ticks, submissions holding it, the
stretch's edges; over the stretch's seconds, as a share.  With
``idle_in_launch.serve`` and ``idle_in_scheduler.serve`` it sums to
``idle_share.serve``."""
from harness import spans


def read(run):
    split = spans.idle_split(run, "idle_between_ticks.serve")
    return None if split is None else 100.0 * split["between"] / run.trace.span_s
