"""idle_in_launch.serve: the device's idle time over the traced stretch
while the program's host issues a prefill or decode program's operators
(a ``serve.prefill.launch`` or ``serve.decode.launch`` span open), over
the stretch's seconds, as a share: the idle time a captured program
would take away."""
from harness import spans


def read(run):
    split = spans.idle_split(run, "idle_in_launch.serve")
    return None if split is None else 100.0 * split["launch"] / run.trace.span_s
