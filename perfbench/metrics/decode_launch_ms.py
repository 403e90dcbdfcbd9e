"""decode_launch_ms: the mean host time of the traced stretch's
``serve.decode.launch`` spans: the program's host issuing one decode
step's operators, to its last launch (the wait for its tokens left out),
the time a captured decode program would cut."""
from harness import spans


def read(run):
    if not spans.readable(run, "decode_launch_ms"):
        return None
    d = spans.intervals(run, spans.DECODE)
    return 1e-3 * sum(b - a for a, b in d) / len(d) if d else None
