"""decode_graph_share.serve: the share of the traced stretch's decode
steps that replayed the session's captured decode graph: the
``serve.decode.launch`` spans holding a ``serve.decode.replay`` span,
over all of them, in percent.  A program without the decode graph (no
``ServeStats.decode_graph_replays``) reports nothing."""
import bisect
import dataclasses

from harness import spans

REPLAY = "serve.decode.replay"


def _program_has_graph() -> bool:
    from repro_torch.serve import ServeStats

    return any(f.name == "decode_graph_replays" for f in dataclasses.fields(ServeStats))


def read(run):
    if not _program_has_graph() or not spans.readable(run, "decode_graph_share.serve"):
        return None
    launches = spans.intervals(run, spans.DECODE)
    if not launches:
        return None
    replays = spans.intervals(run, REPLAY)
    starts = [a for a, _ in replays]
    held = 0
    for a, b in launches:
        i = bisect.bisect_left(starts, a)
        held += i < len(replays) and replays[i][1] <= b
    return 100.0 * held / len(launches)
