"""The ``decode_graph_share.serve`` reader on planted traces: 100 where
every decode launch span holds a replay span, 0 where none does, the
share between, and nothing where the stretch's spans do not count its
decode steps or the program has no decode graph; a traced CPU run, whose
sessions never capture, reads 0."""
import types

import pytest

from conftest import run_small
from harness import cli
from harness import trace as tr

NAME = "decode_graph_share.serve"


def _run(replays, decode_steps=3):
    """Three ticks of one decode each; ``replays`` says which of the
    three launch spans hold a ``serve.decode.replay`` span."""
    host = []
    for i, held in enumerate(replays):
        t = i * 100e3
        host += [("serve.tick", t, t + 90e3), ("serve.decode.launch", t + 10e3, t + 40e3),
                 ("serve.decode.sync", t + 40e3, t + 80e3)]
        if held:
            host.append(("serve.decode.replay", t + 20e3, t + 30e3))
    return types.SimpleNamespace(
        kind="serve", trace=tr.Trace(0.3, [("k", 0.0, 1e3)], sorted(host, key=lambda h: h[1]),
                                     {}),
        stretch_decode_steps=decode_steps, stretch_prefill_ctx=[])


@pytest.mark.parametrize("replays,share", [
    ((True, True, True), 100.0),
    ((False, False, False), 0.0),
    ((True, False, True), 200.0 / 3),
])
def test_share_of_launch_spans_holding_a_replay(replays, share):
    assert cli.reader(NAME).read(_run(replays)) == pytest.approx(share, abs=1e-9)


def test_a_replay_outside_every_launch_counts_for_none():
    run = _run((False, False, False))
    run.trace.host.append(("serve.decode.replay", 45e3, 50e3))   # in the first sync
    assert cli.reader(NAME).read(run) == 0.0


def test_unreadable_stretch_reports_nothing(capsys):
    assert cli.reader(NAME).read(_run((True, True, True), decode_steps=4)) is None
    assert f"no {NAME}" in capsys.readouterr().err


def test_a_program_without_the_graph_reports_nothing():
    reader = cli.reader(NAME)
    reader._program_has_graph = lambda: False
    assert reader.read(_run((True, True, True))) is None


def test_traced_cpu_run_reads_no_replay():
    out, run = run_small("qwen2.5-3b.longdoc", trace=True)
    assert out["metrics"][NAME]["value"] == 0.0
    assert run.stretch_decode_steps > 0
