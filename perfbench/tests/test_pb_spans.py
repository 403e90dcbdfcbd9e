"""The serving span readers: on a planted trace the three idle shares
split the stretch's idle time by interval arithmetic and sum to
``idle_share.serve``; a stretch without ticks, or whose launch spans do
not count the programs the session listed, leaves every reader out; a
traced run on the CPU reports all four."""
import types

import pytest

from conftest import run_small
from harness import cli
from harness import trace as tr

IDLE = ("idle_in_launch.serve", "idle_in_scheduler.serve", "idle_between_ticks.serve")
READERS = IDLE + ("decode_launch_ms",)


def _run(span_s, device, host, decode_steps, prefill_programs):
    return types.SimpleNamespace(
        kind="serve", trace=tr.Trace(span_s, [("k", a, b) for a, b in device], host, {}),
        stretch_decode_steps=decode_steps, stretch_prefill_ctx=[[0]] * prefill_programs)


def _planted(decode_steps=2, prefill_programs=1, ticks=True):
    """1.2 s of stretch; events span its first second.  Two ticks, the
    first with a prefill and a decode program, the second with a
    decode; a submission between them."""
    host = [("aten::add", 0.0, 10.0), ("aten::add", 999_990.0, 1_000_000.0),
            ("serve.prefill.launch", 120e3, 220e3), ("serve.prefill.sync", 220e3, 300e3),
            ("serve.decode.launch", 300e3, 380e3), ("serve.decode.sync", 380e3, 440e3),
            ("serve.submit", 500e3, 520e3),
            ("serve.decode.launch", 610e3, 700e3), ("serve.decode.sync", 700e3, 850e3)]
    if ticks:
        host += [("serve.tick", 100e3, 450e3), ("serve.tick", 600e3, 900e3)]
    device = [(150e3, 260e3), (330e3, 430e3), (650e3, 840e3)]
    return _run(1.2, device, sorted(host, key=lambda h: h[1]), decode_steps, prefill_programs)


def _read(run):
    return {name: cli.reader(name).read(run) for name in READERS}


def test_planted_split_sums_to_the_idle_share():
    run = _planted()
    got = _read(run)
    # idle 0.8 s: 0.1 s in launches, 0.15 s in ticks outside them, and
    # 0.35 s between ticks plus the 0.2 s past the last event.
    assert got["idle_in_launch.serve"] == pytest.approx(100 * 0.10 / 1.2, abs=1e-9)
    assert got["idle_in_scheduler.serve"] == pytest.approx(100 * 0.15 / 1.2, abs=1e-9)
    assert got["idle_between_ticks.serve"] == pytest.approx(100 * 0.55 / 1.2, abs=1e-9)
    assert got["decode_launch_ms"] == pytest.approx(85.0, abs=1e-9)
    share = cli.reader("idle_share.serve").read(run)
    assert share == pytest.approx(100 * (1 - 0.4 / 1.2), abs=1e-9)
    assert sum(got[n] for n in IDLE) / 100 == pytest.approx(1 - run.trace.busy_s / 1.2,
                                                            abs=1e-9)


def test_a_gap_half_inside_a_launch_is_split_at_its_edge():
    host = [("serve.tick", 0.0, 1e6), ("serve.decode.launch", 400e3, 700e3),
            ("serve.decode.sync", 700e3, 1e6)]
    got = _read(_run(1.0, [(0.0, 300e3), (500e3, 1e6)], host, 1, 0))
    assert got["idle_in_launch.serve"] == pytest.approx(10.0, abs=1e-9)
    assert got["idle_in_scheduler.serve"] == pytest.approx(10.0, abs=1e-9)
    assert got["idle_between_ticks.serve"] == pytest.approx(0.0, abs=1e-9)
    assert got["decode_launch_ms"] == pytest.approx(300.0, abs=1e-9)


@pytest.mark.parametrize("kw,why", [
    ({"decode_steps": 3}, "3 decode steps"),
    ({"decode_steps": 1}, "1 decode steps"),
    ({"prefill_programs": 2}, "2 prefill programs"),
    ({"prefill_programs": 0}, "0 prefill programs"),
    ({"ticks": False}, "no serve.tick"),
])
def test_every_reader_left_out_where_the_spans_do_not_match(kw, why, capsys):
    assert _read(_planted(**kw)) == dict.fromkeys(READERS)
    err = capsys.readouterr().err
    assert all(f"no {name}" in err for name in READERS) and why in err


def test_a_program_without_spans_reports_nothing():
    run = _planted()
    run.trace.host = [h for h in run.trace.host if not h[0].startswith("serve.")]
    assert _read(run) == dict.fromkeys(READERS)
    assert cli.reader("idle_share.serve").read(run) is not None


def test_traced_cpu_run_reports_the_span_metrics():
    out, run = run_small("qwen2.5-3b.longdoc", trace=True)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(READERS) <= set(m)
    assert sum(m[n] for n in IDLE) == pytest.approx(m["idle_share.serve"], abs=1e-6)
    assert min(m[n] for n in IDLE) >= 0 and m["decode_launch_ms"] > 0
    names = {n for n, _, _ in run.trace.host}
    assert {"serve.tick", "serve.admit", "serve.decode.launch", "serve.decode.sync",
            "serve.emit", "serve.submit"} <= names
    assert not any(n.startswith("serve.") for n, _ in out["breakdown"]["device_ops"])
