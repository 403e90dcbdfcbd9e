"""The result line and BENCHMARK.json keep the contract's shape."""
import json
import re

import pytest

from conftest import ROOT, run_small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _check_line(out, names):
    assert list(out)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(out)[-1] == "checks"
    assert isinstance(out["correct"], bool)
    assert set(out["metrics"]) <= set(names)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_serve_line_untraced_and_traced():
    out, _ = run_small("qwen2.5-3b.longdoc")
    _check_line(out, {"setup_s", "output_tokens_per_s"})
    assert {"setup_s", "output_tokens_per_s"} == set(out["metrics"])
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    out, _ = run_small("qwen2.5-3b.longdoc", trace=True)
    _check_line(out, {m["name"] for m in BENCH["per_layer"]})
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"decode_step_ms", "prefill_ms_per_ktok", "ttft_p95_ms", "itl_p95_ms"} <= set(
        out["metrics"])


def test_train_line():
    out, run = run_small("qwen2.5-3b.train")
    _check_line(out, {"setup_s", "train_tokens_per_s"})
    assert set(out["metrics"]) == {"setup_s", "train_tokens_per_s"}
    assert out["correct"] and run.steps >= 1


@pytest.mark.parametrize("parked", [False, True])
def test_benchmark_json_shape(parked):
    from harness import spec

    BENCH = spec.load_bench(ROOT, parked)
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (ROOT / "perfbench/traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "perfbench/cells" / f"{w['name']}.json").exists()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "perfbench/metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells)
