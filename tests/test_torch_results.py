"""The port's result store, and ``explore_multi(store=...)`` against the
record the reference writes for the same call."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro.core import explorer as jexp
from repro.core import nsga2 as jnsga
from repro.core.results import ResultStore as JResultStore
from repro_torch.core import ResultStore, results
from repro_torch.core import explorer as texp
from repro_torch.core.explorer import ParetoPoint
from repro_torch.core.nsga2 import NSGA2Config
from repro_torch.core.results import dump_json, front_payload, to_jsonable

# tests/test_scenario_batched.py:SMALL_SCENARIOS[:2]
SCENARIOS = [("int4", 4096), ("int8", 16384)]


def _point():
    return ParetoPoint(
        precision="int8", w_store=4096, N=64, H=8, L=8, k=4,
        genes=np.asarray([3, 3, 2], np.int32),
        area=1.0, delay=2.0, energy=3.0, throughput=4.0,
        area_mm2=0.1, delay_ns=1.0, energy_nJ=0.2, tops=5.0,
        tops_per_w=6.0, tops_per_mm2=7.0,
    )


def test_store_round_trip_names_and_envelope(tmp_path):
    store = ResultStore(tmp_path / "nested" / "root")   # the root is created
    p = store.put("cell_a", {"status": "ok", "arr": np.arange(3)}, kind="dryrun", wall_s=1.5)
    assert p == tmp_path / "nested" / "root" / "cell_a.json"
    assert p.exists() and not p.with_suffix(".json.tmp").exists()
    rec = store.get("cell_a")
    assert rec["status"] == "ok" and rec["arr"] == [0, 1, 2]
    assert rec["_record"]["name"] == "cell_a"
    assert rec["_record"]["kind"] == "dryrun" and rec["_record"]["wall_s"] == 1.5
    assert rec["_record"]["created_unix"] > 0
    store.put("b_cell", {"x": 1})
    assert store.names() == ["b_cell", "cell_a"]
    assert "cell_a" in store and "cell_c" not in store
    assert [r["_record"]["name"] for r in store.records()] == ["b_cell", "cell_a"]
    env = store.get("b_cell")["_record"]
    assert (env["kind"], env["wall_s"]) == ("record", None)


@pytest.mark.parametrize("name", ["../escape", "a/b", ".hidden"])
def test_store_rejects_nested_names(tmp_path, name):
    store = ResultStore(tmp_path)
    with pytest.raises(ValueError):
        store.put(name, {})
    with pytest.raises(ValueError):
        store.get(name)
    assert list(tmp_path.iterdir()) == []


def test_to_jsonable_numpy_dataclasses_paths_sets_and_tensors():
    pt = _point()
    out = to_jsonable({
        "i": np.int64(3), "f": np.float32(0.5), "b": np.bool_(True),
        "arr": np.arange(4, dtype=np.int16).reshape(2, 2),
        "path": pathlib.Path("a") / "b.json",
        "set": {7}, "frozen": frozenset([8]), "tuple": (1, "x"),
        "t": torch.tensor([[1.5, -2.0]]), "t0": torch.tensor(3),
        "pt": pt, 5: None,
    })
    json.dumps(out)                                   # plain JSON all through
    assert out["i"] == 3 and type(out["i"]) is int
    assert out["f"] == 0.5 and type(out["f"]) is float
    assert out["b"] is True
    assert out["arr"] == [[0, 1], [2, 3]]
    assert out["path"] == str(pathlib.Path("a") / "b.json")
    assert out["set"] == [7] and out["frozen"] == [8] and out["tuple"] == [1, "x"]
    assert out["t"] == [[1.5, -2.0]] and out["t0"] == 3
    assert out["pt"]["genes"] == [3, 3, 2] and out["pt"]["N"] == 64
    assert out["5"] is None
    assert to_jsonable(object()).startswith("<object")


def test_to_jsonable_and_front_payload_match_the_reference():
    from repro.core import results as jres

    pt = _point()
    assert to_jsonable(pt) == jres.to_jsonable(pt)
    assert front_payload([pt, pt]) == jres.front_payload([pt, pt])
    assert front_payload([]) == {"n_points": 0, "points": []}


def test_dump_json_is_atomic(tmp_path, monkeypatch):
    path = tmp_path / "sub" / "rec.json"
    assert dump_json(path, {"a": np.float64(1.25)}) == path
    assert json.loads(path.read_text()) == {"a": 1.25}
    # A write that fails midway leaves the old record whole and no rename.
    real_replace = results.os.replace
    monkeypatch.setattr(results.os, "replace", lambda *a: (_ for _ in ()).throw(OSError("x")))
    with pytest.raises(OSError):
        dump_json(path, {"a": 2})
    assert json.loads(path.read_text()) == {"a": 1.25}
    monkeypatch.setattr(results.os, "replace", real_replace)
    dump_json(path, {"a": 2})
    assert json.loads(path.read_text()) == {"a": 2}
    assert sorted(p.name for p in path.parent.iterdir()) == ["rec.json"]


def test_explore_multi_records_to_store_like_the_reference(tmp_path):
    store = ResultStore(tmp_path / "port")
    cfg = NSGA2Config(pop_size=32, generations=8)
    pts = texp.explore_multi(SCENARIOS, cfg, store=store, record_name="dse_smoke", device="cpu")
    assert store.names() == ["dse_smoke"]
    rec = store.get("dse_smoke")
    assert rec["n_points"] == len(pts) == len(rec["points"])
    assert rec["scenarios"] == [list(s) for s in SCENARIOS]
    assert rec["batched"] is True and rec["cross_dominate"] is False
    assert rec["_record"]["name"] == "dse_smoke"
    assert rec["_record"]["kind"] == "dse"
    assert rec["_record"]["wall_s"] > 0
    assert rec["points"][0]["area_mm2"] > 0
    assert rec["points"] == [to_jsonable(p) for p in pts]

    jstore = JResultStore(tmp_path / "ref")
    jexp.explore_multi(SCENARIOS, jnsga.NSGA2Config(pop_size=32, generations=8),
                       store=jstore, record_name="dse_smoke")
    jrec = jstore.get("dse_smoke")
    assert rec.keys() == jrec.keys()
    assert rec["_record"].keys() == jrec["_record"].keys()
    assert rec["points"][0].keys() == jrec["points"][0].keys()
    assert [f.name for f in dataclasses.fields(ParetoPoint)] == list(jrec["points"][0])
    for k in ("scenarios", "batched", "cross_dominate"):
        assert rec[k] == jrec[k], k


def test_explore_multi_brute_record_and_no_store(tmp_path):
    store = ResultStore(tmp_path)
    pts = texp.explore_multi(SCENARIOS, method="brute", cross_dominate=True, store=store,
                             device="cpu")
    rec = store.get("explore_multi")
    assert rec["batched"] is False and rec["cross_dominate"] is True
    assert rec["n_points"] == len(pts) > 0
    union = texp.explore_multi(SCENARIOS, method="brute", device="cpu")   # no store
    assert len(union) >= len(pts)
    assert store.names() == ["explore_multi"]
