"""The port's examples (``examples/torch_*.py``) and docs
(``docs/torch_*.md``) on the CPU.

Each example runs through its ``main(["--device", "cpu", ...])`` at its
own settings (``torch_train_lm`` at ``--steps 3 --batch 2 --seq 64``), in
a temporary working directory, and its returned dict is held:

* quickstart: a non-empty front and the winner's codegen audit passed;
* dcim_for_llm: the GEMM-class counts, weights and MACs a token of the
  three architectures equal ``repro.dcimmap.extract``'s;
* serve_lm: prefix hits, cross-trace hits, a warm trace that compiles
  nothing and ``stream()`` equal to the result;
* train_lm: finite losses, and a rerun on the same checkpoint directory
  resumes at the last step;
* distributed_dse: oracle coverage for every scenario, the ranks' fronts
  those of the one-process run.

Without a card the default ``--device cuda`` raises.  The docs' ``python``
blocks run through ``scripts/check_docs.py``, with torch and as if torch
were not installed (the repo's CI installs none).  That the examples
import neither ``jax`` nor ``repro`` is held in a fresh interpreter by
``tests/test_torch_smoke.py``.
"""
import importlib
import importlib.util
import math
import pathlib
import sys

import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMES = ("quickstart", "dcim_for_llm", "serve_lm", "train_lm", "distributed_dse")
DOCS = sorted((ROOT / "docs").glob("torch_*.md"))


def _example(name):
    """``examples/torch_<name>.py`` as the module ``torch_<name>`` (the
    spawned ranks of distributed_dse import it by that name)."""
    if str(ROOT / "examples") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples"))
    return importlib.import_module(f"torch_{name}")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the examples run many small ops, whose thread
    pools stall each other when the suite runs a worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_quickstart(workdir):
    res = _example("quickstart").main(["--device", "cpu"])
    assert res["front"] > 0 and res["union"] > res["union_fp"] > 0
    assert len(res["selected"]) == 3 and res["audit_ok"]
    assert (workdir / res["out"] / "floorplan.def").is_file()


def test_dcim_for_llm_workloads_equal_the_reference(workdir):
    from repro import configs as jconfigs
    from repro.dcimmap import extract as jextract

    res = _example("dcim_for_llm").main(["--device", "cpu"])
    for arch, got in res["workloads"].items():
        want = jextract(jconfigs.get_config(arch))
        assert got == {"gemm_classes": len(want.gemms), "weights": want.total_weights(),
                       "macs_per_token": want.macs_per_token(),
                       "unmappable": list(want.unmappable)}, arch
    assert set(res["plans"]) == {"qwen2.5-3b", "phi4-mini-3.8b"}
    # int8 quantization of a N(0, 1/d) weight and N(0, 1) activations
    assert 0 < res["median_rel_err"] < 0.05 and res["cycles"] > 0


def test_serve_lm(workdir):
    res = _example("serve_lm").main(["--device", "cpu"])
    assert res["prefix_hit_tokens"] > 0 and res["cross_trace_hit_tokens"] > 0
    assert res["compiled_after"] == res["compiled_before"]
    assert len(res["streamed"]) == 8 and res["stream_equals_result"]


def test_train_lm_trains_and_resumes(workdir):
    mod = _example("train_lm")
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "64", "--ckpt",
            str(workdir / "ckpt")]
    res = mod.main(argv)
    assert res["final_step"] == 3 and 100e6 < res["n_params"] < 120e6
    assert [h["step"] for h in res["history"]] == [3]
    assert all(math.isfinite(h["loss"]) for h in res["history"])
    # The same run again starts from the step-3 checkpoint: no step left.
    again = mod.main(argv)
    assert again["final_step"] == 3 and again["history"] == []


def test_distributed_dse(workdir):
    from repro_torch.core import explorer
    from repro_torch.core.precision import get
    from repro_torch.core.space import DesignSpace

    mod = _example("distributed_dse")
    res = mod.main(["--device", "cpu"])
    assert res["layout"] == (2, 1)
    hit, n = res["islands_coverage"]
    assert 0 < hit <= n
    assert list(res["coverage"]) == [f"{p}/{w}" for p, w in mod.SCENARIOS]
    for hit, n in res["coverage"].values():
        assert n > 0 and hit >= 0.9 * n      # the reference's bar (MIN_COVERAGE)
    one = explorer.run_islands_multi(mod.SCENARIOS, mod.CFG, n_islands=1, device="cpu",
                                     **mod.ROUNDS)
    # The ranks' fronts are the one-process run's: the same coverage.
    assert {f"{p}/{w}": mod._coverage(r.front_genes.tolist(), DesignSpace(prec=get(p), w_store=w),
                                      "cpu")
            for (p, w), r in zip(mod.SCENARIOS, one)} == res["coverage"]


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        _example(name).main([])


def _check_docs():
    spec = importlib.util.spec_from_file_location("check_docs", ROOT / "scripts" / "check_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_docs_exist():
    assert [d.name for d in DOCS] == ["torch_analysis.md", "torch_dse.md", "torch_kernels.md",
                                     "torch_serving.md"]


@pytest.mark.parametrize("doc", DOCS, ids=[d.name for d in DOCS])
def test_torch_docs_blocks_run(doc):
    assert _check_docs().run_file(doc)


@pytest.mark.parametrize("doc", DOCS, ids=[d.name for d in DOCS])
def test_torch_docs_blocks_run_without_torch(doc, tmp_path, monkeypatch):
    """As in the repo's CI, which installs no torch: a ``torch`` that
    cannot be imported stands first on the path."""
    (tmp_path / "torch").mkdir()
    (tmp_path / "torch" / "__init__.py").write_text(
        "raise ImportError('torch is not installed')\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    assert _check_docs().run_file(doc)
