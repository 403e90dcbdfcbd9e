"""The port's contract lint (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

* the records and the runner: ``Finding``/``Report`` JSON and
  ``check_runtime_budget``'s verdicts equal the reference's on the same
  inputs;
* one seeded-bad and one clean fixture per check, after the reference's
  ``tests/test_analysis_lint.py``, plus the port-only cases (a CPU 0-dim
  operand, syncs over budget, a Python scalar against a tensor, an int8
  ``torch.mm``, a bf16 product with reduced reduction allowed, an f32
  product under TF32, a kernel stand-in that writes a prefix, a pool
  copied by ``clone``);
* the same defect written in JAX and in torch gives the same (check,
  severity) and the same key data;
* the six single-process contracts lint clean on the CPU, and
  ``sim.dcim_serve`` recovers the reference's bit widths;
* the widening casts of the bf16 train step lie in the islands the
  reference's do (its dense island's excepted: the port's bf16 products
  accumulate in f32 without a cast), and only in ``DEFAULT_ISLANDS``.

Hidden f64 and kernel coverage are held on the port side only: the
reference's fixtures for them are red on jax 0.9.0.
"""
import json
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro_torch.analysis import load_builtin_checks
from repro_torch.analysis import op_trace as ot
from repro_torch.analysis.check_kernels import check_coverage
from repro_torch.analysis.dtype_flow import analyze
from repro_torch.analysis.findings import Finding, Report
from repro_torch.analysis.registry import (
    CHECKS,
    DEFAULT_ISLANDS,
    Built,
    CollectiveUnit,
    DonationUnit,
    ExactnessGate,
    KernelTrace,
    PrecisionPolicy,
    Replay,
)
from repro_torch.models import common

load_builtin_checks()

CPU = torch.device("cpu")
SINGLE = ("kernels.cuda", "lm.prefill_paged", "nsga2.run_batched", "serve.scheduler",
          "sim.dcim_serve", "train.train_step")


def _errors(findings):
    return [f for f in findings if f.severity == "error"]


# --------------------------- records and runner -------------------------------
def test_findings_and_report_json_equal_the_reference():
    from repro.analysis import findings as jf

    args = [("precision", "c", "error", "m", {"site": "x", "n": 3}),
            ("donation", "c", "warning", "w", {}), ("contract", "d", "info", "i", {"a": [1]})]
    port = [Finding(*a) for a in args]
    ref = [jf.Finding(*a) for a in args]
    assert [f.to_json() for f in port] == [f.to_json() for f in ref]
    for make_p, make_r in ((Report, jf.Report),):
        rp = make_p(findings=port, checks_executed=["b", "a", "a"], contracts_executed=["c"],
                    backend="cpu", timings={"c:build": 1.23456})
        rr = make_r(findings=ref, checks_executed=["b", "a", "a"], contracts_executed=["c"],
                    backend="cpu", timings={"c:build": 1.23456})
        assert rp.summary() == rr.summary() and rp.ok == rr.ok
        assert rp.to_json() == rr.to_json()
    with pytest.raises(ValueError):
        Finding("x", "y", "fatal", "m")


@pytest.mark.parametrize("walls", [(10.0, 19.0, 21.0), (5.0, 10.0, 10.01), (3.0, 1.0, 6.5)])
def test_runtime_budget_verdicts_equal_the_reference(tmp_path, walls):
    from repro.analysis.findings import Report as JReport
    from repro.analysis.lint import check_runtime_budget as jcheck

    from repro_torch.analysis import lint as lint_mod
    from repro_torch.analysis.lint import BENCH_PATH, check_runtime_budget

    assert BENCH_PATH == str(pathlib.Path(lint_mod.__file__).with_name("lint_budget.json"))
    rp, rr = Report(timings={"c:build": 1.0}), JReport(timings={"c:build": 1.0})
    bp, br = tmp_path / "port.json", tmp_path / "ref.json"
    for w in walls:
        got = check_runtime_budget(rp, w, str(bp))
        want = jcheck(rr, w, str(br))
        assert (got is None) == (want is None)
        if got is not None:
            assert got.replace(str(bp), "B") == want.replace(str(br), "B")
    assert json.loads(bp.read_text()) == json.loads(br.read_text())
    # record=False writes nothing
    assert check_runtime_budget(rp, 1.0, str(tmp_path / "none.json"), record=False) is None
    assert not (tmp_path / "none.json").exists()


def test_committed_budget_has_a_baseline_per_device_type():
    from repro_torch.analysis.lint import BENCH_PATH

    book = json.loads(pathlib.Path(BENCH_PATH).read_text())
    assert sorted(book) == ["cpu", "cuda"]
    for entry in book.values():
        assert sorted(entry) == ["timings", "total_wall_s"] and entry["total_wall_s"] > 0
        assert {k.partition(":")[0] for k in entry["timings"]} >= {
            "dist.train_dp", "kernels.cuda", "serve.scheduler", "serve.scheduler_tp"}


def test_runtime_budget_over_the_committed_cuda_baseline(tmp_path):
    """Over 2x the committed ``cuda`` baseline: the reference's error
    string (its path aside); at 2x: within budget."""
    from repro.analysis.findings import Report as JReport
    from repro.analysis.lint import check_runtime_budget as jcheck

    from repro_torch.analysis.lint import BENCH_PATH, check_runtime_budget

    book = json.loads(pathlib.Path(BENCH_PATH).read_text())
    base = book["cuda"]["total_wall_s"]
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps(book["cuda"]))
    for wall in (2 * base + 0.01, 3 * base, 100 * base):
        got = check_runtime_budget(Report(), wall, record=False, device="cuda")
        want = jcheck(JReport(), wall, str(ref), record=False)
        assert got is not None and got.replace(BENCH_PATH, "B") == want.replace(str(ref), "B")
    assert check_runtime_budget(Report(), 2 * base, record=False, device="cuda") is None
    assert json.loads(pathlib.Path(BENCH_PATH).read_text()) == book


def test_runtime_budget_keyed_by_device(tmp_path):
    """Each device type records its own baseline when absent, beside the
    others, and is held to its own."""
    from repro_torch.analysis.lint import check_runtime_budget

    bp = tmp_path / "budget.json"
    rp = Report(timings={"c:build": 1.0})
    assert check_runtime_budget(rp, 10.0, str(bp), device="cpu") is None
    assert check_runtime_budget(rp, 3.0, str(bp), device="cuda") is None
    book = json.loads(bp.read_text())
    assert book == {"cpu": {"total_wall_s": 10.0, "timings": {"c:build": 1.0}},
                    "cuda": {"total_wall_s": 3.0, "timings": {"c:build": 1.0}}}
    assert check_runtime_budget(rp, 19.0, str(bp), device="cpu") is None
    assert "exceeds budget 6.0s" in check_runtime_budget(rp, 7.0, str(bp), device="cuda")
    assert check_runtime_budget(rp, 1.0, str(bp), device="tpu", record=False) is None
    assert json.loads(bp.read_text()) == book


@pytest.mark.parametrize("ranks", [1, 2])
def test_lint_cli_budget_only_for_the_full_suite(ranks, monkeypatch, tmp_path):
    """``--all`` records or enforces the device type's baseline only when
    every contract ran (``--ranks 2`` runs the multi-rank ones)."""
    from repro_torch.analysis import CONTRACTS
    from repro_torch.analysis import lint as lint_mod

    lint_mod._load_all()
    ran = sorted(n for n, c in CONTRACTS.items() if c.ranks <= ranks)
    seen = []
    monkeypatch.setattr(lint_mod, "run_lint", lambda **kw: Report(contracts_executed=ran))
    monkeypatch.setattr(lint_mod, "check_runtime_budget",
                        lambda report, wall_s, device=None: seen.append(device))
    assert lint_mod.main(["--all", "--device", "cpu", "--ranks", str(ranks),
                          "--out", str(tmp_path / "r.json")]) == 0
    assert seen == ([] if ranks == 1 else ["cpu"])


def test_lint_cli_list_and_unknown(capsys):
    from repro_torch.analysis.lint import main, run_lint

    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    checks = out.split("checks:")[1].split("contracts:")[0].split()
    assert checks == ["collectives", "donation", "kernels", "precision", "recompile",
                      "transfers"]
    contracts = [ln.split()[0] for ln in out.split("contracts:")[1].strip().splitlines()]
    assert contracts == ["dist.train_dp", "kernels.cuda", "lm.prefill_paged",
                         "nsga2.run_batched", "serve.scheduler", "serve.scheduler_tp",
                         "sim.dcim_serve", "train.train_step"]
    with pytest.raises(ValueError, match="unknown"):
        run_lint(checks=["nope"], device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        run_lint(contracts=["nope"], device="cpu")


def test_cuda_raises_without_a_card():
    from repro_torch.analysis.lint import run_lint

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run_lint(device="cuda")


def test_resolve_turns_reduced_reduction_off(monkeypatch):
    from repro_torch import device

    m = torch.backends.cuda.matmul
    before = (m.allow_bf16_reduced_precision_reduction, m.allow_fp16_reduced_precision_reduction)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        m.allow_bf16_reduced_precision_reduction = True
        m.allow_fp16_reduced_precision_reduction = True
        device.resolve("cpu")
        assert m.allow_bf16_reduced_precision_reduction
        device.resolve("cuda")
        assert not m.allow_bf16_reduced_precision_reduction
        assert not m.allow_fp16_reduced_precision_reduction
        assert ot.matmul_flags("cuda") == (m.allow_tf32, False, False)
    finally:
        m.allow_bf16_reduced_precision_reduction, m.allow_fp16_reduced_precision_reduction = before


# --------------------------- op traces -----------------------------------------
def test_record_sees_islands_calls_syncs_and_backward():
    x = torch.randn(4, dtype=torch.bfloat16, requires_grad=True)

    def prog():
        with common.precision_island("norm"), common.named_call("f"):
            y = x.to(torch.float32) * 2
        z = y.to(torch.bfloat16).sum()
        z.backward()
        return float(z.detach()), torch.nonzero(x.detach() > 0)

    tr = ot.record(prog)
    fwd = [r for r in tr.records if r.name == "_to_copy" and not r.backward]
    assert fwd[0].islands == frozenset({"norm"}) and fwd[0].calls == ("f",)
    bwd = [r for r in tr.records if r.backward and r.name == "_to_copy"
           and r.out_dtypes == ("float32",)]
    assert bwd and all("norm" not in r.islands for r in bwd)   # made outside the island
    bwd_in = [r for r in tr.records if r.backward and r.name == "_to_copy"
              and r.out_dtypes == ("bfloat16",)]
    assert bwd_in and all(r.islands == frozenset({"norm"}) for r in bwd_in)
    assert tr.sync_counts() == {"_local_scalar_dense": 1, "nonzero": 1}
    assert [c.name for c in tr.calls] == ["f"]
    # nothing is left on the stacks, and outside a recording nothing is pushed
    from repro_torch.analysis import scopes

    assert scopes.ISLANDS == [] and scopes.CALLS == [] and not scopes.RECORDING
    with common.precision_island("norm"):
        assert scopes.ISLANDS == []


def _assert_acyclic(graph):
    state = {}
    for root in graph:
        if state.get(root):
            continue
        stack = [(root, iter(graph.get(root, ())))]
        state[root] = 1
        while stack:
            node, it = stack[-1]
            dep = next(it, None)
            if dep is None:
                state[node] = 2
                stack.pop()
                continue
            assert state.get(dep) != 1, f"provenance cycle through {dep}"
            if dep not in state:
                state[dep] = 1
                stack.append((dep, iter(graph.get(dep, ()))))


@pytest.mark.parametrize("seed", range(6))
def test_provenance_is_a_dag_and_islands_mask_their_subtree(seed):
    rng = np.random.default_rng(seed)
    dtypes = [(torch.float32, torch.bfloat16, torch.float16, torch.int32)[i]
              for i in rng.integers(0, 4, rng.integers(1, 7))]

    def prog(x):
        h = x
        with common.precision_island("outer"):
            for i, d in enumerate(dtypes):
                with common.precision_island(f"inner{i}"):
                    h = h.to(d) + (h.to(d) if i % 2 else 0)
        return h

    flow = analyze(ot.record(prog, torch.zeros(4)))
    _assert_acyclic(flow.provenance_graph())
    assert all(d in flow.dtypes for d in (ot.dtype_name(t) for t in dtypes))
    prev, expected = "float32", set()
    for i, d in enumerate(dtypes):
        if ot.dtype_name(d) != prev:
            expected.add(f"inner{i}")
        prev = ot.dtype_name(d)
    seen = set()
    for cast in flow.casts:
        assert "outer" in cast.islands
        inner = {n for n in cast.islands if n.startswith("inner")}
        assert len(inner) == 1
        seen |= inner
    assert seen == expected


def test_signatures_mark_python_scalars():
    a = ot.canonical_signature((torch.ones(()), {"k": np.zeros(3, np.int64)}, 2, 1.5, None))
    assert a == "(float32[]|cpu,{k:int64[3]|numpy},int64[]|py,float32[]|py,None)"
    assert ot.strip_py(ot.canonical_signature((1.0,))) == \
        ot.strip_py(ot.canonical_signature((torch.tensor(1.0),)))
    assert ot.strip_py(ot.canonical_signature((torch.ones(2),))) != \
        ot.strip_py(ot.canonical_signature((torch.ones(3),)))


def test_dcim_mvm_ref_card_product_is_exact():
    """The card's digit product of ``dcim_mvm_ref`` (float32 matmuls of
    8-bit digits), run here on the CPU, equals the int64 product."""
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(0)
    for bits, K in ((1, 40), (8, 300), (16, 70_000), (24, 513)):
        a = torch.randint(0, 1 << bits, (3, 5, K), generator=g)
        b = torch.randint(0, 2, (1, K, 7), generator=g)
        assert torch.equal(ref.int_dot_digits(a, b, bits), a @ b)


# --------------------------- donation ------------------------------------------
def test_donation_dropped_fixture():
    state = {"x": torch.ones((256, 256))}

    def run():
        state["x"] = state["x"] + 1.0       # a new buffer every call

    findings = CHECKS["donation"]("fixture", Built(donation=[
        DonationUnit("bad_donate", run, lambda: state)]))
    errs = _errors(findings)
    assert len(errs) == 1 and "replaced" in errs[0].message
    assert errs[0].data["dropped"][0]["nbytes"] == 256 * 256 * 4


def test_donation_clean_fixture():
    state = {"x": torch.ones((256, 256))}
    findings = CHECKS["donation"]("fixture", Built(donation=[
        DonationUnit("good_donate", lambda: state["x"].add_(1.0), lambda: state)]))
    assert not _errors(findings)


def test_donation_pool_copied_by_clone_fixture():
    pool = ({"k": torch.zeros((9, 8, 2, 4)), "v": torch.zeros((9, 8, 2, 4))},)

    def run():
        for leaf in pool[0].values():
            new = leaf.clone()
            new[1] = 1.0
            leaf.copy_(new)             # storage kept, the buffer copied whole

    errs = _errors(CHECKS["donation"]("fixture", Built(donation=[
        DonationUnit("pool", run, lambda: pool)])))
    assert len(errs) == 1 and "copy a donated buffer whole" in errs[0].message
    assert {c["path"] for c in errs[0].data["copies"]} == {"0/k", "0/v"}
    # under donate_min_bytes nothing is tracked
    assert not _errors(CHECKS["donation"]("fixture", Built(donation=[
        DonationUnit("pool", run, lambda: pool, donate_min_bytes=1 << 20)])))


# --------------------------- transfers -----------------------------------------
def test_transfers_implicit_fixture():
    # A CPU 0-dim tensor fed to an op on another device: torch copies it
    # there silently on every call (meta stands in for the card here).
    x = torch.ones(8, device="meta")
    built = Built(hot=lambda: x * torch.tensor(2.0), hot_label="0-dim operand")
    errs = _errors(CHECKS["transfers"]("fixture", built))
    assert len(errs) == 1 and "implicit host-to-device" in errs[0].message


def test_transfers_clean_fixture():
    x = torch.ones(8)
    findings = CHECKS["transfers"]("fixture", Built(hot=lambda: x * 2.0, sync_budget=0))
    assert not _errors(findings)
    assert findings[0].data["syncs"] == 0


def test_transfers_sync_over_budget_fixture():
    x = torch.arange(6.0)
    calls = {"n": 0}

    def hot():
        calls["n"] = 3
        return [float(x[i]) for i in range(4)] + [torch.nonzero(x)]

    errs = _errors(CHECKS["transfers"]("fixture", Built(
        hot=hot, hot_calls=lambda: calls["n"], sync_budget=1)))
    assert len(errs) == 1 and "5 host syncs over 3 hot call(s)" in errs[0].message
    assert errs[0].data["syncs_by_kind"] == {"_local_scalar_dense": 4, "nonzero": 1}
    assert not _errors(CHECKS["transfers"]("fixture", Built(
        hot=hot, hot_calls=lambda: calls["n"], sync_budget=2)))


# --------------------------- recompile -----------------------------------------
def test_recompile_placement_drift_fixture():
    # The same program called with a Python scalar and with a tensor at
    # one argument: signatures differ only in where the leaf lives.
    sigs = [("step", ot.canonical_signature((torch.ones(2), 1.0))),
            ("step", ot.canonical_signature((torch.ones(2), torch.tensor(1.0))))]
    errs = _errors(CHECKS["recompile"]("fixture", Built(replay=Replay(
        signatures=sigs, max_programs={"step": 1}))))
    assert any("placement drift" in e.message for e in errs)
    assert any("2 distinct call signatures" in e.message for e in errs)


def test_recompile_budget_and_live_cache_fixture():
    replay = Replay(
        signatures=[("step", "(float32[2]|cpu)"), ("step", "(float32[4]|cpu)")],
        max_programs={"step": 1}, live_counts={"step": 3}, live_budget={"step": 1})
    errs = _errors(CHECKS["recompile"]("fixture", Built(replay=replay)))
    assert any("2 distinct call signatures" in e.message for e in errs)
    assert any("holds 3 program shapes" in e.message for e in errs)
    assert not any("drift" in e.message for e in errs)


def test_recompile_clean_fixture():
    replay = Replay(signatures=[("step", "(float32[2]|cpu)")] * 3, max_programs={"step": 1},
                    live_counts={"step": 1}, live_budget={"step": 1})
    assert not CHECKS["recompile"]("fixture", Built(replay=replay))


# --------------------------- collectives ---------------------------------------
def test_collectives_oversized_fixture():
    unit = CollectiveUnit("bad", [{"op": "all-gather", "bytes": 256.0},
                                  {"op": "all-gather", "bytes": 1024.0},
                                  {"op": "all-reduce", "bytes": 1e9}], {"all-gather": 512})
    errs = _errors(CHECKS["collectives"]("fixture", Built(collectives=[unit])))
    assert len(errs) == 1
    site = errs[0].data["site"]
    assert site["collective"] == "all-gather" and site["bytes"] == 1024 and site["call"] == 1


def test_collectives_forbidden_and_clean_fixture():
    calls = [{"op": "all-to-all", "bytes": 8.0}]
    errs = _errors(CHECKS["collectives"]("fixture", Built(collectives=[
        CollectiveUnit("forbid", calls, {"all-to-all": 0})])))
    assert len(errs) == 1 and "forbidden" in errs[0].message
    findings = CHECKS["collectives"]("fixture", Built(collectives=[
        CollectiveUnit("roomy", calls, {"all-to-all": 1 << 20})]))
    assert not _errors(findings) and "within budget" in findings[0].message


def test_counter_keeps_each_call_and_the_ring_counts_into_it():
    from repro_torch.dist import sharding as shd

    counter = {}
    ctx = shd.MeshContext({"data": 2, "model": 1}, counter=counter)
    ctx.gather_block(torch.zeros(3, 4), ("data", None))
    ctx.gather_block(torch.zeros(5, 4), ("data", None))
    with shd.use_mesh(ctx):
        shd.count_collective("ring-int8", 7)
    assert counter["all-gather"] == {"count": 2, "bytes": 256.0, "max": 160.0,
                                     "calls": [96.0, 160.0]}
    assert counter["ring-int8"]["calls"] == [7.0]


# --------------------------- kernels -------------------------------------------
def _scan_trace():
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(0)
    ins = (torch.randn(2, 64, 128, generator=g), torch.rand(2, 64, 128, generator=g) * 0.1,
           torch.randn(2, 64, 16, generator=g), torch.randn(2, 64, 16, generator=g),
           -torch.rand(128, 16, generator=g), torch.randn(128, generator=g))
    return KernelTrace("selective_scan", "selective_scan", ops.selective_scan,
                       ref.selective_scan_ref, ins, ops.SCAN_TOL)


def test_kernels_short_grid_fixture():
    # A stand-in that writes only the first half of its output's rows: a
    # grid that stops short.  The rest is whatever the allocator handed
    # back, poison where it reuses the poisoned block.
    trace = _scan_trace()

    def short(*ins):
        y, h = trace.plain(*ins)
        out = torch.empty_like(y)
        out[:, :32] = y[:, :32]
        return out, h

    errs = _errors(check_coverage("fixture", trace, call=short))
    assert len(errs) == 1 and "never written" in errs[0].message
    assert errs[0].data["output"] == 0 and errs[0].data["wrong"] > 0
    assert not check_coverage("fixture", trace)


def test_kernels_clean_repo_kernels():
    from repro_torch.analysis.lint import run_lint

    report = run_lint(checks=["kernels"], contracts=["kernels.cuda"], device="cpu")
    assert report.ok, [f.message for f in report.findings]
    msgs = [f.message for f in report.findings]
    assert len(msgs) == 7 and all("plain versions off the card" in m for m in msgs)


# --------------------------- precision -----------------------------------------
def _precision(programs, **policy):
    return CHECKS["precision"]("fixture", Built(
        programs=programs, precision=PrecisionPolicy(**policy)))


def test_precision_hidden_f64_fixture():
    tr = ot.record(lambda x: x * torch.tensor(2.0, dtype=torch.float64), torch.zeros(4))
    errs = _errors(_precision([("f64", tr)], compute_dtype="float32"))
    assert any("float64" in e.message for e in errs)


def test_precision_widening_needs_island_fixture():
    x = torch.zeros(4, dtype=torch.bfloat16)

    def good(v):
        with common.precision_island("logits"):
            return v.to(torch.float32).sum()

    errs = _errors(_precision([("p", ot.record(lambda v: v.to(torch.float32).sum(), x))],
                              compute_dtype="bfloat16"))
    assert len(errs) == 1 and "widening cast" in errs[0].message
    assert not _errors(_precision([("p", ot.record(good, x))], compute_dtype="bfloat16"))


def _with_flags(trace, device, flags):
    import dataclasses

    trace.records = [dataclasses.replace(r, device=device, flags=flags) for r in trace.records]
    return trace


def test_precision_bf16_reduced_reduction_fixture():
    x, w = torch.ones(4, 8, dtype=torch.bfloat16), torch.ones(8, 2, dtype=torch.bfloat16)
    # On the CPU the product accumulates in f32: clean.
    assert not _errors(_precision([("p", ot.record(torch.mm, x, w))], compute_dtype="bfloat16"))
    # The same product recorded where reduced-precision reduction is on.
    bad = _with_flags(ot.record(torch.mm, x, w), "cuda", (False, True, True))
    errs = _errors(_precision([("p", bad)], compute_dtype="bfloat16"))
    assert len(errs) == 1 and "reduced-precision reduction was allowed" in errs[0].message
    assert (errs[0].data["lhs"], errs[0].data["rhs"], errs[0].data["out"]) == \
        ("bfloat16", "bfloat16", "bfloat16")
    off = _with_flags(ot.record(torch.mm, x, w), "cuda", (False, False, True))
    assert not _errors(_precision([("p", off)], compute_dtype="bfloat16"))


def test_precision_f16_reduced_reduction_fixture():
    # f16 products answer to their own flag, not bf16's.
    x, w = torch.ones(4, 8, dtype=torch.float16), torch.ones(8, 2, dtype=torch.float16)
    bad = _with_flags(ot.record(torch.mm, x, w), "cuda", (False, False, True))
    errs = _errors(_precision([("p", bad)], compute_dtype="float16"))
    assert len(errs) == 1 and errs[0].data["flags"] == [False, False, True]
    ok = _with_flags(ot.record(torch.mm, x, w), "cuda", (False, True, False))
    assert not _errors(_precision([("p", ok)], compute_dtype="float16"))


def test_precision_f32_under_tf32_fixture():
    x, w = torch.ones(4, 8), torch.ones(8, 2)
    mk = torch.backends.mkldnn.matmul
    prev = mk.fp32_precision
    mk.fp32_precision = "tf32"
    try:
        tr = ot.record(torch.mm, x, w)
    finally:
        mk.fp32_precision = prev
    errs = _errors(_precision([("p", tr)], compute_dtype="float32"))
    assert len(errs) == 1 and "TF32" in errs[0].message
    assert not _errors(_precision([("p", ot.record(torch.mm, x, w))], compute_dtype="float32"))


def test_precision_int8_product_fixture():
    a = torch.ones(4, 8, dtype=torch.int8)
    errs = _errors(_precision([("p", ot.record(torch.mm, a, a.t()))], compute_dtype="float32"))
    assert len(errs) == 1 and "integer int8xint8" in errs[0].message
    assert errs[0].data["out"] == "int8"
    wide = ot.record(lambda u: torch.mm(u.long(), u.t().long()), a)
    assert not _errors(_precision([("p", wide)], compute_dtype="float32"))


def _bypass_port(x, w):
    with common.precision_island("dense"):
        return torch.matmul(x, w)


def test_precision_dcim_bypassed_dense_fixture():
    tr = ot.record(_bypass_port, torch.zeros(4, 8), torch.zeros(8, 2))
    errs = _errors(_precision([("decode", tr)], compute_dtype="float32",
                              dcim_programs={"decode": "int8"}))
    assert any("bypasses the installed DCIM numerics" in e.message for e in errs)
    assert any("never calls" in e.message for e in errs)


def _asym_port(x, w):
    from repro_torch.kernels import ops

    with common.precision_island("dense"):
        qmax = 127
        sx = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / qmax
        sw = torch.clamp_min(torch.max(torch.abs(w)), 1e-12) / qmax
        qx = torch.clamp(torch.round(x / sx), -qmax - 1, qmax)
        qw = torch.clamp(torch.round(w / sw), -qmax, qmax)
        y = ops.dcim_mvm(qx.to(torch.int32), qw.to(torch.int32), B_x=8, B_w=8, k=4)
        return y.to(torch.float32) * (sx * sw)


def test_precision_asymmetric_clip_fixture():
    tr = ot.record(_asym_port, torch.zeros(4, 8), torch.zeros(8, 4))
    errs = _errors(_precision([("decode", tr)], compute_dtype="float32",
                              dcim_programs={"decode": "int8"}))
    assert any("asymmetric quantizer clip [-128.0, 127.0]" in e.message for e in errs)
    assert not any("recovers bit widths" in e.message for e in errs)


def _gate_port():
    pool = {"k": torch.zeros((2, 4), dtype=torch.bfloat16),
            "v": torch.zeros((2, 4), dtype=torch.bfloat16)}
    tr = ot.record(lambda p: (p["k"].sum(), p["v"].sum()), pool)
    leaves = ot.pool_leaf_specs(pool)
    findings = _precision(
        [("decode", tr)], compute_dtype="float32", audit_widening=False,
        gates=[ExactnessGate("prefix_reuse", True, "decode", leaves),
               ExactnessGate("preempt", True, "decode", [("missing", "float32", (9, 9), 0)]),
               ExactnessGate("orphan", True, "never_traced", leaves)])
    return findings, pool


def test_precision_gate_lossy_and_unmatched_fixture():
    errs = _errors(_gate_port()[0])
    assert any("claimed ENABLED" in e.message and "lossy" in e.message for e in errs)
    assert any("is not read by the recorded" in e.message for e in errs)
    assert any("did not trace" in e.message for e in errs)


def test_precision_gate_verified_fixture():
    pool = {"k": torch.zeros((2, 4))}
    tr = ot.record(lambda p: p["k"].sum(), pool)
    findings = _precision([("decode", tr)], compute_dtype="float32", gates=[
        ExactnessGate("prefix_reuse", True, "decode", ot.pool_leaf_specs(pool))])
    assert not _errors(findings)
    assert any("verified" in f.message for f in findings)
    # a pool of the same shape that the program never read does not match
    other = {"k": torch.zeros((2, 4))}
    errs = _errors(_precision([("decode", tr)], compute_dtype="float32", gates=[
        ExactnessGate("prefix_reuse", True, "decode", ot.pool_leaf_specs(other))]))
    assert len(errs) == 1 and "not read" in errs[0].message


# --------------------------- parity with the reference's findings ------------------
def _jax_precision(fn, *args, **policy):
    import jax

    from repro.analysis import load_builtin_checks as jload
    from repro.analysis.registry import CHECKS as JCHECKS
    from repro.analysis.registry import Built as JBuilt
    from repro.analysis.registry import PrecisionPolicy as JPolicy

    jload()
    jaxpr = jax.make_jaxpr(fn)(*args)
    return JCHECKS["precision"]("fixture", JBuilt(
        hot_jaxprs=[("decode", jaxpr)], precision=JPolicy(**policy)))


def _key(findings, *keys):
    return sorted((f.check, f.severity) + tuple(str(f.data.get(k)) for k in keys)
                  for f in findings if f.severity != "info")


def test_parity_widening_outside_an_island():
    import jax.numpy as jnp

    want = _jax_precision(lambda v: v.astype(jnp.float32).sum(), jnp.zeros(4, jnp.bfloat16),
                          compute_dtype="bfloat16")
    got = _precision([("decode", ot.record(lambda v: v.to(torch.float32).sum(),
                                           torch.zeros(4, dtype=torch.bfloat16)))],
                     compute_dtype="bfloat16")
    assert _key(got, "src", "dst", "islands") == _key(want, "src", "dst", "islands")
    assert len(_errors(got)) == 1


def test_parity_undeclared_low_precision_dot():
    import jax
    import jax.numpy as jnp

    want = _jax_precision(lambda a, b: jax.lax.dot(a, b), jnp.zeros((4, 8), jnp.bfloat16),
                          jnp.zeros((8, 2), jnp.bfloat16), compute_dtype="bfloat16")
    tr = _with_flags(ot.record(torch.mm, torch.zeros(4, 8, dtype=torch.bfloat16),
                               torch.zeros(8, 2, dtype=torch.bfloat16)),
                     "cuda", (False, True, True))
    got = _precision([("decode", tr)], compute_dtype="bfloat16")
    assert _key(got, "lhs", "rhs", "required") == _key(want, "lhs", "rhs", "required")


def test_parity_raw_float_dot_in_dense_under_dcim():
    import jax.numpy as jnp

    from repro.models import common as jcommon

    def bypass(x, w):
        with jcommon.precision_island("dense"):
            return jnp.matmul(x, w, preferred_element_type=jnp.float32)

    pol = dict(compute_dtype="float32", dcim_programs={"decode": "int8"})
    want = _jax_precision(bypass, jnp.zeros((4, 8), jnp.float32), jnp.zeros((8, 2), jnp.float32),
                          **pol)
    got = _precision([("decode", ot.record(_bypass_port, torch.zeros(4, 8),
                                           torch.zeros(8, 2)))], **pol)
    assert _key(got, "dtype", "missing", "precision") == _key(want, "dtype", "missing", "precision")


def test_parity_asymmetric_clip():
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.models import common as jcommon

    def bad_mvm(x, w):
        with jcommon.precision_island("dense"):
            qmax = 127
            sx = jnp.maximum(jnp.max(jnp.abs(x)), 1e-12) / qmax
            sw = jnp.maximum(jnp.max(jnp.abs(w)), 1e-12) / qmax
            qx = jnp.clip(jnp.round(x / sx), -qmax - 1, qmax)
            qw = jnp.clip(jnp.round(w / sw), -qmax, qmax)
            y = jops.dcim_mvm(qx.astype(jnp.int32), qw.astype(jnp.int32), B_x=8, B_w=8, k=4)
            return y.astype(jnp.float32) * (sx * sw)

    pol = dict(compute_dtype="float32", dcim_programs={"decode": "int8"})
    want = _jax_precision(bad_mvm, jnp.zeros((4, 8), jnp.float32), jnp.zeros((8, 4), jnp.float32),
                          **pol)
    got = _precision([("decode", ot.record(_asym_port, torch.zeros(4, 8),
                                           torch.zeros(8, 4)))], **pol)
    assert _key(got, "lo", "hi") == _key(want, "lo", "hi")
    assert any(f.data.get("lo") == -128.0 for f in got)


def test_parity_lossy_gate_and_unmatched_leaf():
    import jax
    import jax.numpy as jnp

    from repro.analysis.jaxpr_tools import pytree_leaf_specs
    from repro.analysis.registry import ExactnessGate as JGate

    pool = {"k": jnp.zeros((2, 4), jnp.bfloat16), "v": jnp.zeros((2, 4), jnp.bfloat16)}
    leaves = pytree_leaf_specs(pool)
    want = _jax_precision(
        lambda p, x: (p["k"].sum(), p["v"].sum(), x), pool, jnp.zeros((), jnp.float32),
        compute_dtype="float32", audit_widening=False,
        gates=[JGate("prefix_reuse", True, "decode", leaves),
               JGate("preempt", True, "decode", [("['missing']", "float32", (9, 9))]),
               JGate("orphan", True, "never_traced", leaves)])
    del jax
    got, _ = _gate_port()
    assert _key(got, "gate", "program", "dtype", "compute_dtype") == \
        _key(want, "gate", "program", "dtype", "compute_dtype")


# --------------------------- the contracts, clean ------------------------------------
def test_single_process_contracts_lint_clean_on_the_cpu():
    from repro_torch.analysis.lint import run_lint

    report = run_lint(device="cpu")
    assert report.ok, [f"{f.check}/{f.contract}: {f.message}" for f in _errors(report.findings)]
    assert sorted(set(report.contracts_executed)) == sorted(SINGLE)
    skipped = {f.contract for f in report.findings if f.message.startswith("skipped")}
    assert skipped == {"dist.train_dp", "serve.scheduler_tp"}
    # every check but the collectives', which only the multi-rank contracts run
    assert sorted(set(report.checks_executed)) == sorted(set(CHECKS) - {"collectives"})
    sync = [f for f in report.findings if f.check == "transfers"]
    assert {f.contract for f in sync} == {"lm.prefill_paged", "nsga2.run_batched",
                                          "serve.scheduler", "train.train_step"}
    assert all("syncs_by_kind" in f.data for f in sync)


def test_dcim_serve_recovers_the_reference_widths():
    from repro.analysis.lint import run_lint as jrun

    from repro_torch.analysis.lint import run_lint

    def widths(report):
        return sorted((f.data["program"], str(f.data.get("recovered")), f.data.get("B_M"),
                       f.data.get("B_w")) for f in report.findings
                      if "routing verified" in f.message)

    got = run_lint(checks=["precision"], contracts=["sim.dcim_serve"], device="cpu")
    want = jrun(checks=["precision"], contracts=["sim.dcim_serve"])
    assert got.ok and want.ok
    assert widths(got) == widths(want) and len(widths(got)) == 4


def test_train_step_islands_match_the_reference():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.analysis.dtype_flow import analyze as janalyze
    from repro.optim import get_optimizer as jopt
    from repro.train.train_step import init_state as jinit
    from repro.train.train_step import make_train_step as jstep

    from repro_torch.analysis.registry import CONTRACTS
    from repro_torch.analysis.lint import _load_all

    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen2.5-3b"),
                               param_dtype="bfloat16", compute_dtype="bfloat16")
    opt = jopt("adamw", 1e-3)
    state = jinit(jax.random.PRNGKey(0), jcfg, opt)
    toks = jnp.zeros((2, 16), jnp.int32)
    batch = {"tokens": toks, "targets": toks, "loss_mask": jnp.ones((2, 16), jnp.float32)}
    jflow = janalyze(jax.make_jaxpr(jstep(jcfg, opt))(state, batch))
    want = set().union(*[c.islands for c in jflow.casts if c.widening])

    _load_all()
    built = CONTRACTS["train.train_step"].build(CPU)
    flow = analyze(dict(built.programs)["train_step"])
    widening = [c for c in flow.casts if c.widening]
    got = set().union(*[c.islands for c in widening])
    # The reference's dense widens its bf16 operands for its f32-output
    # product; the port's bf16 product accumulates in f32 inside the GEMM
    # (on the CPU, and on the card with reduced-precision reduction off),
    # so its dense island holds the products and no cast.
    assert want - {"dense"} <= got, (want, got)
    dense = [d for d in flow.dots if "dense" in d.islands]
    assert dense and all((d.lhs_dtype, d.rhs_dtype) == ("bfloat16", "bfloat16")
                         and not d.flags[1] for d in dense)
    assert all(c.islands & set(DEFAULT_ISLANDS) for c in widening)
    assert got <= set(DEFAULT_ISLANDS)
