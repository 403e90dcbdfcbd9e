"""The port's slice as a whole, and its isolation from the reference.

``smoke.run(device="cpu", full=False)`` drives the main path end to end
through the plain versions, ``smoke.serve(device="cpu", full=False)``
the serve path (the two-tenant trace through the pump thread and the
``paged=False`` serve included; ``smoke.serve_tenants`` also alone), ``smoke.serve_ssm(device="cpu", full=False)`` the SSM
serve path, ``smoke.serve_mla(device="cpu", full=False)`` the MLA +
MoE serve path, and ``serve_music``, ``serve_vlm``, ``serve_hybrid`` and
``serve_moe`` the audio (musicgen), VLM (qwen2-vl), hybrid (jamba) and
GQA + MoE (moonshot) families, and ``smoke.train(device="cpu",
full=False)`` the training path (the card runs all nine at ``full=True``,
in ``chip_smoke.py``).  A fresh interpreter imports every
``repro_torch`` module, ``chip_smoke.py`` and the five
``examples/torch_*.py`` and must not have loaded ``jax`` or the
``repro`` package.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")

from repro_torch import smoke
from repro_torch.core.results import ResultStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoke_run_on_cpu_end_to_end(capsys, tmp_path):
    res = smoke.run(device="cpu", full=False, out_dir=tmp_path)
    lines = capsys.readouterr().out.splitlines()
    assert res.device == "cpu"
    assert set(res.front_sizes) == {f"{p}/{w}" for p, w in smoke.SCENARIOS}
    assert all(n > 0 for n in res.front_sizes.values())
    assert all(0 < c <= 1 for c in res.coverage.values())
    assert set(res.designs) == {"int8", "bf16"}
    names = [g.name for g in res.gemms]
    assert names == ["attn_q", "attn_k", "attn_v", "attn_o", "ffn_gate", "ffn_up",
                     "ffn_down", "lm_head"]
    assert all(g.int_exact and g.fp_p90 < g.fp_bound for g in res.gemms)
    assert res.launches == {"dominance": 0, "dcim_mvm": 0, "fp_prealign": 0}
    assert any(line.startswith("plan:") for line in lines)
    # The compiler's output: one audited design per scenario, from the front.
    assert set(res.codegen) == set(res.front_sizes)
    assert all(c.audit_ok and c.bytes > 0 and c.die_area_mm2 > 0 for c in res.codegen.values())
    assert res.seconds["codegen"] > 0
    store = ResultStore(tmp_path / "results")
    assert store.names() == sorted(
        ["explore_multi"] + [f"codegen_{p}_{w}" for p, w in smoke.SCENARIOS])
    assert store.get("explore_multi")["_record"]["kind"] == "dse"
    assert store.get("explore_multi")["n_points"] == sum(res.front_sizes.values())
    for p, w in smoke.SCENARIOS:
        c = res.codegen[f"{p}/{w}"]
        rep = json.loads((tmp_path / f"{p}_{w}" / "report.json").read_text())
        assert rep["audit"]["ok"] and rep["audit"]["census_match"]
        assert [rep["design"][f] for f in "NHLk"] == [c.N, c.H, c.L, c.k]
        assert (tmp_path / f"{p}_{w}" / "rtl" / "dcim_macro.v").exists()
        assert (tmp_path / f"{p}_{w}" / "floorplan.def").exists()
        assert store.get(f"codegen_{p}_{w}")["_record"]["kind"] == "codegen"
    assert sum(line.startswith("codegen ") for line in lines) == len(smoke.SCENARIOS)


def test_smoke_serve_on_cpu_end_to_end(capsys):
    res = smoke.serve(device="cpu", full=False)
    out = capsys.readouterr().out
    assert res.device == "cpu"
    fl, dc = res.float_serve, res.dcim_serve
    sizes = smoke.SERVE_SMOKE
    assert len(fl.results) == len(sizes.arrivals) and len(dc.results) == 2
    assert all(r.generated.size == sizes.n_tokens for r in fl.results)
    assert all(r.generated.size == sizes.dcim_tokens for r in dc.results)
    assert sum(r.prefix_hit_tokens for r in fl.results) > 0
    assert fl.stats.prefill_batches < fl.stats.prefills          # bursts batched
    assert fl.worst_gap <= fl.delta and dc.worst_gap <= dc.delta
    assert all(n == 0 for n in fl.launches.values())             # CPU: plain versions
    assert "serve float vs Engine" in out and "serve dcim vs Engine" in out


def test_smoke_serve_tenants_on_cpu(capsys):
    """The two-tenant rehearsal at the smoke sizes: chunks of 3 over pages
    of 8, a preemption and a shed, all forced by the trace."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get_smoke_config(smoke.ARCH), cache_dtype="float32")
    params = lm.init(cfg, torch.Generator().manual_seed(smoke.SEED), "cpu")
    tn, up = smoke.serve_tenants(cfg, params, full=False, wait_s=120)
    out = capsys.readouterr().out
    tz = smoke.TENANTS_SMOKE
    assert (tz.prefill_chunk, tz.page_size) == (3, 8)
    st = tn.serve.stats
    assert st.preemptions >= 1 and st.prefill_chunks >= 4 and st.shed == 1
    assert {3, 6, 9} <= set(tn.prefill_ctx)
    victims = [r for r in tn.serve.results if r.preemptions]
    assert victims and all(r.admitted_step == 0 and r.tenant == "batch" for r in victims)
    assert tn.callback_threads == ["serve-session-pump"]
    assert tn.callbacks == st.generated_tokens == sum(tn.streamed.values())
    assert "queue overloaded: 7 queued + 1 incoming" in tn.shed_error
    assert tn.counts["decode"] == 1 and tn.counts["total"] == 1 + len(tn.counts["prefill"])
    assert tn.serve.worst_gap <= tn.serve.delta and up.worst_gap <= up.delta
    assert up.stats.paging is None and up.stats.generated_tokens == 2 * tz.batch_tokens
    assert all(n == 0 for n in tn.serve.launches.values())      # CPU: plain versions
    assert "serve tenants vs Engine" in out and "serve paged=False vs Engine" in out


def test_smoke_serve_ssm_on_cpu_end_to_end(capsys):
    res = smoke.serve_ssm(device="cpu", full=False)
    out = capsys.readouterr().out
    fl, dc = res.float_serve, res.dcim_serve
    sizes = smoke.SERVE_SMOKE
    assert res.device == "cpu"
    assert len(fl.results) == len(sizes.arrivals) and len(dc.results) == 2
    assert all(r.generated.size == sizes.n_tokens for r in fl.results)
    assert not fl.stats.prefix_reuse_active
    assert sum(r.prefix_hit_tokens for r in fl.results) == 0   # the SSM gate
    assert fl.stats.prefill_batches < fl.stats.prefills          # bursts batched
    assert fl.worst_gap <= fl.delta and dc.worst_gap <= dc.delta
    assert all(n == 0 for n in fl.launches.values())             # CPU: plain versions
    assert "serve ssm float vs Engine" in out and "serve ssm dcim vs Engine" in out


def test_smoke_serve_mla_on_cpu_end_to_end(capsys):
    res = smoke.serve_mla(device="cpu", full=False)
    out = capsys.readouterr().out
    fl, dc = res.float_serve, res.dcim_serve
    sizes = smoke.SERVE_SMOKE
    assert res.device == "cpu"
    assert len(fl.results) == len(sizes.arrivals) and len(dc.results) == 2
    assert all(r.generated.size == sizes.n_tokens for r in fl.results)
    assert fl.stats.prefix_reuse_active
    assert sum(r.prefix_hit_tokens for r in fl.results) > 0     # compressed pages reused
    assert fl.stats.prefill_batches < fl.stats.prefills          # bursts batched
    assert fl.worst_gap <= fl.delta and dc.worst_gap <= dc.delta
    assert all(n == 0 for n in fl.launches.values())             # CPU: plain versions
    assert "serve mla float vs Engine" in out and "serve mla dcim vs Engine" in out


def test_smoke_serve_music_on_cpu_end_to_end(capsys):
    res = smoke.serve_music(device="cpu", full=False)
    out = capsys.readouterr().out
    fl, dc = res.float_serve, res.dcim_serve
    assert res.device == "cpu" and len(dc.results) == 2
    assert all(r.generated.size == smoke.SERVE_SMOKE.n_tokens for r in fl.results)
    assert fl.stats.prefix_reuse_active
    assert sum(r.prefix_hit_tokens for r in fl.results) > 0     # pages at absolute positions
    assert fl.worst_gap <= fl.delta and dc.worst_gap <= dc.delta
    assert all(n == 0 for n in fl.launches.values())             # CPU: plain versions
    assert "serve music float vs Engine" in out and "serve music dcim vs Engine" in out


def test_smoke_serve_vlm_on_cpu_end_to_end(capsys):
    res = smoke.serve_vlm(device="cpu", full=False)
    out = capsys.readouterr().out
    sz = smoke.VLM_SMOKE
    fl, dc = res.float_steps, res.dcim_steps
    assert res.device == "cpu" and res.sizes == sz
    for chk in (fl, dc):
        assert len(chk.decode_s) == sz.n_decode and chk.tokens == sz.batch * sz.n_decode
        assert chk.worst_diff <= chk.delta and 0 <= chk.exact_share <= 1
        assert all(n == 0 for n in chk.launches.values())       # CPU: plain versions
    assert "vlm float vs teacher-forced forward" in out
    assert "vlm dcim vs teacher-forced forward" in out and "bf16" in out


def test_vlm_stub_frontend_layout():
    """Text, then the image grid (temporal fixed, height and width running
    from the same base), then text from the largest id + 1."""
    sz = smoke.VLM_FULL
    ids = smoke.vlm_position_ids(sz)
    h, w = sz.grid
    assert ids.shape == (3, sz.prompt + sz.n_decode) == (3, 256)
    img = slice(sz.text0, sz.text0 + h * w)
    assert (ids[0, img] == 16).all()
    assert (ids[1, img].min(), ids[1, img].max()) == (16, 27)
    assert (ids[2, img].min(), ids[2, img].max()) == (16, 31)
    for i in range(3):
        np.testing.assert_array_equal(ids[i, :16], np.arange(16))
        np.testing.assert_array_equal(ids[i, sz.prompt - sz.text1:], 32 + np.arange(48))
    embeds, batch_ids = smoke.vlm_inputs(smoke.VLM_SMOKE, 64)
    assert embeds.shape == (2, smoke.VLM_SMOKE.prompt + smoke.VLM_SMOKE.n_decode, 64)
    assert batch_ids.shape == (3, 2, embeds.shape[1]) and batch_ids.flags.c_contiguous


def test_smoke_serve_hybrid_on_cpu_end_to_end(capsys):
    res = smoke.serve_hybrid(device="cpu", full=False)
    out = capsys.readouterr().out
    fl, own, trace = res.float_serve, res.own_routing, res.routing
    assert res.device == "cpu" and res.dcim_serve is None
    assert fl.delta == smoke.SSM_SERVE_DELTA["float32"] and own.delta is None
    assert all(r.generated.size == smoke.SERVE_SMOKE.n_tokens for r in fl.results)
    assert not fl.stats.prefix_reuse_active
    assert sum(r.prefix_hit_tokens for r in fl.results) == 0   # the SSM gate
    # float32 on the CPU: the Engine routes as the served path did, so the
    # replayed routing changes no expert and both gaps are within delta.
    assert trace.replayed > 0 and trace.missing == 0 and trace.differ == 0
    assert fl.worst_gap <= fl.delta and own.worst_gap <= fl.delta
    assert "serve hybrid float vs Engine" in out and "the Engine took the served top-2" in out
    assert "vs Engine on its own routing" in out and "(not held)" in out


def test_smoke_serve_moe_on_cpu_end_to_end(capsys):
    res = smoke.serve_moe(device="cpu", full=False)
    out = capsys.readouterr().out
    fl = res.float_serve
    assert res.device == "cpu" and res.dcim_serve is None
    assert fl.stats.prefix_reuse_active and sum(r.prefix_hit_tokens for r in fl.results) > 0
    assert fl.worst_gap <= fl.delta
    assert "serve moe float vs Engine" in out


def test_smoke_train_on_cpu_end_to_end(capsys):
    res = smoke.train(device="cpu", full=False)
    out = capsys.readouterr().out
    sz = smoke.TRAIN_SMOKE
    assert res.device == "cpu" and res.sizes == sz
    assert len(res.losses) == len(res.grad_norms) == len(res.step_s) == sz.steps
    assert res.losses[-1] < res.losses[0]
    assert res.peak_bytes == 0 and not any(res.launches.values())
    assert [c.arch for c in res.checks] == list(smoke.TRAIN_CHECK_ARCHS)
    # On the CPU the "device" run is a second CPU run: bit for bit.
    assert all(c.losses == c.cpu_losses and c.worst == 0 for c in res.checks)
    assert set(res.variants) == {"adamw8bit", "adafactor", "adamw+int8"}
    assert len(res.resume_losses) == 3 and res.resume_bitwise and res.resume_worst == 0
    for i in range(1, sz.steps + 1):
        assert f"train step {i}: loss" in out
    assert "train resume (smoke)" in out and "tokens/s" in out


def test_fp_error_bound():
    assert smoke.fp_error_bound(2) == smoke.fp_error_bound(32) == 0.08
    assert smoke.fp_error_bound(1024) == 0.08 * 2


_PROBE = r"""
import glob, importlib, json, pkgutil, runpy, sys
sys.path.insert(0, "src")
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
runpy.run_path("chip_smoke.py", run_name="chip_smoke_probe")
examples = sorted(glob.glob("examples/torch_*.py"))
for path in examples:
    runpy.run_path(path, run_name="example_probe")
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.", "jaxlib.", "repro.")))
print(json.dumps({"modules": mods, "examples": examples, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(rec["modules"]) >= 75
    assert {"repro_torch.codegen.templates", "repro_torch.codegen.verilog",
            "repro_torch.codegen.audit", "repro_torch.codegen.floorplan",
            "repro_torch.codegen.generator", "repro_torch.core.results",
            "repro_torch.kernels.paged_attention", "repro_torch.kernels.selective_scan",
            "repro_torch.models.attention", "repro_torch.models.mamba", "repro_torch.models.moe",
            "repro_torch.models.lm", "repro_torch.serve.engine", "repro_torch.serve.paging",
            "repro_torch.serve.scheduler", "repro_torch.optim.adamw",
            "repro_torch.optim.adafactor", "repro_torch.optim.schedule",
            "repro_torch.optim.grad_compress", "repro_torch.train.train_step",
            "repro_torch.train.checkpoint", "repro_torch.train.trainer",
            "repro_torch.data.pipeline", "repro_torch.tree", "repro_torch.dist",
            "repro_torch.dist.sharding", "repro_torch.dist.collectives",
            "repro_torch.launch.mesh", "repro_torch.analysis", "repro_torch.analysis.findings",
            "repro_torch.analysis.registry", "repro_torch.analysis.scopes",
            "repro_torch.analysis.op_trace", "repro_torch.analysis.dtype_flow",
            "repro_torch.analysis.check_donation", "repro_torch.analysis.check_transfers",
            "repro_torch.analysis.check_recompile", "repro_torch.analysis.check_collectives",
            "repro_torch.analysis.check_kernels", "repro_torch.analysis.check_precision",
            "repro_torch.analysis.lint", "repro_torch.analysis.contracts"} <= set(rec["modules"])
    assert rec["examples"] == [f"examples/torch_{n}.py" for n in (
        "dcim_for_llm", "distributed_dse", "quickstart", "serve_lm", "train_lm")]
    assert rec["bad"] == []
