"""Launch tooling: the roofline's analytic counts and the input specs
against the JAX reference, the reference's roofline cases on the port
with the H100's peaks, and the dry-run's counted cells.

The dry-run counts a step on fake tensors (``FakeTensorMode`` with a
``ShapeEnv``): nothing is allocated, so the full-size qwen2.5-3b train
step that ``chip_smoke.py`` times on the card is counted here too, and
must fall within the bounds ``chip_smoke.py`` states for it.  The
multi-pod cells count one rank of ``{"pod": 2, "data": 16, "model":
16}``: the FSDP train step, held to the one-card count at the rank's
rows and to a hand count of its collectives, and the tp=16 serving
steps.
"""
import dataclasses
import math
import os
import runpy

import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro_torch import configs
from repro_torch.core.results import ResultStore
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.optim import get_optimizer
from repro_torch.train.train_step import state_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("train", "prefill", "decode")


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_param_counts_and_model_flops_equal_the_reference(name):
    for port_cfg, ref_cfg in ((configs.get_config(name), jconfigs.get_config(name)),
                              (configs.get_smoke_config(name), jconfigs.get_smoke_config(name))):
        assert roofline.param_counts(port_cfg) == jroof.param_counts(ref_cfg)
        for kind in KINDS:
            assert (roofline.model_flops(port_cfg, kind, 4096, 256)
                    == jroof.model_flops(ref_cfg, kind, 4096, 256))


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_param_counts_match_init(name):
    """The analytic count matches the port's init (on fake tensors, at
    smoke size) within 6%, the reference's bar (it skips norm scales and
    small biases)."""
    cfg = configs.get_smoke_config(name)
    with FakeTensorMode():
        params = lm.init(cfg, torch.Generator("cpu"), device="cpu")
    n_real = sum(t.numel() for t in torch.utils._pytree.tree_leaves(params))
    assert roofline.param_counts(cfg)["total"] == pytest.approx(n_real, rel=0.06), name


def test_full_size_param_counts_plausible():
    """Full configs land near their nameplate sizes (the reference's ranges)."""
    expect = {
        "deepseek-v3-671b": (600e9, 740e9),
        "qwen2-vl-72b": (60e9, 75e9),       # backbone only (no ViT)
        "falcon-mamba-7b": (6e9, 8e9),
        "qwen2.5-14b": (13e9, 16e9),
        "qwen2.5-3b": (2.5e9, 3.7e9),
        "mistral-nemo-12b": (11e9, 14e9),
        "jamba-v0.1-52b": (45e9, 56e9),
        "moonshot-v1-16b-a3b": (24e9, 30e9),
        "phi4-mini-3.8b": (3.3e9, 4.6e9),
        "musicgen-large": (1.4e9, 2.8e9),
    }
    for name, (lo, hi) in expect.items():
        n = roofline.param_counts(configs.get_config(name))["total"]
        assert lo <= n <= hi, (name, n / 1e9)


def test_active_params_moe():
    pc = roofline.param_counts(configs.get_config("deepseek-v3-671b"))
    assert pc["active"] / pc["total"] < 0.09
    assert 30e9 < pc["active"] < 55e9


def test_model_flops_kinds():
    cfg = configs.get_config("qwen2.5-3b")
    t = roofline.model_flops(cfg, "train", 4096, 256)
    p = roofline.model_flops(cfg, "prefill", 4096, 256)
    d = roofline.model_flops(cfg, "decode", 4096, 256)
    assert t == pytest.approx(3 * p)
    assert d == pytest.approx(p / 4096)


def test_peaks_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    smoke = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"), run_name="chip_smoke_probe")
    for k in ("BF16_OPS_PER_S", "HBM_BYTES_PER_S", "INT8_OPS_PER_S", "F32_OPS_PER_S",
              "TF32_OPS_PER_S", "SFU_EXP_PER_S"):
        assert smoke[k] == getattr(roofline, k), k


def test_analyze_record_roundtrip():
    rec = {
        "arch": "qwen2.5-3b", "shape": "train_4k", "mesh": "pod16x16",
        "status": "ok", "kind": "train", "seq_len": 4096,
        "global_batch": 256, "n_devices": 256,
        "analysis": {
            "dot_flops": 1e14, "elem_flops": 1e11, "transcendentals": 1e9,
            "mem_bytes": 1e12,
            "collectives": {
                k: {"count": 10, "bytes": 1e9}
                for k in ("all-gather", "all-reduce", "reduce-scatter",
                          "all-to-all", "collective-permute")
            },
        },
        "memory": {"argument_size_in_bytes": 2 << 30,
                   "temp_size_in_bytes": 8 << 30},
    }
    row = roofline.analyze_record(rec)
    assert row.status == "ok"
    assert row.compute_s == pytest.approx((1e14 + 1e11) / 989e12)
    assert row.memory_s == pytest.approx(1e12 / 3.35e12)
    assert row.collective_s == pytest.approx(6e9 * 255 / 256 / 450e9)
    assert row.bottleneck in ("compute", "memory", "collective")
    assert 0 < row.roofline_fraction < 1
    assert row.device_bytes == 10 << 30


def test_skipped_record():
    rec = {"arch": "phi4-mini-3.8b", "shape": "long_500k",
           "mesh": "h100x1", "status": "skipped:full-attention-500k"}
    row = roofline.analyze_record(rec)
    assert row.status.startswith("skipped")


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_concrete_batch_equals_the_reference(name):
    cfg, jcfg = configs.get_smoke_config(name), jconfigs.get_smoke_config(name)
    for kind in KINDS:
        got = specs.concrete_batch(cfg, kind, 3, 10, seed=11, device="cpu")
        want = jspecs.concrete_batch(jcfg, kind, 3, 10, seed=11)
        assert sorted(got) == sorted(want), (name, kind)
        fake = specs.batch_struct(cfg, kind, 3, 10)
        for k, w in want.items():
            g = got[k].float().numpy() if got[k].dtype == torch.bfloat16 else got[k].numpy()
            np.testing.assert_array_equal(g, np.asarray(w, np.float32 if w.dtype.name ==
                                                        "bfloat16" else w.dtype))
            ref_struct = jspecs.batch_struct(jcfg, kind, 3, 10)[k]
            assert tuple(fake[k].shape) == tuple(ref_struct.shape) == tuple(g.shape)
            assert fake[k].dtype == got[k].dtype


# Smoke-size cells: one dense, one MoE, one SSM and the M-RoPE arch, each
# kind; each record read by ``analyze_record``.
CELL_ARCHS = ("qwen2.5-3b", "moonshot-v1-16b-a3b", "falcon-mamba-7b", "qwen2-vl-72b")


@pytest.mark.parametrize("name", CELL_ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_smoke_cell_counts(name, kind):
    cfg = configs.get_smoke_config(name)
    B, S = 2, 16
    c = dryrun.count_step(cfg, kind, B, S, "adamw")
    a = c["analysis"]
    # Every block projection runs on every token, 2 FLOPs a parameter (6
    # in training), and the head on every token (prefill: the last one).
    # 0.8 leaves room for the SSM's non-matmul parameters (conv, A, D).
    head = cfg.vocab_size * cfg.d_model
    blocks = roofline.param_counts(cfg)["active"] - head * (
        (0 if cfg.external_embed else 1) + (0 if cfg.tie_embeddings else 1))
    want = {"train": 6 * (blocks + head) * B * S, "prefill": 2 * blocks * B * S + 2 * head * B,
            "decode": 2 * (blocks + head) * B}[kind]
    assert a["dot_flops"] >= 0.8 * want, (name, kind, a["dot_flops"], want)
    assert a["mem_bytes"] > c["memory"]["argument_size_in_bytes"] > 0
    assert a["collectives"] == {} and c["fits"]
    assert c["top_flops"][0][0] in ("aten.mm", "aten.bmm")
    rec = {"arch": name, "shape": f"smoke_{kind}", "mesh": dryrun.MESH, "status": "ok",
           "kind": kind, "seq_len": S, "global_batch": B, "n_devices": 1, **c}
    row = roofline.analyze_record(rec)
    assert row.status == "ok" and row.collective_s == 0.0
    assert row.compute_s == pytest.approx(a["dot_flops"] / 989e12)
    assert row.memory_s == pytest.approx(a["mem_bytes"] / 3.35e12)
    assert row.device_bytes == c["memory"]["argument_size_in_bytes"]


def test_moe_training_dispatch_counts_on_fake_tensors():
    """The capacity dispatch's shapes do not depend on the routing (a
    dropped choice goes to a spare row), so the count is exact and
    remat's recompute, whose saved tensors' shapes ``checkpoint``
    compares, runs on fake tensors too."""
    cfg = dataclasses.replace(configs.get_smoke_config("deepseek-v3-671b"), remat=True)
    c = dryrun.count_step(cfg, "train", 2, 16, "adafactor")
    assert c["analysis"]["data_dependent_ops"] == 0
    assert c["analysis"]["dot_flops"] > 0 and c["analysis"]["mem_bytes"] > 0


def test_cli_records_skipped_cells(tmp_path, capsys):
    out = tmp_path / "dryrun"
    assert dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--mesh", "multi",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "qwen2.5-3b", "--tp", "8", "--out", str(out)]) == 0
    assert "dry-run summary: ok=1 failed=0 skipped=3" in capsys.readouterr().out
    rows = {(r.arch, r.shape, r.mesh): r for r in roofline.load_rows(out, mesh=None)}
    assert rows[("phi4-mini-3.8b", "long_500k", "h100x1")].status == "skipped:full-attention-500k"
    assert rows[("qwen2.5-3b", "train_4k", "tp8")].status == "skipped:tp-decode-only"
    # The tensor-parallel decode cell is counted, one rank of 8, with its
    # all-gathers as the roofline's collective term.
    tp8 = rows[("qwen2.5-3b", "decode_32k", "tp8")]
    assert tp8.status == "ok" and tp8.coll_bytes > 0 and tp8.collective_s > 0
    # The multi-pod decode cell: one rank of 32 data replicas of a tp=16
    # serving group, at its 128 / 32 rows.
    multi = rows[("qwen2.5-3b", "decode_32k", "multi")]
    assert multi.status == "ok" and multi.coll_bytes > 0
    rec = ResultStore(out).get("qwen2.5-3b__decode_32k__multi")
    assert rec["n_devices"] == 512 and rec["mesh_shape"] == make_production_mesh(multi_pod=True)
    assert rec["execution"] == dryrun.MULTI_EXECUTION["decode"] and rec["fits"]


# Smoke-size multi-pod cells: the global batches of the reference's
# shapes at the smoke sequence, one rank of {"pod": 2, "data": 16,
# "model": 16} (32 row blocks).
MULTI = make_production_mesh(multi_pod=True)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "falcon-mamba-7b"])
def test_multi_train_cell_counts_one_fsdp_rank(name):
    """The rank's matmul FLOPs are the one-card step's at its 64 / 32 = 2
    rows, exactly (it computes its rows with whole weights); its
    all-gather and gradient reduction bytes are a hand count from the
    state shardings: every parameter split on the mesh gathered whole
    once (a stacked leaf a layer group at a time), every gradient reduced
    over the data axes once, a reduce-scatter where the leaf is split on
    them, plus the loss's sum and count and the norm's square sum (f32);
    its argument bytes are its blocks and its rows."""
    cfg = configs.get_smoke_config(name)
    assert not cfg.remat            # remat would gather each group twice
    c = dryrun.count_step(cfg, "train", 64, 16, "adamw", mesh=MULTI)
    one = dryrun.count_step(cfg, "train", 2, 16, "adamw")
    assert c["analysis"]["dot_flops"] == one["analysis"]["dot_flops"]
    opt = get_optimizer("adamw", 1e-4)
    shapes = state_shapes(cfg, opt)
    ctx = shd.MeshContext(MULTI)
    sh = dict(shd.tree_paths(shd.state_sharding_tree(shapes, ctx)))
    groups = cfg.n_layers // cfg.scan_period()
    want = {"all-gather": [0, 0.0], "reduce-scatter": [0, 0.0], "all-reduce": [2, 12.0]}
    local = 0
    for p, t in shd.tree_paths(shapes):
        spec = sh[p].spec
        local += math.prod(ctx.local_shape(spec, t.shape)) * t.element_size()
        if not p.startswith("params/"):
            continue
        n = groups if p.startswith("params/blocks/") else 1
        nbytes = t.numel() * t.element_size()
        axes = {a for e in spec for a in ((e,) if isinstance(e, str) else e or ())}
        if axes:
            want["all-gather"][0] += n
            want["all-gather"][1] += nbytes
        kind = "reduce-scatter" if axes & {"pod", "data"} else "all-reduce"
        want[kind][0] += n
        want[kind][1] += nbytes
    got = c["analysis"]["collectives"]
    assert {k: [v["count"], v["bytes"]] for k, v in got.items()} == want
    rows = specs.batch_struct(cfg, "train", 2, 16)
    assert c["memory"]["argument_size_in_bytes"] == local + dryrun.tree_bytes(rows)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_multi_serving_cells_count_one_tp16_rank(kind):
    """Prefill and decode: one rank of a tp=16 serving group at the
    rank's rows; the decode cell is ``--tp 16``'s count at those rows."""
    cfg = configs.get_smoke_config("qwen2.5-3b")
    c = dryrun.count_step(cfg, kind, 128, 16, mesh=MULTI)
    assert c["analysis"]["collectives"]["all-gather"]["count"] > 0
    if kind == "decode":
        one = dryrun.count_step(cfg, kind, 4, 16, tp=16)
        assert c["analysis"]["dot_flops"] == one["analysis"]["dot_flops"]
    else:
        # Only the sharded products shrink: below one card's prefill at
        # those rows, above a sixteenth of it.
        one = dryrun.count_step(cfg, kind, 4, 16)
        assert one["analysis"]["dot_flops"] / 16 < c["analysis"]["dot_flops"]
        assert c["analysis"]["dot_flops"] < one["analysis"]["dot_flops"]


def test_full_size_train_step_count_within_chip_smoke_bounds():
    """qwen2.5-3b at full size, 4 x 1024 tokens, AdamW: the step
    ``chip_smoke.py`` times on the card."""
    lo, hi = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"),
                            run_name="chip_smoke_probe")["TRAIN_FLOPS_BOUNDS"]
    cfg = configs.get_config("qwen2.5-3b")
    c = dryrun.count_step(cfg, "train", 4, 1024, "adamw")
    assert lo <= c["analysis"]["dot_flops"] <= hi
    assert c["fits"]
    # Params bf16 and AdamW's f32 m and v: 2 + 8 bytes a parameter.
    n = roofline.param_counts(cfg)["total"]
    assert c["memory"]["argument_size_in_bytes"] == pytest.approx(10 * n, rel=1e-3)


def test_tp_decode_counts_one_rank():
    """qwen2.5-3b's serving decode at tp=2, one rank on fake tensors: the
    sharded products (q, k, v, gate, up, head, and the attention core
    over the rank's heads) halve; ``wo`` and ``w_down`` stay whole, so
    the rank's matmul FLOPs are (tp=1 count - R) / 2 + R with R their
    FLOPs, exactly.  The step's all-gathers: per layer the heads before
    ``wo`` and the FFN's h before ``w_down``, then the logits."""
    cfg = configs.get_config("qwen2.5-3b")
    B, S = 2, 64
    one = dryrun.count_step(cfg, "decode", B, S)["analysis"]
    two = dryrun.count_step(cfg, "decode", B, S, tp=2)["analysis"]
    R = 2 * B * cfg.n_layers * (cfg.n_heads * cfg.hd * cfg.d_model + cfg.d_ff * cfg.d_model)
    assert two["dot_flops"] == (one["dot_flops"] - R) / 2 + R
    assert one["collectives"] == {}
    ag = two["collectives"]["all-gather"]
    assert ag["count"] == 2 * cfg.n_layers + 1
    el = 2 if cfg.compute_dtype == "bfloat16" else 4
    assert ag["bytes"] == el * B * (cfg.n_layers * (cfg.n_heads * cfg.hd + cfg.d_ff)
                                    + cfg.vocab_size)
