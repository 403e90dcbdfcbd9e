"""The port's main path, end to end, through its normal entry points.

    1. DSE: ``explore_multi`` over ``PAPER_SWEEP`` x W_store in
       {16384, 65536} (16 scenarios), with each scenario's front held to
       the brute-force oracle; then the island model over the same 16
       scenarios (``run_islands_multi``: ``ISLANDS`` islands each, every
       population of every island one batch), no front point of any
       scenario dominated by a point of its oracle front;
    2. provisioning: ``dcimmap.plan("qwen2.5-3b", ...)``;
    3. designs: ``distill`` the front to the best int8 and the best bf16
       point by energy-delay product; then the compiler's output: the
       best-EDP point of each of the 16 scenarios' NSGA-II fronts through
       ``codegen.generate`` (structural Verilog, ``cell_lib.v``, a DEF
       floorplan and ``report.json`` under ``out_dir/<prec>_<w_store>``),
       each required to pass its gate-census audit against the cost
       model; the union front is recorded in
       ``ResultStore(out_dir / "results")`` as ``explore_multi``, each
       design's report as ``codegen_<prec>_<w_store>``;
    4. macro numerics at full width: every GEMM class of
       ``extract(qwen2.5-3b)`` through ``DCIMMacroSim.matmul`` of both
       designs on M = 128 token rows (weights N(0, 0.02), activations
       N(0, 1), from ``SEED`` with numpy).  The int8 path must equal the
       dequantized exact integer product of the quantized codes bitwise;
       the bf16 path's p90 relative error against the float32 product
       must stay under :func:`fp_error_bound` of the design's H.

``serve`` is the second path, the application: an LM served through
the paged ``Scheduler``:

    5. float serve: qwen2.5-3b at full width and depth (bf16, random
       weights drawn on the device from ``SEED``) through
       ``Scheduler.serve`` on a trace of 8 greedy requests that share a
       256-token system prefix, 4 arriving at step 0 and 4 at step 8
       (burst prefill, prefix hits: K5 with and without context; K4 at
       every decode step).  Each served sequence is teacher-forced
       through the ``Engine`` (monolithic cache, plain attention) and
       every served token's Engine logit must lie within
       ``SERVE_DELTA`` of that position's maximum;
    6. DCIM serve: the same model with every dense projection through an
       int8 design (``dcim_sim``, K2), 2 requests, held the same way to
       ``DCIM_DELTA``;
    7. the multi-tenant front end (``serve_tenants``, on the same
       params): a batch tenant (4 of the float trace's requests, priority
       1, 48 tokens each) and an interactive one (3 requests, priority 3,
       arriving at steps 6, 12 and 12; the first a 700-token prompt that
       fills in chunks of 200 tokens, off the 16-row page grid) queued on
       one session with ``max_queue=7``; a producer thread's 8th
       submission sheds; the pump thread serves the trace while a consumer
       thread per tenant streams.  It must preempt a batch request and
       resume it, fill in chunks at context lengths 200, 400 and 600, and
       deliver every ``on_token`` callback on the pump thread; held to the
       ``Engine`` within ``SERVE_DELTA``;
    8. 2 of the batch requests through ``Scheduler(paged=False)`` (the
       monolithic cache and the plain attention: no kernel), held the same
       way.

``serve_ssm`` is the third path, the SSM family through the same
``Scheduler``:

    9. float serve: falcon-mamba-7b at full width and depth (64 Mamba-1
       layers, bf16, random weights drawn on the device from ``SEED``)
       on the same trace.  Every prefill program runs K7 in every layer,
       every decode step ``mamba_step``; prefix reuse is gated off (a
       recurrent state is not held in pages), so no prompt token may be
       a prefix hit.  Held to the ``Engine`` with ``ssm_impl="assoc"``
       (the associative scan, independent of K7) within
       ``SSM_SERVE_DELTA``;
   10. DCIM serve: full width cut to ``SSM_DCIM_LAYERS`` of the 64
       layers, under the int8 design (K2 in every projection, K7 in
       every prefill), 2 requests, held the same way to ``DCIM_DELTA``.

``serve_mla`` is the fourth path, the MLA + MoE family through the same
``Scheduler``:

   11. float serve: deepseek-v3-671b at full width, cut to
       ``MLA_LAYERS`` of its 61 layers (bf16, random weights drawn on the
       device from ``SEED``; the MTP head, which serving ignores, is not
       drawn) on the same trace.  Every prefill program runs K5 at the MLA shape
       (K/V reconstructed through ``kv_b``: hd 192, hdv 128, one query
       head per KV head) with prefix hits, every decode step K6 in every
       layer; every block's drop-free MoE runs all 256 experts on every
       token.  Held to the ``Engine`` (reconstructed-K/V flash prefill,
       absorbed plain decode: neither K5 nor K6) within
       ``MLA_SERVE_DELTA``;
   12. DCIM serve: the same 2-layer model under the int8 design (K2 in
       every dense projection: MLA, router, shared expert, head; the
       expert products stay plain, as in the reference), 2 requests, held
       the same way to ``DCIM_DELTA``.

The last four paths drive the remaining model families, each drawn on
the device from ``SEED`` in bf16 after the previous one is freed:

   13. ``serve_music``: musicgen-large at full width and depth (48
       layers, sinusoidal positions added to the embeddings, LayerNorm,
       gelu; 32 heads over 32 KV heads, so K4 and K5 run one query head
       per KV head at hd 64) through the ``Scheduler`` on the same trace
       at its 2048-token vocabulary: prefix hits (K5 over reused pages at
       absolute positions), K4 every decode step; held to the ``Engine``
       within ``SERVE_DELTA``; then the int8 ``dcim_sim`` serve (K2),
       held to ``DCIM_DELTA``;
   14. ``serve_vlm``: qwen2-vl-72b at full width, cut to ``VLM_LAYERS`` of
       its 80 layers, fed by a stub frontend (``vlm_inputs``: N(0, 1)
       embeddings; text, a 12 x 16 image grid and text, with M-RoPE's
       three position streams apart over the image) through ``lm.prefill``
       and 16 ``lm.decode_step`` s, as the reference drives it (its
       Scheduler serves token models only).  Every step's logits must lie
       within ``SERVE_DELTA`` of a teacher-forced forward over the whole
       sequence; then the same model cut to ``VLM_DCIM_LAYERS`` layers
       under the bf16 design (K3 then K2 in every projection, the head
       included), held the same way to ``DCIM_DELTA``;
   15. ``serve_hybrid``: jamba-v0.1-52b at full width, cut to
       ``JAMBA_LAYERS`` (2 of its 4 periods of 8: 14 Mamba-1 and 2 GQA
       layers, 8 MoE FFNs of 16 experts), on the same trace: K7 in the
       Mamba layers of every prefill, K4 and K5 in the attention layers,
       prefix reuse gated off by the SSM state; held to the ``Engine`` on
       ``ssm_impl="assoc"`` within ``SSM_SERVE_DELTA``, the Engine taking
       the top-2 experts the served path chose (``serve_hybrid`` says
       why), and its gap on its own routing printed;
   16. ``serve_moe``: moonshot-v1-16b-a3b at full width and depth (48
       layers; GQA with one query head per KV head at hd 128, 64 experts
       top-6 through the drop-free MoE), on the same trace with prefix
       hits; held to the ``Engine`` within ``SERVE_DELTA``.

``serve_tp`` runs the island model and serves qwen2.5-3b
tensor-parallel, as ``TP`` ranks, one process a rank over a process
group (gloo, so that the ranks may share one card, time-sliced):

   17. the ranks run step 1's island run as a (scenario, island) =
       (1, ``TP``) mesh (``run_islands_multi(mesh=)``), every rank's
       results bitwise the one-process run's; then each rank draws the
       full params on its device from ``SEED``
       (``_draw_params``) and builds ``Scheduler(tp=TP)``, which keeps the
       rank's shards (the q/k/v heads, the FFN's d_ff and the head's
       vocabulary at 1/TP; at TP = 2 8 q heads over 1 kv head a rank);
       rank 0 keeps the full params for the Engine, the others free them.
       Every rank serves step 5's trace, then step 6's 2 requests under
       the int8 design (K2 at N = d_ff / TP and vocab / TP).  The ranks'
       tokens must be equal; rank 0 holds every served token to the tp=1
       ``Engine``'s teacher-forced logits within ``SERVE_DELTA`` /
       ``DCIM_DELTA``, as step 5 holds the tp=1 serve.  Then step 7's
       two-tenant trace through the pumps (``ServeSession`` under a
       model axis of ``TP``): rank 0 is the front end
       (``drive_tenants``), the others follow its tick messages; every
       rank's tokens and schedule equal, the schedule equal to the tp=1
       trace's.  A rank's failure fails the call.

``train`` is the last path, training, which runs no hand-written kernel
(as the reference's training reaches no Pallas kernel):

   18. qwen2.5-3b at full width and depth (36 layers, bf16 params and
       compute, remat, the loss in chunks of 512 positions) trained by
       the ``Trainer`` for ``TRAIN_FULL.steps`` AdamW steps of 4 x 1024
       tokens on a learnable stream (next token = token + 1 mod V, each
       row at its own offset), lr ``cosine_warmup(3e-4, 2, 8)``, clipped
       at norm 1: every loss and gradient norm finite and the last loss
       below the first;
   19. qwen2.5-3b, deepseek-v3 (MLA, capacity MoE, aux loss, MTP) and
       falcon-mamba (the associative scan) at their smoke configs in
       float32: two AdamW steps on the device and on the CPU from one
       state drawn on the CPU, losses within ``TRAIN_LOSS_RTOL``, every
       parameter within ``TRAIN_PARAM_TOL`` of its leaf's largest
       magnitude plus ``TRAIN_STEP_LR_TOL`` lr a step; then one step each
       of 8-bit AdamW, Adafactor and int8 gradient compression, finite;
   20. a crash and resume at qwen2.5-3b smoke: a ``Trainer`` checkpoints
       at step 3 into a temporary directory, a fresh one resumes there
       and runs to step 6, held to one uninterrupted 6-step run by the
       same bounds.

``train_fsdp`` trains it sharded (FSDP, ``dist.fsdp``), ``FSDP_MESH``'s
two ranks, one process a rank over a gloo group:

   21. each rank draws step 18's full params from ``SEED``, keeps its
       blocks of every parameter and AdamW leaf and frees the rest, then
       runs ``FSDP_STEPS`` steps of step 18's stream and schedule on the
       global batch (its rows: half).  Both ranks' metrics equal; the
       losses within ``FSDP_FIRST_RTOL`` (step 1) and ``FSDP_LATER_RTOL``
       of step 18's; a rank's collectives a step equal to the dry-run's
       count of a rank at those rows; on the card each rank's peak under
       ``FSDP_PEAK_BYTES``.  Then, on the same ranks, qwen2.5-3b and
       deepseek-v3 smoke steps against the CPU's unsharded steps (step
       19's bars); a checkpoint written at ``FSDP_MESH``, restored with
       ``shardings=`` at ``FSDP_CKPT_MESH`` and continued, held to the
       uninterrupted run; ``mean_grads_int8`` of the ranks' f32 vectors
       against the exact mean (``RING_MEDIAN_REL``) and the host
       emulation (``ring_emulation``).  No hand kernel launches.

``serve_moved`` serves params that were put on the card by hand:

   22. qwen2.5-3b at full width and depth drawn by ``lm.init`` on the
       CPU and moved to the card with ``.to``, in a process where nothing
       resolved the card before: cuBLAS's reduced-precision reduction
       flags still on (torch's default) until ``Scheduler(...)`` resolves
       the params' device, off after it; then 2 greedy requests of step
       5's trace served (K4, K5) and held to the ``Engine`` within
       ``SERVE_DELTA``.

``full=False`` runs the same steps at the smoke sizes (a short NSGA-II,
the reduced qwen2.5-3b config, 8 rows, short traces, chunks of 3 tokens
over pages of 8) — the CPU
rehearsal the tests run.  ``chip_smoke.py`` runs ``full=True`` on the
card.  Every check raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import tempfile
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import codegen, configs
from .core import precision
from .core.explorer import (ParetoPoint, brute_force_front, distill, explore_multi,
                            run_islands_multi)
from .core.nsga2 import NSGA2Config, NSGA2Result
from .core.results import ResultStore
from .core.scenario import evaluate_host
from .core.space import DesignSpace
from .dcimmap import extract, plan
from .kernels import cuda_lib, ref
from .device import resolve
from .data import SyntheticLM
from .dist import sharding as shd
from .models import lm, moe
from .models.common import norm_apply
from .optim import cosine_warmup, get_optimizer
from .launch import dryrun
from .launch.mesh import make_local_mesh
from .optim.grad_compress import dequantize, mean_grads_int8, quantize
from .train import Trainer, TrainerConfig, build, checkpoint, make_train_step
from .train.train_step import init_state, shard_state, state_shapes, train_context
from .tree import flatten, paths, unflatten
from .serve import Engine, Request, RequestResult, Scheduler, ServeStats
from .sim.functional import DCIMMacroSim, dcim_numerics, quantize_sym

ARCH = "qwen2.5-3b"
W_STORES = (16384, 65536)
SCENARIOS = [(p.name, w) for p in precision.PAPER_SWEEP for w in W_STORES]
MIN_COVERAGE = 0.9     # the reference's own bar (test_front_coverage_vs_oracle)
SEED = 0
RUN_KERNELS = ("dominance", "dcim_mvm", "fp_prealign")     # the kernels ``run`` drives
# The island run of ``run``: 4 islands a scenario, 4 rounds of 16
# generations (the default run's 64), the 8 best migrating each round.
ISLANDS = dict(n_islands=4, rounds=4, gens_per_round=16, n_migrants=8)
ISLANDS_SMOKE = dict(n_islands=4, rounds=2, gens_per_round=4, n_migrants=4)


def dse_config(full: bool) -> NSGA2Config:
    """The NSGA-II config of the DSE and the island run."""
    return NSGA2Config() if full else NSGA2Config(pop_size=32, generations=8)


def fp_error_bound(H: int) -> float:
    """p90 bound on |y - x@w| / max(|x@w|, 1) for the bf16 (B_M = 8)
    design: 0.08 up to H = 32 (the reference's test_accuracy_vs_f32 bar
    at B_M = 8, H = 32), growing with log2 H beyond, since a larger group
    shifts its small members further below the group maximum."""
    return 0.08 * max(1.0, math.log2(H) / 5.0)


@dataclasses.dataclass
class GemmCheck:
    name: str
    K: int
    N: int
    int_exact: bool
    fp_p90: float
    fp_bound: float
    seconds: float


@dataclasses.dataclass
class CodegenCheck:
    """One generated design: its shape, its audit and its output's size."""

    N: int
    H: int
    L: int
    k: int
    audit_ok: bool
    area_rel_err: float
    die_area_mm2: float
    bytes: int             # all files under the design's directory
    seconds: float


@dataclasses.dataclass
class SmokeResult:
    device: str
    front_sizes: Dict[str, int]
    coverage: Dict[str, float]
    plan_summary: str
    designs: Dict[str, ParetoPoint]
    codegen: Dict[str, CodegenCheck]    # per scenario "prec/w_store"
    island_front_sizes: Dict[str, int]
    island_coverage: Dict[str, float]
    island_launches: int                # K1 launches of the island run alone
    islands: List[NSGA2Result]          # the island run's results, per scenario
    gemms: List[GemmCheck]
    seconds: Dict[str, float]
    peak_bytes: int
    launches: Dict[str, int]   # kernel launches during this run (0 on the CPU)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _p90(rel: torch.Tensor) -> float:
    flat = rel.flatten()
    return float(torch.kthvalue(flat, max(1, math.ceil(0.9 * flat.numel()))).values)


def check_gemm(name, x, w, sim_int, sim_fp) -> GemmCheck:
    """One GEMM class through both designs, with its checks."""
    t0 = time.perf_counter()
    p = sim_int.precision
    y_int = sim_int.matmul(x, w)
    qx, sx = quantize_sym(x, p.B_x)
    qw, sw = quantize_sym(w, p.B_w)
    # Every partial sum of the codes is an integer below 2^53: exact in f64.
    exact = torch.matmul(qx.to(torch.float64), qw.to(torch.float64)).to(torch.int32)
    int_exact = torch.equal(y_int, exact.to(torch.float32) * (sx * sw))

    y_fp = sim_fp.matmul(x, w)
    want = ref.fp_matmul_f32_ref(x, w)
    rel = torch.abs(y_fp - want) / torch.clamp_min(torch.abs(want), 1.0)
    H = math.gcd(sim_fp.H, x.shape[-1])
    chk = GemmCheck(name, x.shape[1], w.shape[1], bool(int_exact), _p90(rel),
                    fp_error_bound(H), 0.0)
    _sync(x.device)
    chk.seconds = time.perf_counter() - t0
    if not chk.int_exact:
        raise AssertionError(f"{name}: int8 path differs from the exact integer product")
    if not chk.fp_p90 < chk.fp_bound:
        raise AssertionError(
            f"{name}: bf16 p90 rel err {chk.fp_p90:.4g} >= bound {chk.fp_bound:.4g} (H={H})"
        )
    return chk


def generate_design(p: ParetoPoint, out: pathlib.Path, store: ResultStore) -> CodegenCheck:
    """The compiler's output for one point, audited and recorded."""
    t0 = time.perf_counter()
    rep = codegen.generate(p, out)
    seconds = time.perf_counter() - t0
    audit = rep["audit"]
    if not (audit["ok"] and audit["census_match"]):
        raise AssertionError(f"codegen {p.precision}/{p.w_store}: audit failed {audit}")
    store.put(f"codegen_{p.precision}_{p.w_store}", rep, kind="codegen", wall_s=seconds)
    return CodegenCheck(
        N=p.N, H=p.H, L=p.L, k=p.k, audit_ok=audit["ok"],
        area_rel_err=audit["area_rel_err"],
        die_area_mm2=rep["floorplan"]["die_area_mm2"],
        bytes=sum(f.stat().st_size for f in out.rglob("*") if f.is_file()),
        seconds=seconds,
    )


def run(device="cuda", full: bool = True, out_dir=None) -> SmokeResult:
    """The compile path; codegen writes under ``out_dir`` (a temporary
    directory, removed on return, when it is None)."""
    dev = resolve(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    # The float32 yardstick of the bf16 path must be a full-precision product.
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with (tempfile.TemporaryDirectory() if out_dir is None
              else contextlib.nullcontext(out_dir)) as out:
            return _run(dev, full, pathlib.Path(out))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _run(dev, full, out_dir: pathlib.Path) -> SmokeResult:
    seconds: Dict[str, float] = {}
    launches0 = dict(cuda_lib.launches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # 1. DSE over 16 scenarios, fronts held to the brute-force oracle.
    cfg = dse_config(full)
    store = ResultStore(out_dir / "results")
    t0 = time.perf_counter()
    pts = explore_multi(SCENARIOS, cfg, device=dev, store=store, record_name="explore_multi")
    seconds["explore_multi"] = time.perf_counter() - t0
    dse_launches = cuda_lib.launches["dominance"] - launches0["dominance"]
    by_scen = Counter((p.precision, p.w_store) for p in pts)
    front_sizes, coverage, oracles = {}, {}, {}
    t0 = time.perf_counter()
    for prec, w in SCENARIOS:
        key = f"{prec}/{w}"
        oracle = oracles[key] = brute_force_front(DesignSpace(precision.get(prec), w), dev)
        want = {tuple(g) for g in oracle}
        got = {tuple(p.genes) for p in pts if (p.precision, p.w_store) == (prec, w)}
        front_sizes[key] = by_scen[(prec, w)]
        coverage[key] = len(got & want) / len(want)
        if full and coverage[key] < MIN_COVERAGE:
            raise AssertionError(f"{key}: NSGA-II covers {coverage[key]:.2f} of the oracle front")
    seconds["oracle"] = time.perf_counter() - t0
    print(f"explore_multi: {len(pts)} points over {len(SCENARIOS)} scenarios in "
          f"{seconds['explore_multi']:.2f} s (pop {cfg.pop_size}, {cfg.generations} generations, "
          f"{dse_launches} dominance launches)")
    print("front sizes: " + " ".join(f"{k}={v}" for k, v in front_sizes.items()))
    print("oracle coverage: " + " ".join(f"{k}={v:.3f}" for k, v in coverage.items()))
    isl_sizes, isl_cov, isl_launches, isl = _islands(dev, cfg, ISLANDS if full else ISLANDS_SMOKE,
                                                     oracles, seconds, full)
    for k in isl_sizes:
        print(f"islands {k:<11} front {isl_sizes[k]:>4} (explore_multi {front_sizes[k]:>4}), "
              f"oracle coverage {isl_cov[k]:.3f} (explore_multi {coverage[k]:.3f})")

    # 2. Provisioning.
    t0 = time.perf_counter()
    mp = plan(ARCH, precision=["int8", "bf16"], w_store=list(W_STORES),
              cfg_nsga=None if full else cfg, device=dev)
    seconds["plan"] = time.perf_counter() - t0
    print(f"plan: {mp.summary()}")
    print(f"plan: chosen macro {mp.point.summary()}")

    # 3. Designs.
    designs = {
        prec: distill([p for p in pts if p.precision == prec], sort_by="edp")[0]
        for prec in ("int8", "bf16")
    }
    sims = {prec: DCIMMacroSim.from_point(p) for prec, p in designs.items()}
    for prec, p in designs.items():
        print(f"design {prec}: {p.summary()}")

    # The compiler's output: each scenario's best-EDP point of the front.
    gen: Dict[str, CodegenCheck] = {}
    for prec, w in SCENARIOS:
        key = f"{prec}/{w}"
        p = distill([q for q in pts if (q.precision, q.w_store) == (prec, w)], sort_by="edp")[0]
        c = gen[key] = generate_design(p, out_dir / f"{prec}_{w}", store)
        print(f"codegen {key:<11} N={c.N:<4} H={c.H:<5} L={c.L:<3} k={c.k:<2} audit ok "
              f"(area rel err {c.area_rel_err:.3g}) die {c.die_area_mm2:.4f} mm^2, "
              f"{c.bytes} bytes [{c.seconds:.3f} s]")
    seconds["codegen"] = sum(c.seconds for c in gen.values())
    print(f"codegen: {len(gen)} designs, {sum(c.bytes for c in gen.values())} bytes in "
          f"{seconds['codegen']:.3f} s (host) under {out_dir}")

    # 4. Macro numerics at full width.
    lmcfg = configs.get_config(ARCH) if full else configs.get_smoke_config(ARCH)
    M = 128 if full else 8
    rng = np.random.default_rng(SEED)
    gemms: List[GemmCheck] = []
    seconds["weights"] = 0.0
    for g in extract(lmcfg).gemms:
        t0 = time.perf_counter()
        x = torch.from_numpy(rng.standard_normal((M, g.K), dtype=np.float32)).to(dev)
        w = rng.standard_normal((g.K, g.N), dtype=np.float32)
        w *= np.float32(0.02)
        w = torch.from_numpy(w).to(dev)
        seconds["weights"] += time.perf_counter() - t0
        chk = check_gemm(g.name, x, w, sims["int8"], sims["bf16"])
        gemms.append(chk)
        print(f"gemm {g.name:<9} {M}x{g.K}x{g.N}: int8 exact={chk.int_exact} "
              f"bf16 p90 rel err {chk.fp_p90:.4g} < {chk.fp_bound:.4g} "
              f"(H={math.gcd(sims['bf16'].H, g.K)}) [{chk.seconds:.2f} s]")
        del x, w
    seconds["numerics"] = sum(c.seconds for c in gemms)
    print("host seconds: " + " ".join(f"{k} {v:.2f}" for k, v in seconds.items()))

    launches = {k: cuda_lib.launches[k] - launches0[k] for k in RUN_KERNELS}
    peak = 0
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"peak device memory: {peak / 2**30:.2f} GiB")
        print("kernel launches: " + " ".join(f"{k}={n}" for k, n in launches.items()))
        idle = [k for k, n in launches.items() if n == 0]
        if idle:
            raise AssertionError(f"the main path never launched {idle}")
    return SmokeResult(
        device=str(dev), front_sizes=front_sizes, coverage=coverage,
        plan_summary=mp.summary(), designs=designs, codegen=gen,
        island_front_sizes=isl_sizes, island_coverage=isl_cov, island_launches=isl_launches,
        islands=isl,
        gemms=gemms, seconds=seconds, peak_bytes=int(peak), launches=launches,
    )


def _islands(dev, cfg: NSGA2Config, kw: dict, oracles: Dict[str, np.ndarray],
             seconds: Dict[str, float], full: bool):
    """The island run over ``SCENARIOS`` at ``cfg``'s population; at
    ``full`` budget each scenario's front must hold no point dominated by
    a point of its oracle front (the reference's bar; a smoke budget's
    front is not yet optimal).  Returns (front sizes, oracle coverage, K1
    launches, the results)."""
    n0 = cuda_lib.launches["dominance"]
    t0 = time.perf_counter()
    results = run_islands_multi(SCENARIOS, cfg, device=dev, **kw)
    seconds["islands"] = time.perf_counter() - t0
    n_launch = cuda_lib.launches["dominance"] - n0
    sizes, cov = {}, {}
    for (prec, w), res in zip(SCENARIOS, results):
        key = f"{prec}/{w}"
        oF, _ = evaluate_host(DesignSpace(precision.get(prec), w).to_table(dev), oracles[key])
        for fo in res.front_objectives if full else ():
            if np.any(np.all(oF <= fo, axis=1) & np.any(oF < fo, axis=1)):
                raise AssertionError(f"islands {key}: front point {fo} is dominated by the "
                                     f"oracle front")
        sizes[key] = res.front_genes.shape[0]
        want = {tuple(g) for g in oracles[key]}
        cov[key] = len({tuple(g) for g in res.front_genes} & want) / len(want)
    print(f"run_islands_multi: {sum(sizes.values())} points over {len(SCENARIOS)} scenarios x "
          f"{kw['n_islands']} islands in {seconds['islands']:.2f} s (pop {cfg.pop_size}, "
          f"{kw['rounds']} rounds x {kw['gens_per_round']} generations, {kw['n_migrants']} "
          f"migrants, {n_launch} dominance launches)"
          + ("; no front point dominated by the oracle" if full else ""))
    return sizes, cov, n_launch, results


# --- the serve path ---------------------------------------------------------------
# delta: how far below the Engine's maximum logit at a position the
# served token's Engine logit may lie.  The served logits come from K4/K5
# through a paged pool and the Scheduler's batch shapes, the Engine's
# from the plain attention over a monolithic cache.
#  * float32 (the CPU rehearsal): the same arithmetic in another
#    summation order, ~1e-6 apart; 1e-4 admits only a near-tie.
#  * bfloat16: both round activations, K/V and logits to bf16, and a
#    different summation order flips single roundings (2^-8 relative),
#    which 36 layers compound to ~1-2% of the hidden state: ~0.05-0.1 of
#    a top logit of ~4.5 (logits are ~N(0, 1) under the head's 1/sqrt(d)
#    init).  0.25 is 8 bf16 ulps there; a serving fault (a wrong page, a
#    wrong position) picks tokens whose logits sit near 0, far outside.
#  The same delta holds the later families, for these reasons:
#  * musicgen-large: 48 layers where qwen's 36 gave a worst gap of 0.094
#    (PERF.md): sqrt(48 / 36) times that is ~0.11.  The head (1/sqrt(d)
#    init over a LayerNorm'd h) gives a top logit of ~3.5 over 2048
#    tokens, where a bf16 ulp is 2^-6: 0.25 is 16 ulps.  A serving fault
#    (a sinusoidal offset lost at a paged entry, a wrong page) feeds the
#    model other positions, and picks tokens whose Engine logits sit
#    near 0.
#  * qwen2-vl-72b, on every logit of every step (not only the argmax's):
#    the prefill and the decode steps against a teacher-forced forward
#    over the same embeddings and position ids differ in attention (the
#    flash forward over the whole sequence against the prompt's and then
#    the plain decode over the cache) and in the projections' batch
#    shapes.  A relative drift of the hidden state of ~1% over 24 layers
#    moves each logit (~N(0, 1)) by ~N(0, 0.01), the largest of
#    4 x 17 x 152064 such moves by ~0.05; 0.25 admits a drift of ~5%.  A
#    fault in the M-RoPE streams or the positions changes which keys
#    each query attends to and moves logits by O(1).
#  * moonshot-v1-16b-a3b: as MLA_SERVE_DELTA's below, for the same reason
#    (a token whose k-th and (k+1)-th router probabilities lie closer than
#    the two paths' difference takes another expert, here one of 6 among
#    64, carrying ~1/6 of the routed mass), over 48 layers of bf16
#    roundings.
SERVE_DELTA = {"float32": 1e-4, "bfloat16": 0.25}
#  * under the int8 macro a flipped upstream rounding can also move an
#    activation by one int8 code (1/127 of the tensor's amax): twice the
#    float bound.
DCIM_DELTA = {"float32": 1e-3, "bfloat16": 0.5}
# The SSM serve's delta.  The served logits come from K7 over a padded
# burst and ``mamba_step``, the Engine's from the associative scan over
# each prompt alone and the same ``mamba_step``.
#  * float32 (the CPU rehearsal): the two scans differ in summation order
#    only (~1e-6 apart, see tests/test_torch_mamba.py); 1e-4 admits only
#    a near-tie.
#  * bfloat16: the scans themselves run in float32 and agree to ~1e-6
#    relative, far below a bf16 ulp.  What moves the logits is the same
#    as for qwen2.5-3b: the projections run at other batch shapes (a
#    4 x 512 burst against one prompt alone, 4 slots against 8 rows),
#    so their float32 sums round to bf16 differently in a few elements,
#    and 64 residual layers compound it.  qwen2.5-3b's 36 layers gave a
#    worst gap of 0.094 (PERF.md); sqrt(64 / 36) = 1.33 times that is
#    ~0.125, at a top logit of ~4.3 (the head's 1/sqrt(d) init over 65024
#    tokens), where a bf16 ulp is 2^-5.  0.25 is 8 ulps there, as for
#    qwen; a serving fault (a wrong state row, a state not carried)
#    picks tokens whose logits sit near 0.
#  It holds jamba's 16 layers too, with the Engine on the experts the
#  served path chose (``serve_hybrid`` says why).
SSM_SERVE_DELTA = {"float32": 1e-4, "bfloat16": 0.25}
SSM_ARCH = "falcon-mamba-7b"
SSM_DCIM_LAYERS = 8      # of 64: the DCIM serve's depth cut (full width kept)
# The MLA + MoE serve's delta.  The served logits come from K5 over
# K/V reconstructed from the pages and from K6 (absorbed, float32 scores
# against the bf16 c_kv pages), the Engine's from the flash prefill over
# the same reconstruction and the plain absorbed decode: the same
# arithmetic in other orders and at other batch shapes, as for qwen.
#  * float32 (the CPU rehearsal): ~1e-6 apart; 1e-4 admits only a
#    near-tie.
#  * bfloat16: only 2 layers compound the bf16 roundings (qwen's 36 gave
#    0.094), but each MoE routes a token to 8 of 256 experts by float32
#    router probabilities, and where the 8th and 9th lie closer than the
#    paths' difference (a few in a hundred tokens, with 256 experts) the
#    two paths pick different experts.  A swapped expert carries ~1/10
#    of the routed gate mass, so it moves that token's hidden state by a
#    few percent and its logits (std ~1 under the head's 1/sqrt(d) init)
#    by ~0.04: a top-1 that flips differs by up to ~0.15.  0.25 is 8 bf16
#    ulps at the top logit (~4.5 over 129280 tokens), as for qwen; a
#    serving fault (a wrong page, a wrong rope position, a wrong
#    absorbed weight) picks tokens whose logits sit near 0.
MLA_SERVE_DELTA = {"float32": 1e-4, "bfloat16": 0.25}
MLA_ARCH = "deepseek-v3-671b"
MLA_LAYERS = 2           # of 61: two layers' 24.9 B params (49.7 GB bf16) fit one H100
MUSIC_ARCH = "musicgen-large"
VLM_ARCH = "qwen2-vl-72b"
VLM_LAYERS = 24          # of 80: 22.3 B params (44.6 GB bf16) with room for the check
VLM_DCIM_LAYERS = 4      # of those 24: the bf16 design's depth cut
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_LAYERS = 16        # of 32: 2 of its 4 periods of 8, ~26.0 B params (~52 GB bf16)
MOE_ARCH = "moonshot-v1-16b-a3b"


@dataclasses.dataclass(frozen=True)
class ServeSizes:
    max_slots: int
    max_len: int
    page_size: int
    prefix: int                   # shared system-prompt tokens
    tail: Tuple[int, int]         # unique tail length range (inclusive)
    n_tokens: int
    arrivals: Tuple[int, ...]     # one per request
    dcim_prompt: int              # DCIM serve: 2 requests of this prompt length
    dcim_tokens: int


SERVE_FULL = ServeSizes(4, 1024, 16, 256, (32, 192), 32, (0,) * 4 + (8,) * 4, 32, 8)
SERVE_SMOKE = ServeSizes(4, 64, 8, 16, (2, 12), 4, (0,) * 4 + (2,) * 4, 8, 3)
# The SSM and MLA serves: the same trace; their DCIM serves generate 4 tokens.
SSM_SERVE_FULL = dataclasses.replace(SERVE_FULL, dcim_tokens=4)
MLA_SERVE_FULL = SSM_SERVE_FULL


@dataclasses.dataclass(frozen=True)
class TenantSizes:
    """The two-tenant trace (``serve_tenants``): the first ``n_batch``
    requests of ``serve_trace`` at priority 1, and interactive requests at
    priority 3, the first with a long prompt that fills in chunks."""
    max_slots: int
    max_len: int
    page_size: int
    prefill_chunk: int            # not a multiple of page_size
    max_queue: int
    n_batch: int
    batch_tokens: int
    inter_prompts: Tuple[int, ...]
    inter_arrivals: Tuple[int, ...]
    inter_tokens: int


@dataclasses.dataclass(frozen=True)
class VlmSizes:
    """The VLM drive: ``batch`` rows laid out text, image grid, text, then
    ``n_decode`` positions fed one decode step at a time."""
    batch: int
    text0: int
    grid: Tuple[int, int]         # (height, width) of the image's patch grid
    text1: int
    n_decode: int

    @property
    def prompt(self) -> int:
        return self.text0 + self.grid[0] * self.grid[1] + self.text1


VLM_FULL = VlmSizes(4, 16, (12, 16), 32, 16)
VLM_SMOKE = VlmSizes(2, 3, (2, 3), 4, 3)


TENANTS_FULL = TenantSizes(4, 1024, 16, 200, 7, 4, 48, (700, 64, 64), (6, 12, 12), 16)
TENANTS_SMOKE = TenantSizes(4, 64, 8, 3, 7, 4, 8, (11, 4, 4), (2, 5, 5), 4)


@dataclasses.dataclass
class ServeCheck:
    name: str
    results: List[RequestResult]
    stats: ServeStats
    seconds: float                # host clock around Scheduler.serve
    launches: Dict[str, int]      # kernel launches during Scheduler.serve
    worst_gap: float              # max over served tokens of (Engine max - served logit)
    exact_share: float            # served tokens that are the Engine's argmax
    delta: Optional[float]        # None: measured, not held
    engine_s: float               # host clock around the Engine's teacher forcing


@dataclasses.dataclass
class TenantCheck:
    serve: ServeCheck             # the driven trace, held to the Engine
    counts: Dict[str, object]     # Scheduler.compile_counts()
    shed_error: str               # the producer thread's ValueError
    callbacks: int                # on_token calls delivered
    callback_threads: List[str]   # the threads they ran on
    pump_thread: str
    streamed: Dict[int, int]      # rid -> tokens its tenant's consumer streamed
    # rid -> seconds after the pump started at which the request's first
    # and last tokens were delivered (on_token, at the end of their tick):
    first_token_s: Dict[int, float]
    last_token_s: Dict[int, float]
    prefill_ctx: List[int]        # distinct context lengths of the prefill rows


@dataclasses.dataclass
class ServeResult:
    device: str
    sizes: ServeSizes
    init_s: float                 # lm.init on the device
    float_serve: ServeCheck
    dcim_serve: Optional[ServeCheck]
    peak_bytes: int
    tenants: Optional[TenantCheck] = None
    unpaged_serve: Optional[ServeCheck] = None
    own_routing: Optional[ServeCheck] = None    # serve_hybrid: the Engine on its own experts
    routing: Optional[RoutingTrace] = None      # serve_hybrid: the served experts it took


def serve_trace(sizes: ServeSizes, vocab: int) -> List[Request]:
    """The float serve's requests, from ``SEED`` with numpy: a shared
    system prefix plus a unique tail each."""
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, vocab, sizes.prefix)
    lo, hi = sizes.tail
    return [Request(prompt=np.concatenate([prefix, rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))]),
                    n_tokens=sizes.n_tokens, arrival=a)
            for a in sizes.arrivals]


def edp_design(prec: str, dev, full: bool) -> ParetoPoint:
    """The best ``prec`` point by energy-delay product (what ``run``
    distils), from a fresh exploration of its two scenarios."""
    cfg = dse_config(full)
    pts = explore_multi([(prec, w) for w in W_STORES], cfg, device=dev)
    return distill(pts, sort_by="edp")[0]


class RoutingTrace:
    """The served path's top-k experts of every labelled token in every
    MoE layer (``record``, a ``moe.routing`` hook), and a hook that makes
    the Engine's teacher forcing take them (``replay``).  A token whose
    k-th and (k+1)-th router probabilities lie closer than two paths'
    bf16 roundings differ takes another expert on one of them; with the
    Engine on the served experts that no longer separates the paths, and
    what is left between them is the serving path's arithmetic."""

    def __init__(self):
        self._calls = []          # (row ids, positions, layer, top-k on the device)
        self.replayed = 0         # Engine token-layers given the served experts
        self.differ = 0           # ... where the Engine's own top-k was another set
        self.missing = 0          # Engine token-layers the served path never routed

    def record(self, ids, pos, layer, idx):
        self._calls.append((ids, pos, layer, idx))

    def _table(self) -> Dict[Tuple[int, int, int], np.ndarray]:
        table = {}                # later calls win: a re-prefill's routing is what followed
        for ids, pos, layer, idx in self._calls:
            idx = idx.cpu().numpy().reshape(*pos.shape, -1)
            for r in np.flatnonzero(ids >= 0):
                for s in np.flatnonzero(pos[r] >= 0):
                    table[(int(ids[r]), int(pos[r, s]), layer)] = idx[r, s]
        return table

    def replay(self, rids: List[int]):
        """The hook for an Engine whose row label i carries request
        ``rids[i]``."""
        table = self._table()

        def hook(ids, pos, layer, idx):
            own = idx.cpu().numpy().reshape(*pos.shape, -1)
            out = own.copy()
            for r in np.flatnonzero(ids >= 0):
                for s in range(pos.shape[1]):
                    got = table.get((rids[ids[r]], int(pos[r, s]), layer))
                    if got is None:
                        self.missing += 1
                        continue
                    out[r, s] = got
                    self.replayed += 1
                    self.differ += set(got.tolist()) != set(own[r, s].tolist())
            return torch.as_tensor(out.reshape(-1, out.shape[-1]), device=idx.device)

        return hook


def _serve_and_check(name, cfg, params, sizes, reqs, delta, dcim_sim=None,
                     engine_cfg=None, trace: Optional[RoutingTrace] = None,
                     **sched_kw) -> ServeCheck:
    """Serve ``reqs`` through the Scheduler (``sched_kw`` overrides its
    options), then teacher-force every served sequence through the
    Engine (on ``engine_cfg``, by default ``cfg``; on the served experts
    when ``trace`` records them) and hold each served token's logit
    within ``delta`` (None: measure the gap only)."""
    dev = params["ln_f"]["scale"].device
    k0 = dict(cuda_lib.launches)
    kw = dict(max_slots=sizes.max_slots if dcim_sim is None else len(reqs),
              max_len=sizes.max_len, page_size=sizes.page_size, seed=SEED, dcim_sim=dcim_sim)
    sched = Scheduler(cfg, params, **{**kw, **sched_kw})
    t0 = time.perf_counter()
    with moe.routing(trace.record) if trace else contextlib.nullcontext():
        results = sched.serve(reqs)
        _sync(dev)
    seconds = time.perf_counter() - t0
    launches = {k: n - k0[k] for k, n in cuda_lib.launches.items()}
    stats = sched.last_stats
    # Free the pool (and the params, if the caller drops them) before the
    # Engine's cache: the Scheduler and its session refer to each other,
    # so only the cycle collector frees them.
    del sched
    gc.collect()
    chk = _hold_to_engine(name, engine_cfg or cfg, params, sizes.max_len, results, stats,
                          seconds, launches, delta, dcim_sim, trace)
    _print_serve(chk, dev)
    return chk


def _hold_to_engine(name, cfg, params, max_len, results, stats, seconds, launches, delta,
                    dcim_sim=None, trace: Optional[RoutingTrace] = None) -> ServeCheck:
    """Teacher-force every served sequence through the Engine (on the
    experts ``trace`` recorded, if given) and hold each served token's
    logit within ``delta`` of that position's maximum (raises
    otherwise)."""
    dev = params["ln_f"]["scale"].device
    eng = Engine(cfg, params, max_len=max_len, dcim_sim=dcim_sim)
    t0 = time.perf_counter()
    with moe.routing(trace.replay([r.rid for r in results])) if trace else contextlib.nullcontext():
        logits = eng.teacher_force([r.tokens[:r.prompt_len] for r in results],
                                   [r.generated for r in results])
        _sync(dev)
    engine_s = time.perf_counter() - t0
    gaps, exact = [], 0
    for r, lg in zip(results, logits):
        served = torch.as_tensor(r.generated, device=lg.device).long()
        gaps.append(lg.max(dim=-1).values - lg.gather(1, served[:, None])[:, 0])
        exact += int((lg.argmax(dim=-1) == served).sum())
    gaps = torch.cat(gaps)
    chk = ServeCheck(name, results, stats, seconds, launches, float(gaps.max()),
                     exact / gaps.numel(), delta, engine_s)
    if delta is not None and not chk.worst_gap <= delta:
        _print_serve(chk, dev)
        raise AssertionError(f"serve {name}: a served token's Engine logit lies "
                             f"{chk.worst_gap:.4g} below the maximum (> delta {delta})")
    return chk


def _print_serve(chk: ServeCheck, dev) -> None:
    name, stats, results, seconds = chk.name, chk.stats, chk.results, chk.seconds
    dec = stats.decode_step_s
    pre = ", ".join(f"({w}x{b}) {s * 1e3:.1f}" for w, b, s in stats.prefill_s)
    print(f"serve {name}: {len(results)} requests, {stats.generated_tokens} tokens in "
          f"{seconds:.2f} s ({stats.generated_tokens / seconds:.1f} tokens/s); "
          f"decode step median {np.median(dec) * 1e3:.2f} ms over {len(dec)} steps; "
          f"prefill ms per program (width x bucket): {pre}")
    print(f"serve {name} stats: steps={stats.steps} decode_steps={stats.decode_steps} "
          f"prefills={stats.prefills} prefill_batches={stats.prefill_batches} "
          f"occupancy={stats.occupancy:.3f} prefix_reuse_active={stats.prefix_reuse_active} "
          f"pool_bytes={stats.pool_bytes} prefix_hit_tokens="
          f"{sum(r.prefix_hit_tokens for r in results)} preemptions={stats.preemptions} "
          f"prefill_chunks={stats.prefill_chunks} shed={stats.shed} paging={stats.paging}")
    print(f"serve {name} launches: " + " ".join(f"{k}={n}" for k, n in chk.launches.items()))
    print(f"serve {name} vs Engine (teacher-forced, {chk.engine_s:.2f} s): worst logit gap "
          f"{chk.worst_gap:.4g} ({'not held' if chk.delta is None else f'delta {chk.delta}'}), "
          f"exact argmax at {chk.exact_share:.3f} of {sum(r.generated.size for r in results)} "
          f"tokens")
    if dev.type == "cuda":
        print(f"serve {name}: peak device memory so far "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")


def _draw_params(phase: str, arch: str, cfg, dev):
    """``cfg``'s params drawn on ``dev`` from ``SEED``, after freeing an
    earlier phase's models (held in Scheduler/session cycles) and
    resetting the peak-memory count.  Returns (params, seconds)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = lm.init(cfg, gen, dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{phase}: {arch} {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.param_dtype}, "
          f"{n_params / 1e9:.3f} B params drawn on {dev} in {init_s:.2f} s")
    return params, init_s


def _dcim_inputs(design: Optional[ParetoPoint], dev, full: bool, vocab: int,
                 sizes: ServeSizes):
    """The DCIM serve's int8 design (by default the best one by energy-delay
    product of a fresh exploration), its simulator and its 2 requests."""
    design = design if design is not None else edp_design("int8", dev, full)
    if design.precision != "int8":
        raise ValueError(f"the DCIM serve takes an int8 design, got {design.precision}")
    rng = np.random.default_rng(SEED + 1)
    reqs = [Request(prompt=rng.integers(0, vocab, sizes.dcim_prompt),
                    n_tokens=sizes.dcim_tokens) for _ in range(2)]
    return design, DCIMMacroSim.from_point(design), reqs


def _peak_and_launches(phase: str, dev, required) -> int:
    """Peak device memory of the phase (0 off the card); raises if a
    kernel that ``required`` ((ServeCheck, kernel names) pairs) names
    was never launched in that serve."""
    if dev.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{phase}: peak device memory {peak / 2**30:.2f} GiB")
    idle = [f"{chk.name} {k}" for chk, names in required for k in names
            if chk.launches[k] == 0]
    if idle:
        raise AssertionError(f"the {phase} path never launched {idle}")
    return int(peak)


def _family_cfg(arch: str, full: bool, n_layers: Optional[int] = None):
    """The full config (cut to ``n_layers``), or at ``full=False`` the
    smoke config with a float32 cache: the smoke configs compute in
    float32 over a bf16 cache, which gates prefix reuse off, and a
    float32 cache keeps the rehearsal on the full config's path (bf16
    over bf16: reuse on unless an SSM layer gates it off)."""
    if full:
        return configs.get_config(arch, **({} if n_layers is None else {"n_layers": n_layers}))
    return dataclasses.replace(configs.get_smoke_config(arch), cache_dtype="float32")


def serve(device="cuda", full: bool = True, design: Optional[ParetoPoint] = None) -> ServeResult:
    """The serve path (steps 5 to 8 of the module docstring).
    ``design`` is the int8 macro of the DCIM serve; by default the best
    int8 point by energy-delay product of a fresh exploration."""
    dev = resolve(device)
    sizes = SERVE_FULL if full else SERVE_SMOKE
    cfg = _family_cfg(ARCH, full)
    params, init_s = _draw_params("serve", ARCH, cfg, dev)

    reqs = serve_trace(sizes, cfg.vocab_size)
    fl = _serve_and_check("float", cfg, params, sizes, reqs, SERVE_DELTA[cfg.compute_dtype])
    if sum(r.prefix_hit_tokens for r in fl.results) <= 0:
        raise AssertionError("serve float: no prompt token was served from cached pages")

    design, sim, dreqs = _dcim_inputs(design, dev, full, cfg.vocab_size, sizes)
    print(f"serve dcim: design {design.summary()}")
    dc = _serve_and_check("dcim", cfg, params, sizes, dreqs, DCIM_DELTA[cfg.compute_dtype], sim)

    tn, up = serve_tenants(cfg, params, full)

    attn = ("paged_decode_gqa", "prefix_prefill")
    peak = _peak_and_launches("serve", dev, [(fl, attn), (dc, attn + ("dcim_mvm",)),
                                             (tn.serve, attn)])
    return ServeResult(device=str(dev), sizes=sizes, init_s=init_s, float_serve=fl,
                       dcim_serve=dc, peak_bytes=peak, tenants=tn, unpaged_serve=up)


def tenant_trace(tz: TenantSizes, sizes: ServeSizes, vocab: int) -> List[Request]:
    """The two-tenant trace: ``serve_trace``'s first ``tz.n_batch``
    requests (all arriving at step 0) asking for ``tz.batch_tokens`` each
    at priority 1, then the interactive requests at priority 3, their
    prompts from ``SEED + 2`` with numpy."""
    batch = [dataclasses.replace(r, n_tokens=tz.batch_tokens, rid=i, priority=1,
                                 tenant="batch")
             for i, r in enumerate(serve_trace(sizes, vocab)[:tz.n_batch])]
    rng = np.random.default_rng(SEED + 2)
    inter = [Request(prompt=rng.integers(0, vocab, n), n_tokens=tz.inter_tokens,
                     rid=tz.n_batch + j, priority=3, arrival=a, tenant="interactive")
             for j, (n, a) in enumerate(zip(tz.inter_prompts, tz.inter_arrivals))]
    return batch + inter


def serve_tenants(cfg, params, full: bool = True,
                  wait_s: float = 900.0) -> Tuple[TenantCheck, ServeCheck]:
    """The multi-tenant front end (steps 7 and 8 of the module docstring)
    on ``params`` (the float serve's model): ``tenant_trace`` through
    ``drive_tenants`` (queued before the pump starts, a producer's shed,
    consumers streaming under the pump; it must preempt, fill in chunks
    and shed once, every served sequence held to the Engine within
    ``SERVE_DELTA``).  Then two of the batch requests through
    ``paged=False`` (the monolithic cache and the plain attention, no
    kernel), held the same way.  ``wait_s`` bounds every join and wait."""
    sizes = SERVE_FULL if full else SERVE_SMOKE
    tz = TENANTS_FULL if full else TENANTS_SMOKE
    reqs = tenant_trace(tz, sizes, cfg.vocab_size)
    sched = Scheduler(cfg, params, **tenant_sched_kw(tz))
    tn = drive_tenants(sched, reqs, tz, wait_s, "tenants", cfg, params)
    del sched
    gc.collect()

    up = _serve_and_check("paged=False", cfg, params, sizes,
                          [dataclasses.replace(r, priority=1) for r in reqs[:2]],
                          SERVE_DELTA[cfg.compute_dtype], paged=False, max_slots=2)
    if sum(up.launches.values()):
        raise AssertionError(f"serve paged=False launched a kernel: {up.launches}")
    return tn, up


def tenant_sched_kw(tz: TenantSizes) -> dict:
    """The two-tenant trace's ``Scheduler`` options."""
    return dict(max_slots=tz.max_slots, max_len=tz.max_len, page_size=tz.page_size,
                prefill_chunk=tz.prefill_chunk, max_queue=tz.max_queue, seed=SEED)


def drive_tenants(sched: Scheduler, reqs: List[Request], tz: TenantSizes, wait_s: float,
                  name: str, cfg, params) -> TenantCheck:
    """The front end of the two-tenant trace on ``sched``'s session: queue
    every request of ``reqs`` before the pump starts, so that the
    schedule does not depend on thread timing; a producer thread's one
    more submission must shed (the queue holds ``max_queue`` requests
    until the pump's first tick); then the pump serves the trace while
    one consumer thread per tenant streams its requests' tokens and waits
    on each.  ``params`` (whole) hold every served token to the Engine
    within ``SERVE_DELTA``, and the trace is held to ``_check_tenants``'s
    bars.  Under a model axis of more than one rank this is the front
    end's part, while the followers pump (``_tp_tenants``)."""
    dev = params["ln_f"]["scale"].device
    k0 = dict(cuda_lib.launches)
    sess = sched.session()
    callback_threads: Counter = Counter()
    first: Dict[int, float] = {}
    last: Dict[int, float] = {}

    def on_token(handle, tok):
        callback_threads[threading.current_thread().name] += 1
        first.setdefault(handle.rid, time.perf_counter() - t0)
        last[handle.rid] = time.perf_counter() - t0

    handles = [sess.submit(r, on_token=on_token) for r in reqs]
    shed: List[str] = []

    def produce():
        try:
            sess.submit(Request(prompt=reqs[-1].prompt, n_tokens=tz.inter_tokens, priority=3,
                                tenant="interactive"))
        except ValueError as e:
            shed.append(str(e))

    producer = threading.Thread(target=produce, name="producer")
    producer.start()
    producer.join(timeout=wait_s)
    if producer.is_alive() or len(shed) != 1:
        raise AssertionError(f"serve {name}: the producer's submission to a full queue did "
                             f"not shed ({shed})")

    streamed: Dict[int, int] = {}
    errors: List[BaseException] = []

    def consume(tenant):
        try:
            for h in handles:
                if h.request.tenant != tenant:
                    continue
                streamed[h.rid] = sum(1 for _ in h.stream())
                h.wait(timeout=wait_s)
        except BaseException as e:        # re-raised below, after the pump stops
            errors.append(e)

    t0 = time.perf_counter()
    with sess.driving():
        consumers = [threading.Thread(target=consume, args=(x,), name=f"consumer-{x}")
                     for x in ("batch", "interactive")]
        for c in consumers:
            c.start()
        for c in consumers:
            c.join(timeout=wait_s)
        if any(c.is_alive() for c in consumers):
            raise AssertionError(f"serve {name}: a consumer did not finish in {wait_s} s")
        sess.wait_idle(timeout=wait_s)
    _sync(dev)
    seconds = time.perf_counter() - t0
    if errors:
        raise errors[0]
    launches = {k: n - k0[k] for k, n in cuda_lib.launches.items()}
    stats = sched.last_stats
    results = [h.result for h in handles]
    counts = sched.compile_counts()
    del sess, handles
    gc.collect()
    chk = _hold_to_engine(name, cfg, params, tz.max_len, results, stats, seconds, launches,
                          SERVE_DELTA[cfg.compute_dtype])
    ctx = sorted({c for row in stats.prefill_ctx for c in row})
    tn = TenantCheck(chk, counts, shed[0], sum(callback_threads.values()),
                     sorted(callback_threads), "serve-session-pump", streamed, first, last, ctx)
    _print_serve(chk, dev)
    print(f"serve {name}: compile_counts {counts}")
    print(f"serve {name}: shed from the producer thread: {tn.shed_error}")
    print(f"serve {name}: {tn.callbacks} on_token callbacks, on thread(s) "
          f"{tn.callback_threads}; the consumers streamed {sum(streamed.values())} tokens")
    print(f"serve {name}: prefill context lengths {ctx}")
    for r in results:
        print(f"serve {name}: rid {r.rid} {r.tenant} priority {r.priority}: prompt "
              f"{r.prompt_len}, {r.generated.size} tokens, admitted step {r.admitted_step}, "
              f"finished step {r.finished_step}, preemptions {r.preemptions}, prefix hits "
              f"{r.prefix_hit_tokens}; first token delivered {first[r.rid]:.3f} s, last "
              f"{last[r.rid]:.3f} s after the pump started")
    _check_tenants(tn, tz)
    return tn


def _check_tenants(tn: TenantCheck, tz: TenantSizes) -> None:
    st, results = tn.serve.stats, tn.serve.results
    victims = [r for r in results if r.preemptions]
    chunk_ctx = {k * tz.prefill_chunk for k in (1, 2, 3)}
    fails = []
    if st.preemptions < 1 or not victims:
        fails.append(f"no preemption ({st.preemptions})")
    if any(r.tenant != "batch" or r.admitted_step != 0 for r in victims):
        fails.append("a victim is not a batch request first admitted at step 0")
    if st.prefill_chunks < 4 or not chunk_ctx <= set(tn.prefill_ctx):
        fails.append(f"{st.prefill_chunks} chunks at context lengths {tn.prefill_ctx}")
    if st.shed != 1:
        fails.append(f"shed {st.shed}")
    if tn.callback_threads != [tn.pump_thread]:
        fails.append(f"callbacks ran on {tn.callback_threads}")
    if tn.callbacks != st.generated_tokens or any(
            tn.streamed[r.rid] != r.generated.size for r in results):
        fails.append(f"{tn.callbacks} callbacks / {tn.streamed} streamed for "
                     f"{st.generated_tokens} tokens")
    if any(r.generated.size != (tz.batch_tokens if r.tenant == "batch" else tz.inter_tokens)
           for r in results):
        fails.append("a request did not get all its tokens")
    if fails:
        raise AssertionError("serve tenants: " + "; ".join(fails))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _first_groups(params, n: int):
    """A params tree cut to its first ``n`` layer groups (views)."""
    def cut(x):
        return {k: cut(v) for k, v in x.items()} if isinstance(x, dict) else x[:n]

    return {**params, "blocks": [cut(b) for b in params["blocks"]]}


def serve_ssm(device="cuda", full: bool = True,
              design: Optional[ParetoPoint] = None) -> ServeResult:
    """The SSM serve path (steps 9 and 10 of the module docstring).
    ``design`` is the int8 macro of the DCIM serve, as for ``serve``."""
    dev = resolve(device)
    sizes = SSM_SERVE_FULL if full else SERVE_SMOKE
    cfg = _family_cfg(SSM_ARCH, full)
    params, init_s = _draw_params("serve_ssm", SSM_ARCH, cfg, dev)

    reqs = serve_trace(sizes, cfg.vocab_size)
    fl = _serve_and_check("ssm float", cfg, params, sizes, reqs,
                          SSM_SERVE_DELTA[cfg.compute_dtype],
                          engine_cfg=dataclasses.replace(cfg, ssm_impl="assoc"))
    hits = sum(r.prefix_hit_tokens for r in fl.results)
    if fl.stats.prefix_reuse_active or hits:
        raise AssertionError(f"serve ssm float: prefix reuse active "
                             f"({fl.stats.prefix_reuse_active}, {hits} hit tokens) over "
                             f"recurrent state")

    design, sim, dreqs = _dcim_inputs(design, dev, full, cfg.vocab_size, sizes)
    layers = SSM_DCIM_LAYERS if full else cfg.n_layers // 2
    dcfg = dataclasses.replace(cfg, n_layers=layers)
    print(f"serve_ssm dcim: {layers} of {cfg.n_layers} layers, design {design.summary()}")
    dc = _serve_and_check("ssm dcim", dcfg, _first_groups(params, layers), sizes, dreqs,
                          DCIM_DELTA[cfg.compute_dtype], sim,
                          engine_cfg=dataclasses.replace(dcfg, ssm_impl="assoc"))

    peak = _peak_and_launches("serve_ssm", dev, [(fl, ("selective_scan",)),
                                                 (dc, ("selective_scan", "dcim_mvm"))])
    return ServeResult(device=str(dev), sizes=sizes, init_s=init_s, float_serve=fl,
                       dcim_serve=dc, peak_bytes=peak)


def serve_mla(device="cuda", full: bool = True,
              design: Optional[ParetoPoint] = None) -> ServeResult:
    """The MLA + MoE serve path (steps 11 and 12 of the module docstring).
    ``design`` is the int8 macro of the DCIM serve, as for ``serve``."""
    dev = resolve(device)
    sizes = MLA_SERVE_FULL if full else SERVE_SMOKE
    # The serving functions ignore the MTP head: not drawing it keeps its
    # extra MoE block (12.4 B params at full width) off the card.
    cfg = dataclasses.replace(_family_cfg(MLA_ARCH, full, MLA_LAYERS), mtp=False)
    params, init_s = _draw_params("serve_mla", MLA_ARCH, cfg, dev)

    reqs = serve_trace(sizes, cfg.vocab_size)
    fl = _serve_and_check("mla float", cfg, params, sizes, reqs,
                          MLA_SERVE_DELTA[cfg.compute_dtype])
    if sum(r.prefix_hit_tokens for r in fl.results) <= 0:
        raise AssertionError("serve mla float: no prompt token was served from cached pages")

    design, sim, dreqs = _dcim_inputs(design, dev, full, cfg.vocab_size, sizes)
    print(f"serve_mla dcim: design {design.summary()}")
    dc = _serve_and_check("mla dcim", cfg, params, sizes, dreqs, DCIM_DELTA[cfg.compute_dtype],
                          sim)

    attn = ("paged_decode_mla", "prefix_prefill")
    peak = _peak_and_launches("serve_mla", dev, [(fl, attn), (dc, attn + ("dcim_mvm",))])
    return ServeResult(device=str(dev), sizes=sizes, init_s=init_s, float_serve=fl,
                       dcim_serve=dc, peak_bytes=peak)


# --- the remaining families ---------------------------------------------------------
def serve_music(device="cuda", full: bool = True,
                design: Optional[ParetoPoint] = None) -> ServeResult:
    """The audio family (step 13 of the module docstring): musicgen-large
    served on ``serve_trace`` at its vocabulary, then under the int8
    ``design`` (by default a fresh exploration's best by energy-delay
    product)."""
    dev = resolve(device)
    sizes = SERVE_FULL if full else SERVE_SMOKE
    cfg = _family_cfg(MUSIC_ARCH, full)
    params, init_s = _draw_params("serve_music", MUSIC_ARCH, cfg, dev)

    reqs = serve_trace(sizes, cfg.vocab_size)
    fl = _serve_and_check("music float", cfg, params, sizes, reqs,
                          SERVE_DELTA[cfg.compute_dtype])
    if sum(r.prefix_hit_tokens for r in fl.results) <= 0:
        raise AssertionError("serve music float: no prompt token was served from cached pages")

    design, sim, dreqs = _dcim_inputs(design, dev, full, cfg.vocab_size, sizes)
    print(f"serve_music dcim: design {design.summary()}")
    dc = _serve_and_check("music dcim", cfg, params, sizes, dreqs,
                          DCIM_DELTA[cfg.compute_dtype], sim)

    attn = ("paged_decode_gqa", "prefix_prefill")
    peak = _peak_and_launches("serve_music", dev, [(fl, attn), (dc, attn + ("dcim_mvm",))])
    return ServeResult(device=str(dev), sizes=sizes, init_s=init_s, float_serve=fl,
                       dcim_serve=dc, peak_bytes=peak)


def vlm_position_ids(sz: VlmSizes) -> np.ndarray:
    """One row's (3, prompt + n_decode) M-RoPE streams (temporal, height,
    width), as Qwen2-VL's rope index lays them out: text positions
    0 .. text0 - 1 on all three; the image grid's temporal stream fixed
    at the next index and its height and width streams running over the
    grid from that base; then text from the largest id + 1 on."""
    h, w = sz.grid
    base = sz.text0
    text0 = np.arange(base)
    grid = [np.full(h * w, base), base + np.repeat(np.arange(h), w), base + np.tile(np.arange(w), h)]
    text1 = base + max(h, w) + np.arange(sz.text1 + sz.n_decode)
    return np.stack([np.concatenate([text0, g, text1]) for g in grid]).astype(np.int32)


def vlm_inputs(sz: VlmSizes, d_model: int, seed: int = SEED):
    """The stub frontend, with numpy from ``seed``: N(0, 1) float32
    embeddings (batch, prompt + n_decode, d_model), as the reference's
    ``launch.specs.concrete_batch`` draws them, and the (3, batch,
    prompt + n_decode) position ids of ``vlm_position_ids`` on every row."""
    ids = vlm_position_ids(sz)
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((sz.batch, ids.shape[1], d_model), dtype=np.float32)
    return embeds, np.ascontiguousarray(np.broadcast_to(ids[:, None], (3, sz.batch, ids.shape[1])))


@dataclasses.dataclass
class StepsCheck:
    """``lm.prefill`` and decode steps held to a teacher-forced forward."""
    name: str
    prefill_s: float              # host clock around lm.prefill
    decode_s: List[float]         # host clock around each lm.decode_step
    tokens: int                   # batch x decode steps
    launches: Dict[str, int]      # kernel launches during prefill and decode
    worst_diff: float             # max |logit - teacher-forced logit| over every step
    exact_share: float            # steps whose argmax is the teacher-forced one
    delta: float
    forward_s: float              # host clock around the teacher-forced forward


@dataclasses.dataclass
class VlmResult:
    device: str
    sizes: VlmSizes
    init_s: float
    float_steps: StepsCheck
    dcim_steps: StepsCheck
    peak_bytes: int


def _steps_and_check(name, cfg, params, embeds, ids, sz: VlmSizes, delta) -> StepsCheck:
    """``lm.prefill`` over the prompt, then one ``lm.decode_step`` per
    further input; every step's logits (prefill's included) must lie
    within ``delta`` of the head over ``forward_hidden`` of the whole
    sequence at the same positions (raises otherwise)."""
    dev = params["ln_f"]["scale"].device
    P, S = sz.prompt, sz.prompt + sz.n_decode
    e = torch.from_numpy(embeds).to(dev)
    pid = torch.from_numpy(ids).to(dev)
    k0 = dict(cuda_lib.launches)
    with torch.no_grad():
        t0 = time.perf_counter()
        caches, lg = lm.prefill(params, {"embeds": e[:, :P], "position_ids": pid[:, :, :P]},
                                cfg, max_len=S)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        steps, decode_s = [lg], []
        for t in range(P, S):
            t0 = time.perf_counter()
            lg, caches = lm.decode_step(
                params, {"embeds": e[:, t:t + 1], "position_ids": pid[:, :, t:t + 1]}, t,
                caches, cfg)
            _sync(dev)
            decode_s.append(time.perf_counter() - t0)
            steps.append(lg)
        launches = {k: n - k0[k] for k, n in cuda_lib.launches.items()}
        del caches
        t0 = time.perf_counter()
        h, _, _ = lm.forward_hidden(params, lm.embed_inputs(params, {"embeds": e}, cfg), cfg,
                                    pid, training=False)
        want = lm.head_logits(params, norm_apply(params["ln_f"], h[:, P - 1:S], cfg.norm), cfg)
        _sync(dev)
        forward_s = time.perf_counter() - t0
    got = torch.cat(steps, dim=1)                                   # (B, n_decode + 1, V)
    diff = float((got.float() - want.float()).abs().max())
    exact = float((got.argmax(dim=-1) == want.argmax(dim=-1)).float().mean())
    chk = StepsCheck(name, prefill_s, decode_s, sz.batch * sz.n_decode, launches, diff, exact,
                     delta, forward_s)
    _print_steps(chk, sz, dev)
    if not diff <= delta:
        raise AssertionError(f"{name}: a step's logits lie {diff:.4g} from the teacher-forced "
                             f"forward's (> delta {delta})")
    return chk


def _print_steps(chk: StepsCheck, sz: VlmSizes, dev) -> None:
    dec = chk.decode_s
    print(f"{chk.name}: prefill ({sz.batch} x {sz.prompt}) {chk.prefill_s * 1e3:.1f} ms; decode "
          f"step median {np.median(dec) * 1e3:.2f} ms over {len(dec)} steps "
          f"({chk.tokens / sum(dec):.1f} tokens/s)")
    print(f"{chk.name} launches: " + " ".join(f"{k}={n}" for k, n in chk.launches.items()))
    print(f"{chk.name} vs teacher-forced forward ({chk.forward_s:.2f} s): worst logit diff "
          f"{chk.worst_diff:.4g} (delta {chk.delta}), exact argmax at {chk.exact_share:.3f} of "
          f"{sz.batch * (sz.n_decode + 1)} steps")
    if dev.type == "cuda":
        print(f"{chk.name}: peak device memory so far "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")


def serve_vlm(device="cuda", full: bool = True,
              design: Optional[ParetoPoint] = None) -> VlmResult:
    """The VLM family (step 14 of the module docstring).  ``design`` is
    the bf16 macro (by default a fresh exploration's best by energy-delay
    product)."""
    dev = resolve(device)
    sz = VLM_FULL if full else VLM_SMOKE
    cfg = _family_cfg(VLM_ARCH, full, VLM_LAYERS)
    if full:
        print(f"serve_vlm: {VLM_ARCH} cut to {VLM_LAYERS} of 80 layers (full width)")
    params, init_s = _draw_params("serve_vlm", VLM_ARCH, cfg, dev)
    embeds, ids = vlm_inputs(sz, cfg.d_model)
    print(f"serve_vlm: stub frontend, {sz.batch} rows of {sz.text0} text + {sz.grid[0]} x "
          f"{sz.grid[1]} image + {sz.text1} text positions, then {sz.n_decode} decode steps; "
          f"streams t/h/w over the image {ids[0, 0, sz.text0]} / "
          f"{ids[1, 0, sz.text0]}-{ids[1, 0, sz.prompt - sz.text1 - 1]} / "
          f"{ids[2, 0, sz.text0]}-{ids[2, 0, sz.text0 + sz.grid[1] - 1]}, text after from "
          f"{ids[0, 0, sz.prompt - sz.text1]}")
    fl = _steps_and_check("vlm float", cfg, params, embeds, ids, sz,
                          SERVE_DELTA[cfg.compute_dtype])

    design = design if design is not None else edp_design("bf16", dev, full)
    if design.precision != "bf16":
        raise ValueError(f"the VLM's DCIM drive takes a bf16 design, got {design.precision}")
    layers = VLM_DCIM_LAYERS if full else cfg.n_layers // 2
    dcfg = dataclasses.replace(cfg, n_layers=layers)
    print(f"serve_vlm dcim: {layers} of {cfg.n_layers} layers, design {design.summary()}")
    with dcim_numerics(DCIMMacroSim.from_point(design)):
        dc = _steps_and_check("vlm dcim", dcfg, _first_groups(params, layers), embeds, ids, sz,
                              DCIM_DELTA[cfg.compute_dtype])
    peak = 0
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"serve_vlm: peak device memory {peak / 2**30:.2f} GiB")
        idle = [k for k in ("fp_prealign", "dcim_mvm") if dc.launches[k] == 0]
        if idle:
            raise AssertionError(f"the serve_vlm path never launched {idle}")
    return VlmResult(device=str(dev), sizes=sz, init_s=init_s, float_steps=fl, dcim_steps=dc,
                     peak_bytes=int(peak))


def serve_hybrid(device="cuda", full: bool = True) -> ServeResult:
    """The hybrid family (step 15 of the module docstring): jamba, top-2
    of 16 experts as configured, served on ``serve_trace`` and held to
    the Engine on the associative scan within ``SSM_SERVE_DELTA``, the
    Engine taking the experts the served path chose (``RoutingTrace``).
    On its own routing the Engine parts from the served path wherever a
    token's 2nd and 3rd router probabilities lie closer than the two
    paths' bf16 roundings differ: that token takes another expert, which
    carries up to half its routed mass, and the 14 Mamba layers carry its
    changed state into every later position (PERF.md: a worst gap of
    2.03 on an H100).  That gap is printed beside, not held, with the
    count of token-layers whose expert sets differ."""
    dev = resolve(device)
    sizes = SERVE_FULL if full else SERVE_SMOKE
    cfg = _family_cfg(JAMBA_ARCH, full, JAMBA_LAYERS)
    if full:
        print(f"serve_hybrid: {JAMBA_ARCH} cut to {JAMBA_LAYERS} of 32 layers (2 of 4 periods, "
              f"full width)")
    params, init_s = _draw_params("serve_hybrid", JAMBA_ARCH, cfg, dev)
    reqs = serve_trace(sizes, cfg.vocab_size)
    ecfg = dataclasses.replace(cfg, ssm_impl="assoc")
    trace = RoutingTrace()
    fl = _serve_and_check("hybrid float", cfg, params, sizes, reqs,
                          SSM_SERVE_DELTA[cfg.compute_dtype], engine_cfg=ecfg, trace=trace)
    print(f"serve hybrid float: the Engine took the served top-{cfg.moe.top_k} experts at "
          f"{trace.replayed} token-layers, {trace.differ} of which differ from its own choice")
    if trace.missing or not trace.replayed:
        raise AssertionError(f"serve hybrid float: {trace.missing} of the Engine's token-layers "
                             f"were never routed by the served path ({trace.replayed} were)")
    own = _hold_to_engine("hybrid float (Engine's own routing)", ecfg, params, sizes.max_len,
                          fl.results, fl.stats, fl.seconds, fl.launches, None)
    print(f"serve hybrid float vs Engine on its own routing (teacher-forced, {own.engine_s:.2f} "
          f"s): worst logit gap {own.worst_gap:.4g} (not held), exact argmax at "
          f"{own.exact_share:.3f}")
    hits = sum(r.prefix_hit_tokens for r in fl.results)
    if fl.stats.prefix_reuse_active or hits:
        raise AssertionError(f"serve hybrid float: prefix reuse active "
                             f"({fl.stats.prefix_reuse_active}, {hits} hit tokens) over "
                             f"recurrent state")
    if any(r.generated.size != sizes.n_tokens for r in fl.results):
        raise AssertionError("serve hybrid float: a request did not get all its tokens")
    kernels = ("selective_scan", "paged_decode_gqa", "prefix_prefill")
    peak = _peak_and_launches("serve_hybrid", dev, [(fl, kernels)])
    return ServeResult(device=str(dev), sizes=sizes, init_s=init_s, float_serve=fl,
                       dcim_serve=None, peak_bytes=peak, own_routing=own, routing=trace)


def serve_moe(device="cuda", full: bool = True) -> ServeResult:
    """The GQA + MoE family (step 16 of the module docstring): moonshot
    served on ``serve_trace`` with prefix hits, held to the Engine."""
    dev = resolve(device)
    sizes = SERVE_FULL if full else SERVE_SMOKE
    cfg = _family_cfg(MOE_ARCH, full)
    params, init_s = _draw_params("serve_moe", MOE_ARCH, cfg, dev)
    reqs = serve_trace(sizes, cfg.vocab_size)
    fl = _serve_and_check("moe float", cfg, params, sizes, reqs, SERVE_DELTA[cfg.compute_dtype])
    if sum(r.prefix_hit_tokens for r in fl.results) <= 0:
        raise AssertionError("serve moe float: no prompt token was served from cached pages")
    peak = _peak_and_launches("serve_moe", dev, [(fl, ("paged_decode_gqa", "prefix_prefill"))])
    return ServeResult(device=str(dev), sizes=sizes, init_s=init_s, float_serve=fl,
                       dcim_serve=None, peak_bytes=peak)


# --- params moved to the card by hand ------------------------------------------------
MOVED_REQUESTS = 2


@dataclasses.dataclass
class MovedResult:
    init_s: float                 # lm.init on the CPU
    move_s: float                 # .to(device), leaf by leaf
    flags: Dict[str, Tuple[bool, bool]]   # the reduction flags before and after each stage
    serve: ServeCheck


def reduction_flags() -> Tuple[bool, bool]:
    """cuBLAS's (bf16, f16) reduced-precision reduction switches."""
    m = torch.backends.cuda.matmul
    return (m.allow_bf16_reduced_precision_reduction, m.allow_fp16_reduced_precision_reduction)


def serve_moved(device="cuda", full: bool = True) -> MovedResult:
    """Step 22 of the module docstring: qwen2.5-3b's params drawn on the
    CPU and moved to ``device`` with ``.to``, so that nothing but the
    ``Scheduler`` resolves the card; the reduction flags must be torch's
    default (on) until the Scheduler is built and off after it.  Then
    ``MOVED_REQUESTS`` greedy requests of ``serve_trace`` are served and
    held to the ``Engine`` within ``SERVE_DELTA``.  The flags are
    process-global: on the card run this in a fresh interpreter, before
    anything else resolves the device."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    flags = {"start": reduction_flags()}
    if on_card and flags["start"] != (True, True):
        raise AssertionError(f"serve_moved: the reduction flags start at {flags['start']}, not "
                             f"torch's default (True, True): run it in a fresh interpreter")
    sizes = SERVE_FULL if full else SERVE_SMOKE
    cfg = _family_cfg(ARCH, full)
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator().manual_seed(SEED), "cpu")
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    leaves, tdef = flatten(params)
    params = unflatten(tdef, [t.to(dev) for t in leaves])
    del leaves
    _sync(dev)
    move_s = time.perf_counter() - t0
    flags["moved"] = reduction_flags()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve_moved: {ARCH} {cfg.n_layers} layers, {cfg.param_dtype}, {n_params / 1e9:.3f} B "
          f"params drawn on the CPU in {init_s:.2f} s, moved to {dev} in {move_s:.2f} s; "
          f"reduction flags (bf16, f16) {flags['moved']}")
    if on_card and flags["moved"] != (True, True):
        raise AssertionError(f"serve_moved: drawing and moving the params set the reduction "
                             f"flags to {flags['moved']}")
    k0 = dict(cuda_lib.launches)
    sched = Scheduler(cfg, params, max_slots=sizes.max_slots, max_len=sizes.max_len,
                      page_size=sizes.page_size, seed=SEED)
    flags["scheduler"] = reduction_flags()
    print(f"serve_moved: reduction flags (bf16, f16) after Scheduler(...) {flags['scheduler']}")
    if on_card and flags["scheduler"] != (False, False):
        raise AssertionError(f"serve_moved: Scheduler(...) left the reduction flags at "
                             f"{flags['scheduler']}")
    reqs = [r for r in serve_trace(sizes, cfg.vocab_size) if r.arrival == 0][:MOVED_REQUESTS]
    t0 = time.perf_counter()
    results = sched.serve(reqs)
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches = {k: n - k0[k] for k, n in cuda_lib.launches.items()}
    stats = sched.last_stats
    del sched
    gc.collect()
    chk = _hold_to_engine("moved", cfg, params, sizes.max_len, results, stats, seconds, launches,
                          SERVE_DELTA[cfg.compute_dtype])
    _print_serve(chk, dev)
    _peak_and_launches("serve_moved", dev, [(chk, ("paged_decode_gqa", "prefix_prefill"))])
    return MovedResult(init_s=init_s, move_s=move_s, flags=flags, serve=chk)


# --- tensor-parallel serving ---------------------------------------------------------
TP = 2
TP_SERVES = ("float", "dcim")


@dataclasses.dataclass
class TpResult:
    tp: int
    device: str
    # per rank: init_s, its island run's seconds and K1 launches, per
    # serve its record, and its record of the two-tenant trace
    ranks: List[dict]
    # per serve: the share of its tokens equal to the tp=1 serve's (None:
    # no tp=1 tokens were given)
    same_as_tp1: Dict[str, Optional[float]]

    def serve(self, name: str) -> dict:
        """Rank 0's record of serve ``name``: generated tokens, decode
        step seconds, host seconds, launches, and its gap to the Engine."""
        return self.ranks[0]["serves"][name]


ISLAND_FIELDS = ("genes", "objectives", "violation", "ranks", "front_genes", "front_objectives")


def tenant_schedule(results: List[RequestResult], stats: ServeStats) -> dict:
    """The two-tenant trace's schedule: its counts, and each request's
    admitted and finished steps and preemptions, by rid."""
    return {"preemptions": stats.preemptions, "prefill_chunks": stats.prefill_chunks,
            "shed": stats.shed,
            "requests": sorted([int(r.rid), int(r.admitted_step), int(r.finished_step),
                                int(r.preemptions)] for r in results)}


def _tp_islands(dev, full: bool, out_dir: str, rank: int) -> dict:
    """Step 3's island run over the ranks as a (scenario, island) = (1,
    TP) mesh, its results saved to ``out_dir/islands{rank}.npz``.
    Returns its seconds and K1 launches."""
    mesh = make_local_mesh(TP, 1, names=("scenario", "island"))
    n0 = cuda_lib.launches["dominance"]
    t0 = time.perf_counter()
    res = run_islands_multi(SCENARIOS, dse_config(full), device=dev, mesh=mesh,
                            **(ISLANDS if full else ISLANDS_SMOKE))
    _sync(dev)
    seconds = time.perf_counter() - t0
    np.savez(os.path.join(out_dir, f"islands{rank}.npz"),
             **{f"{i}/{f}": getattr(r, f) for i, r in enumerate(res) for f in ISLAND_FIELDS})
    return {"seconds": seconds, "launches": cuda_lib.launches["dominance"] - n0}


def _serve_tp_rank(rank: int, tp: int, init: str, device: str, full: bool,
                   design: ParetoPoint, out_dir: str) -> None:
    """One rank of ``serve_tp`` (step 17): its record goes to
    ``out_dir/rank{rank}.json``; any failure raises."""
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=tp)
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device)
        rec = {"islands": _tp_islands(dev, full, out_dir, rank), "serves": {}}
        sizes = SERVE_FULL if full else SERVE_SMOKE
        tz = TENANTS_FULL if full else TENANTS_SMOKE
        cfg = _family_cfg(ARCH, full)
        params, init_s = _draw_params(f"serve_tp rank {rank}", ARCH, cfg, dev)
        rec["init_s"] = init_s
        _, sim, dreqs = _dcim_inputs(design, dev, full, cfg.vocab_size, sizes)
        kw = dict(max_len=sizes.max_len, page_size=sizes.page_size, seed=SEED, tp=tp)
        runs = {"float": (Scheduler(cfg, params, max_slots=sizes.max_slots, **kw),
                          serve_trace(sizes, cfg.vocab_size), None),
                "dcim": (Scheduler(cfg, params, max_slots=len(dreqs), dcim_sim=sim, **kw),
                         dreqs, sim)}
        tenants = Scheduler(cfg, params, **tenant_sched_kw(tz), tp=tp)
        if rank:
            del params          # this rank keeps its shards only
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        held = {}
        for name, (sched, reqs, _) in runs.items():
            k0 = dict(cuda_lib.launches)
            t0 = time.perf_counter()
            results = sched.serve(reqs)
            _sync(dev)
            seconds = time.perf_counter() - t0
            launches = {k: n - k0[k] for k, n in cuda_lib.launches.items()}
            rec["serves"][name] = {
                "tokens": [r.generated.tolist() for r in results],
                "decode_step_s": list(sched.last_stats.decode_step_s),
                "seconds": seconds, "launches": launches,
                "prefix_hit_tokens": sum(r.prefix_hit_tokens for r in results)}
            held[name] = (results, sched.last_stats, seconds, launches)
        del runs, sched
        gc.collect()
        if rank == 0:
            for name, delta, s in (("float", SERVE_DELTA, None), ("dcim", DCIM_DELTA, sim)):
                chk = _hold_to_engine(f"tp{tp} {name}", cfg, params, sizes.max_len, *held[name],
                                      delta[cfg.compute_dtype], s)
                _print_serve(chk, dev)
                rec["serves"][name].update(worst_gap=chk.worst_gap, delta=chk.delta,
                                           exact_share=chk.exact_share)
        rec["tenants"] = _tp_tenants(tenants, tz, sizes, cfg, params if rank == 0 else None)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _tp_tenants(sched: Scheduler, tz: TenantSizes, sizes: ServeSizes, cfg, params,
                wait_s: float = 900.0) -> dict:
    """Step 7's two-tenant trace on ``sched`` (a tensor-parallel
    Scheduler): the model group's rank 0 is the front end
    (``drive_tenants``, with ``params`` for its Engine check), the others
    pump and follow.  Returns this rank's record: tokens, schedule,
    launches, and on the front end each request's first and last
    delivery."""
    dev = sched.device
    k0 = dict(cuda_lib.launches)
    if params is not None:
        tn = drive_tenants(sched, tenant_trace(tz, sizes, cfg.vocab_size), tz, wait_s,
                           f"tp{TP} tenants", cfg, params)
        results, chk = tn.serve.results, tn.serve
        out = {"seconds": chk.seconds, "worst_gap": chk.worst_gap, "delta": chk.delta,
               "first_token_s": {int(k): v for k, v in tn.first_token_s.items()},
               "last_token_s": {int(k): v for k, v in tn.last_token_s.items()},
               "decode_step_s": list(chk.stats.decode_step_s)}
    else:
        sess = sched.session()
        t0 = time.perf_counter()
        with sess.driving():
            pass                # the front end's stop message ends the block
        _sync(dev)
        results = [h.result for h in sess.mirrored]
        out = {"seconds": time.perf_counter() - t0}
    out.update(tokens={int(r.rid): r.generated.tolist() for r in results},
               schedule=tenant_schedule(results, sched.last_stats),
               launches={k: n - k0[k] for k, n in cuda_lib.launches.items()})
    return out


def serve_tp(device="cuda", full: bool = True, design: Optional[ParetoPoint] = None,
             tp1_tokens: Optional[Dict[str, List[List[int]]]] = None,
             islands: Optional[List[NSGA2Result]] = None,
             tp1_tenants: Optional[dict] = None) -> TpResult:
    """Step 17 of the module docstring: ``TP`` processes (spawned; on the
    card each on the card of its rank modulo the device count) run the
    island model over a (scenario, island) = (1, TP) mesh, then serve
    qwen2.5-3b through ``Scheduler(tp=TP)`` over a gloo group: the float
    and DCIM traces in lockstep, then the two-tenant trace through the
    pumps, led by rank 0.  ``design`` is the int8 macro of the DCIM
    serve (by default a fresh exploration's best by energy-delay
    product); ``islands`` the one-process island run's results (by
    default run here, before the ranks start); ``tp1_tokens``, the tp=1
    serves' generated tokens per serve name, gives the share of tokens
    equal to them; ``tp1_tenants``, the tp=1 two-tenant trace's
    ``tenant_schedule``, must equal every rank's.  Raises if a rank
    fails, if the ranks' islands differ from ``islands`` in any bit, if
    the ranks' tokens differ, or, on the card, if a rank's island run
    never launched K1, a K4 or K5 launch did not take the tensor-core
    kernel, or K2 never launched."""
    dev, tp = resolve(device), TP
    design = design if design is not None else edp_design("int8", dev, full)
    if islands is None:
        islands = run_islands_multi(SCENARIOS, dse_config(full), device=dev,
                                    **(ISLANDS if full else ISLANDS_SMOKE))
    if dev.type == "cuda":
        cuda_lib.build()        # once, before the ranks load the library
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        torch.multiprocessing.start_processes(
            _serve_tp_rank, args=(tp, init, dev.type, full, design, d), nprocs=tp,
            join=True, start_method="spawn")
        ranks = []
        for r in range(tp):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
            with np.load(os.path.join(d, f"islands{r}.npz")) as z:
                for i, want in enumerate(islands):
                    for f in ISLAND_FIELDS:
                        got, ref = z[f"{i}/{f}"], getattr(want, f)
                        if got.dtype != ref.dtype or not np.array_equal(got, ref):
                            raise AssertionError(f"serve_tp islands rank {r}: {SCENARIOS[i]}'s "
                                                 f"{f} differ from the one-process run's")
            if dev.type == "cuda" and ranks[r]["islands"]["launches"] <= 0:
                raise AssertionError(f"serve_tp islands rank {r}: dominance never launched")
    print(f"serve_tp islands: {len(SCENARIOS)} scenarios over (scenario, island) = (1, {tp}), "
          f"every rank's results bitwise the one-process run's; seconds by rank "
          f"{[round(rec['islands']['seconds'], 3) for rec in ranks]}, dominance launches by "
          f"rank {[rec['islands']['launches'] for rec in ranks]}")
    same: Dict[str, Optional[float]] = {}
    for name in TP_SERVES:
        toks = ranks[0]["serves"][name]["tokens"]
        for r, rec in enumerate(ranks[1:], 1):
            if rec["serves"][name]["tokens"] != toks:
                raise AssertionError(f"serve_tp {name}: rank {r}'s tokens differ from rank 0's")
        if dev.type == "cuda":
            for r, rec in enumerate(ranks):
                got = rec["serves"][name]["launches"]
                _check_attention_launches(f"serve_tp {name} rank {r}", got)
                if name == "dcim" and got["dcim_mvm"] <= 0:
                    raise AssertionError(f"serve_tp dcim rank {r}: dcim_mvm never launched")
        if tp1_tokens is None:
            same[name] = None
        else:
            pairs = [(a, b) for ra, rb in zip(toks, tp1_tokens[name]) for a, b in zip(ra, rb)]
            same[name] = sum(a == b for a, b in pairs) / len(pairs)
        rec0 = ranks[0]["serves"][name]
        dec = sorted(rec0["decode_step_s"])
        print(f"serve_tp {name}: tp={tp}, {len(toks)} requests, every rank's tokens equal; "
              f"{'not compared' if same[name] is None else f'{same[name]:.3f}'} of them equal "
              f"the tp=1 serve's; worst logit gap to the tp=1 Engine {rec0['worst_gap']:.4g} "
              f"(delta {rec0['delta']}); rank 0 decode step median "
              f"{dec[len(dec) // 2] * 1e3:.2f} ms over {len(dec)} steps")
    tn0 = ranks[0]["tenants"]
    for r, rec in enumerate(ranks):
        tn = rec["tenants"]
        if (tn["tokens"], tn["schedule"]) != (tn0["tokens"], tn0["schedule"]):
            raise AssertionError(f"serve_tp tenants: rank {r}'s tokens or schedule differ from "
                                 f"the front end's")
        if tp1_tenants is not None and tn["schedule"] != tp1_tenants:
            raise AssertionError(f"serve_tp tenants rank {r}: schedule {tn['schedule']} is not "
                                 f"the tp=1 trace's {tp1_tenants}")
        if dev.type == "cuda":
            _check_attention_launches(f"serve_tp tenants rank {r}", tn["launches"])
    print(f"serve_tp tenants: tp={tp}, led by rank 0; every rank's tokens and schedule equal "
          f"({tn0['schedule']['preemptions']} preemptions, {tn0['schedule']['prefill_chunks']} "
          f"chunks, {tn0['schedule']['shed']} shed), "
          f"{'not compared with' if tp1_tenants is None else 'equal to'} the tp=1 trace's")
    return TpResult(tp=tp, device=str(dev), ranks=ranks, same_as_tp1=same)


def _check_attention_launches(what: str, got: Dict[str, int]) -> None:
    """K4 and K5 launched, every launch on the tensor-core kernel."""
    for k in ("paged_decode_gqa", "prefix_prefill"):
        if got[k] <= 0 or got[f"{k}_mma"] != got[k]:
            raise AssertionError(f"{what}: {got[f'{k}_mma']} of {got[k]} {k} launches took "
                                 f"the tensor-core kernel")


# --- training ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrainSizes:
    batch: int
    seq: int
    steps: int
    warmup: int


TRAIN_FULL = TrainSizes(4, 1024, 8, 2)
TRAIN_SMOKE = TrainSizes(2, 16, 8, 2)
TRAIN_PEAK_LR = 3e-4
TRAIN_CHECK_ARCHS = (ARCH, MLA_ARCH, SSM_ARCH)
TRAIN_CHECK_LR = 1e-3
# Step 18's bars.  The loss bar and the 1e-4 of a leaf's largest
# magnitude are the ones tests/test_torch_train_* hold the port to
# against JAX; Adam divides by sqrt(v) + 1e-8, so where a gradient is
# mostly f32 rounding noise (qwen's k bias, which RoPE leaves nearly
# free) two summation orders step apart by a fraction of lr: hence the
# lr term (tests/test_torch_train_loop.py's bar).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_TOL = 1e-4
TRAIN_STEP_LR_TOL = 0.05


class LearnableLM:
    """The reference's learnable stream (tests/test_train_substrate.py):
    next token = (token + 1) mod V, row b starting at b * V // B, the same
    batch at every step."""

    def __init__(self, vocab: int, batch: int, seq: int):
        base = np.arange(seq + 1)[None, :] + (np.arange(batch) * (vocab // batch))[:, None]
        toks = (base % vocab).astype(np.int32)
        self.batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                      "loss_mask": np.ones((batch, seq), np.float32)}

    def next_batch(self):
        return dict(self.batch)


@dataclasses.dataclass
class TrainCheck:
    """Step 18 for one architecture: losses on the device and on the CPU,
    the worst parameter difference in units of its bound (<= 1 passes),
    and how many elements missed 1e-4 of their leaf's largest magnitude
    alone."""
    arch: str
    losses: List[float]
    cpu_losses: List[float]
    worst: float
    past_leaf_tol: int
    n_params: int


@dataclasses.dataclass
class TrainResult:
    device: str
    sizes: TrainSizes
    n_params: int
    init_s: float
    losses: List[float]
    grad_norms: List[float]
    step_s: List[float]
    median_step_s: float
    tokens_per_s: float
    peak_bytes: int
    launches: Dict[str, int]                 # hand-kernel launches during the whole path
    checks: List[TrainCheck]
    variants: Dict[str, Dict[str, float]]    # one step of each other optimizer form
    resume_losses: List[float]
    resume_worst: float
    resume_bitwise: bool


def _state_to(state, dev):
    """A copy of a TrainState on ``dev`` (a step writes its state in place)."""
    flat, tdef = flatten(state)
    return unflatten(tdef, [t.to(dev, copy=True) for t in flat])


def _recording(step_fn, out: List[Dict[str, float]]):
    """``step_fn`` that also records each step's metrics as floats (the
    Trainer reads the loss, which synchronises the host, anyway)."""
    def step(state, batch):
        state, m = step_fn(state, batch)
        out.append({k: float(v) for k, v in m.items()})
        return state, m
    return step


def _param_worst(got, want, lr: float, steps: int):
    """(the worst |got - want| over each parameter leaf's bound, the count
    of elements past TRAIN_PARAM_TOL of their leaf's largest magnitude)."""
    worst, past = 0.0, 0
    for (p, a), (_, b) in zip(paths(got), paths(want)):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        top = float(b.abs().max())
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()) / (TRAIN_PARAM_TOL * top
                                                + TRAIN_STEP_LR_TOL * lr * steps))
        past += int((diff > TRAIN_PARAM_TOL * top).sum())
    return worst, past


def _train_full(dev, full: bool) -> dict:
    """Step 17; returns its TrainResult fields."""
    sz = TRAIN_FULL if full else TRAIN_SMOKE
    cfg = (configs.get_config(ARCH) if full else
           dataclasses.replace(configs.get_smoke_config(ARCH), remat=True, loss_chunk=8))
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, step_fn = build(cfg, "adamw", cosine_warmup(TRAIN_PEAK_LR, sz.warmup, sz.steps),
                           seed=SEED, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in flatten(state["params"])[0])
    print(f"train: {ARCH} {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.param_dtype} "
          f"params / {cfg.compute_dtype} compute, remat {cfg.remat}, loss_chunk "
          f"{cfg.loss_chunk}; {n_params / 1e9:.3f} B params and AdamW state drawn on {dev} in "
          f"{init_s:.2f} s; {sz.steps} steps of {sz.batch} x {sz.seq} tokens, lr "
          f"cosine_warmup({TRAIN_PEAK_LR}, {sz.warmup}, {sz.steps})")
    metrics: List[Dict[str, float]] = []
    tr = Trainer(state, _recording(step_fn, metrics), LearnableLM(cfg.vocab_size, sz.batch,
                                                                  sz.seq),
                 TrainerConfig(total_steps=sz.steps, log_every=1))
    tr.run()
    losses = [m["loss"] for m in metrics]
    gnorms = [m["grad_norm"] for m in metrics]
    step_s = list(tr.step_times)
    med = float(np.median(step_s[1:]))
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    for i, (lo, g, dt) in enumerate(zip(losses, gnorms, step_s)):
        print(f"train step {i + 1}: loss {lo:.4f}, grad_norm {g:.4f}, {dt * 1e3:.1f} ms")
    print(f"train: median step (steps 2-{sz.steps}) {med * 1e3:.1f} ms, "
          f"{sz.batch * sz.seq / med:.0f} tokens/s, peak device memory {peak / 2**30:.2f} GiB")
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise AssertionError(f"train: a loss or gradient norm is not finite: {losses}, {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: step {sz.steps}'s loss {losses[-1]:.4f} is not below step "
                             f"1's {losses[0]:.4f}")
    return dict(sizes=sz, n_params=n_params, init_s=init_s, losses=losses, grad_norms=gnorms,
                step_s=step_s, median_step_s=med, tokens_per_s=sz.batch * sz.seq / med,
                peak_bytes=peak)


def _two_steps(cfg, state, dev, lr: float):
    """Two AdamW steps of a copy of ``state`` on ``dev``, on SyntheticLM
    batches: (losses, final state)."""
    step_fn = make_train_step(cfg, get_optimizer("adamw", lr))
    state = _state_to(state, dev)
    ds = SyntheticLM(cfg.vocab_size, 16, 2, seed=SEED)
    losses = []
    for _ in range(2):
        state, m = step_fn(state, ds.next_batch())
        losses.append(float(m["loss"]))
    return losses, state


def _train_parity(dev) -> List[TrainCheck]:
    """Step 18's first half."""
    checks = []
    for arch in TRAIN_CHECK_ARCHS:
        cfg = configs.get_smoke_config(arch)
        state0, _ = build(cfg, "adamw", TRAIN_CHECK_LR, seed=SEED, device="cpu")
        got, s_dev = _two_steps(cfg, state0, dev, TRAIN_CHECK_LR)
        want, s_cpu = _two_steps(cfg, state0, torch.device("cpu"), TRAIN_CHECK_LR)
        worst, past = _param_worst(s_dev["params"], s_cpu["params"], TRAIN_CHECK_LR, 2)
        n = sum(t.numel() for t in flatten(s_cpu["params"])[0])
        chk = TrainCheck(arch, got, want, worst, past, n)
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"train check {arch} (smoke, f32, 2 AdamW steps) on {dev} vs cpu: losses "
              f"{got} vs {want} (worst rel {rel:.3g}, tol {TRAIN_LOSS_RTOL}); params worst "
              f"{worst:.3g} of the bound, {past} of {n} elements past {TRAIN_PARAM_TOL} of "
              f"their leaf's largest magnitude alone")
        if not rel <= TRAIN_LOSS_RTOL or not worst <= 1.0:
            raise AssertionError(f"train check {arch}: the device parts from the CPU (loss rel "
                                 f"{rel:.3g}, params {worst:.3g} of the bound)")
        checks.append(chk)
    return checks


def _train_variants(dev) -> Dict[str, Dict[str, float]]:
    """Step 18's second half: one step of each other optimizer form."""
    cfg = configs.get_smoke_config(ARCH)
    out = {}
    for name, opt, gcomp in (("adamw8bit", "adamw8bit", None), ("adafactor", "adafactor", None),
                             ("adamw+int8", "adamw", "int8")):
        state, step_fn = build(cfg, opt, TRAIN_CHECK_LR, grad_compression=gcomp, seed=SEED,
                               device=dev)
        _, m = step_fn(state, SyntheticLM(cfg.vocab_size, 16, 2, seed=SEED).next_batch())
        out[name] = {k: float(v) for k, v in m.items()}
        print(f"train {name} (smoke): " + ", ".join(f"{k} {v:.4f}" for k, v in out[name].items()))
        if not all(math.isfinite(v) for v in out[name].values()):
            raise AssertionError(f"train {name}: a metric is not finite: {out[name]}")
    return out


def _train_resume(dev):
    """Step 19: (losses of the resumed steps 4-6, worst parameter
    difference over its bound, bitwise?)."""
    cfg = configs.get_smoke_config(ARCH)
    state0, step_fn = build(cfg, "adamw", TRAIN_CHECK_LR, seed=SEED, device=dev)
    data = lambda: SyntheticLM(cfg.vocab_size, 16, 2, seed=SEED)     # noqa: E731
    full = Trainer(_state_to(state0, dev), step_fn, data(),
                   TrainerConfig(total_steps=6, log_every=1))
    want = [h["loss"] for h in full.run()["history"]][3:]
    with tempfile.TemporaryDirectory() as d:
        Trainer(_state_to(state0, dev), step_fn, data(),
                TrainerConfig(total_steps=3, ckpt_dir=d, ckpt_every=3)).run()
        fresh, _ = build(cfg, "adamw", TRAIN_CHECK_LR, seed=SEED + 1, device=dev)
        tr = Trainer(fresh, step_fn, SyntheticLM(cfg.vocab_size, 16, 2, seed=SEED + 7),
                     TrainerConfig(total_steps=6, ckpt_dir=d, ckpt_every=3, log_every=1))
        res = tr.run()
    got = [h["loss"] for h in res["history"]]
    worst, _ = _param_worst(tr.state["params"], full.state["params"], TRAIN_CHECK_LR, 3)
    bitwise = got == want and all(torch.equal(a, b) for (_, a), (_, b)
                                  in zip(paths(tr.state), paths(full.state)))
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"train resume (smoke) on {dev}: checkpoint at step 3, a fresh Trainer resumed to step "
          f"{res['final_step']}; losses {got} vs one run's {want} (worst rel {rel:.3g}); "
          f"params worst {worst:.3g} of the bound; bitwise {bitwise}")
    if res["final_step"] != 6 or not rel <= TRAIN_LOSS_RTOL or not worst <= 1.0:
        raise AssertionError("train resume: the resumed run parts from the uninterrupted one")
    return got, worst, bitwise


def train(device="cuda", full: bool = True) -> TrainResult:
    """The training path (steps 17-19 of the module docstring)."""
    dev = resolve(device)
    launches0 = dict(cuda_lib.launches)
    full_run = _train_full(dev, full)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = _train_parity(dev)
    variants = _train_variants(dev)
    r_losses, r_worst, r_bitwise = _train_resume(dev)
    launches = {k: n - launches0[k] for k, n in cuda_lib.launches.items()}
    if any(launches.values()):
        raise AssertionError(f"train: the training path launched hand kernels {launches}")
    return TrainResult(device=str(dev), **full_run, launches=launches, checks=checks,
                       variants=variants, resume_losses=r_losses, resume_worst=r_worst,
                       resume_bitwise=r_bitwise)


# --- sharded training --------------------------------------------------------------------
FSDP_MESH = (2, 1)           # (data, model): two ranks, each state leaf halved on the data axis
FSDP_CKPT_MESH = (1, 2)      # the mesh a checkpoint written at FSDP_MESH restores onto
FSDP_STEPS = 4
# Step 21's bars against step 18's one-process run: step 1's loss is
# the same forward on the same params, its rows split over two ranks and
# the sums added (bf16 activations, so summation order alone); steps
# 2-4 follow updates whose gradients were reduced in bf16 across ranks.
FSDP_FIRST_RTOL = 2e-3
FSDP_LATER_RTOL = 2e-2
FSDP_PEAK_BYTES = 30 << 30   # a rank's peak (the one process: 41.06 GiB)
RING_VALUES = {True: 1 << 26, False: 1 << 12}
RING_MEDIAN_REL = 0.02       # the reference's bar (tests/test_sharding_dist.py)


@dataclasses.dataclass
class FsdpResult:
    device: str
    mesh: Tuple[int, int]
    sizes: TrainSizes
    n_params: int
    ranks: List[dict]          # per rank: its record (``_train_fsdp_rank``)
    want_losses: List[float]   # the one-process run's first FSDP_STEPS losses
    counted: Dict[str, Dict[str, float]]   # the dry-run's collectives at a rank's rows


def _fsdp_cfg(full: bool):
    return (configs.get_config(ARCH) if full else
            dataclasses.replace(configs.get_smoke_config(ARCH), remat=True, loss_chunk=8))


def _fsdp_full(dev, full: bool) -> dict:
    """Step 21's first part on this rank: the full-size FSDP run."""
    sz = TRAIN_FULL if full else TRAIN_SMOKE
    cfg = _fsdp_cfg(full)
    counter: Dict[str, Dict[str, float]] = {}
    ctx = train_context(make_local_mesh(FSDP_MESH[1], FSDP_MESH[0]), cfg, counter)
    opt = get_optimizer("adamw", cosine_warmup(TRAIN_PEAK_LR, sz.warmup, sz.steps))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = init_state(gen, cfg, opt, None, dev, mesh=ctx)
    _sync(dev)
    init_s = time.perf_counter() - t0
    state_bytes = sum(t.numel() * t.element_size() for t in flatten(state)[0])
    step_fn = make_train_step(cfg, opt, mesh=ctx)
    data = LearnableLM(cfg.vocab_size, sz.batch, sz.seq)
    losses, gnorms, step_s = [], [], []
    for _ in range(FSDP_STEPS):
        counter.clear()
        t0 = time.perf_counter()
        state, m = step_fn(state, data.next_batch())
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    return dict(init_s=init_s, state_bytes=state_bytes, losses=losses, grad_norms=gnorms,
                step_s=step_s, peak_bytes=peak,
                step_collectives=shd.counter_totals(counter))


def _whole_params(state, ctx, cfg, opt):
    """Every parameter leaf of a sharded state, gathered whole."""
    sh = shd.state_sharding_tree(state_shapes(cfg, opt), ctx)
    return shd.map_tree(lambda p, t: ctx.gather_block(t, shd.leaf_at(sh["params"], p).spec),
                        state["params"])


def _fsdp_smoke(dev, d: str) -> dict:
    """Step 21's second part on this rank: smoke-size qwen2.5-3b and
    deepseek-v3 steps at FSDP_MESH against the CPU's unsharded steps, and
    a checkpoint written at FSDP_MESH, restored at FSDP_CKPT_MESH with
    ``shardings=`` and continued."""
    out = {}
    opt = get_optimizer("adamw", TRAIN_CHECK_LR)
    for arch in (ARCH, MLA_ARCH):
        cfg = configs.get_smoke_config(arch)
        state0, _ = build(cfg, "adamw", TRAIN_CHECK_LR, seed=SEED, device="cpu")
        want, s_cpu = _two_steps(cfg, state0, torch.device("cpu"), TRAIN_CHECK_LR)
        ctx = train_context(make_local_mesh(FSDP_MESH[1], FSDP_MESH[0]), cfg)
        sh = shd.state_sharding_tree(state_shapes(cfg, opt), ctx)
        step_fn = make_train_step(cfg, opt, mesh=ctx)
        ds = SyntheticLM(cfg.vocab_size, 16, 2, seed=SEED)
        state = shard_state(_state_to(state0, dev), sh)
        got = []
        for i in range(2):
            state, m = step_fn(state, ds.next_batch())
            got.append(float(m["loss"]))
            if arch == ARCH and i == 0:
                checkpoint.save(os.path.join(d, "ckpt"), 1, state, shardings=sh)
        worst, past = _param_worst(_whole_params(state, ctx, cfg, opt), s_cpu["params"],
                                   TRAIN_CHECK_LR, 2)
        out[arch] = dict(losses=got, cpu_losses=want, worst=worst, past=past)
        if arch == ARCH:
            # Restored onto the other mesh, then the second step there.
            ctx2 = train_context(make_local_mesh(FSDP_CKPT_MESH[1], FSDP_CKPT_MESH[0]), cfg)
            sh2 = shd.state_sharding_tree(state_shapes(cfg, opt), ctx2)
            target = shd.map_tree(lambda p, t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                                  state_shapes(cfg, opt))
            state2, _, at = checkpoint.restore(os.path.join(d, "ckpt"), 1, target, shardings=sh2)
            ds = SyntheticLM(cfg.vocab_size, 16, 2, seed=SEED)
            ds.next_batch()
            state2, m = make_train_step(cfg, opt, mesh=ctx2)(state2, ds.next_batch())
            w2, _ = _param_worst(_whole_params(state2, ctx2, cfg, opt), s_cpu["params"],
                                 TRAIN_CHECK_LR, 2)
            out["resume"] = dict(step=at, loss=float(m["loss"]), cpu_loss=want[1], worst=w2)
    return out


def ring_emulation(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """``ring_allreduce_int8`` over len(xs) ranks, emulated in one process
    from the same ``quantize`` / ``dequantize``: each rank's result."""
    n, shape, size = len(xs), xs[0].shape, xs[0].numel()
    L = -(-size // n)
    accs = [torch.nn.functional.pad(x.reshape(-1), (0, n * L - size)).reshape(n, L).clone()
            for x in xs]

    def sent(chunk):
        return dequantize(*quantize(chunk), L)

    for s in range(n - 1):
        wire = [sent(accs[r][(r - s) % n]) for r in range(n)]
        for r in range(n):
            i = (r - s - 1) % n
            accs[r][i] = accs[r][i] + wire[(r - 1) % n]
    for s in range(n - 1):
        wire = [sent(accs[r][(r + 1 - s) % n]) for r in range(n)]
        for r in range(n):
            accs[r][(r - s) % n] = wire[(r - 1) % n]
    return [a.reshape(-1)[:size].reshape(shape) for a in accs]


def _fsdp_ring(dev, full: bool) -> dict:
    """Step 21's last part on this rank: ``mean_grads_int8`` of the ranks'
    f32 vectors (drawn from ``SEED`` + rank) against the exact mean and
    the host emulation."""
    n, r, size = dist.get_world_size(), dist.get_rank(), RING_VALUES[full]
    xs = []
    for i in range(n):
        g = torch.Generator("cpu")
        g.manual_seed(SEED + i)
        xs.append(torch.randn(size, generator=g))
    x = xs[r].to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    mean, err = mean_grads_int8({"g": x}, {"g": torch.zeros_like(x)})
    _sync(dev)
    seconds = time.perf_counter() - t0
    mean, err = mean["g"].cpu(), err["g"].cpu()
    want = torch.stack(xs).double().sum(0)
    rel = (mean.double() * n - want).abs() / want.abs().clamp_min(1e-3)
    emu = ring_emulation(xs)[r] / n
    q, s = quantize(xs[r])
    emu_err = xs[r] - dequantize(q, s, size)
    return dict(values=size, seconds=seconds, median_rel=float(rel.median()),
                bitwise=bool(torch.equal(mean, emu) and torch.equal(err, emu_err)),
                emu_gap=float(max((mean - emu).abs().max(), (err - emu_err).abs().max())),
                scale=float(want.abs().max() / n))


def _train_fsdp_rank(rank: int, world: int, init: str, device: str, full: bool,
                     out_dir: str) -> None:
    """One rank of ``train_fsdp`` (step 21): its record goes to
    ``out_dir/rank{rank}.json``; any failure raises."""
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device)
        launches0 = dict(cuda_lib.launches)
        rec = _fsdp_full(dev, full)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rec["smoke"] = _fsdp_smoke(dev, out_dir)
        rec["ring"] = _fsdp_ring(dev, full)
        rec["launches"] = {k: n - launches0[k] for k, n in cuda_lib.launches.items()}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _one_process_losses(dev, full: bool) -> List[float]:
    """Step 18's first FSDP_STEPS losses, run here (one process)."""
    sz = TRAIN_FULL if full else TRAIN_SMOKE
    cfg = _fsdp_cfg(full)
    state, step_fn = build(cfg, "adamw", cosine_warmup(TRAIN_PEAK_LR, sz.warmup, sz.steps),
                           seed=SEED, device=dev)
    data = LearnableLM(cfg.vocab_size, sz.batch, sz.seq)
    out = []
    for _ in range(FSDP_STEPS):
        state, m = step_fn(state, data.next_batch())
        out.append(float(m["loss"]))
    return out


def train_fsdp(device="cuda", full: bool = True,
               want_losses: Optional[List[float]] = None) -> FsdpResult:
    """Step 21: qwen2.5-3b trained as FSDP_MESH's two ranks (spawned gloo
    processes; on the card both on the card of their rank modulo the
    device count): each draws the full params from ``SEED``, keeps its
    blocks and frees the rest, then runs FSDP_STEPS AdamW steps of step
    18's stream and schedule; then the smoke-size checks and the ring.
    ``want_losses``: step 18's first FSDP_STEPS losses (run here, after
    the ranks, when not given).  Raises if a rank fails or a check
    misses."""
    dev = resolve(device)
    sz = TRAIN_FULL if full else TRAIN_SMOKE
    cfg = _fsdp_cfg(full)
    world = FSDP_MESH[0] * FSDP_MESH[1]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        procs = torch.multiprocessing.start_processes(
            _train_fsdp_rank, args=(world, "file://" + os.path.join(d, "store"), dev.type, full,
                                    d), nprocs=world, join=False, start_method="spawn")
        # The dry-run's count of a rank's step at its rows, on the host
        # while the ranks run.
        counted = dryrun.count_step(cfg, "train", sz.batch, sz.seq, "adamw",
                                    mesh={"data": FSDP_MESH[0], "model": FSDP_MESH[1]})
        while not procs.join():
            pass
        ranks = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    if want_losses is None:
        want_losses = _one_process_losses(dev, full)
    n_params = sum(t.numel() for t in flatten(state_shapes(cfg, get_optimizer(
        "adamw", 1e-3))["params"])[0])
    res = FsdpResult(device=str(dev), mesh=FSDP_MESH, sizes=sz, n_params=n_params, ranks=ranks,
                     want_losses=list(want_losses),
                     counted=counted["analysis"]["collectives"])
    _check_fsdp(res, full)
    return res


def _check_fsdp(res: FsdpResult, full: bool) -> None:
    r0 = res.ranks[0]
    losses, want = r0["losses"], res.want_losses[:FSDP_STEPS]
    for r, rec in enumerate(res.ranks):
        print(f"train_fsdp rank {r}: losses {rec['losses']}, grad norms {rec['grad_norms']}; "
              f"state blocks {rec['state_bytes'] / 2**30:.2f} GiB, peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB; steps "
              f"{[round(s, 3) for s in rec['step_s']]} s; a step's collectives "
              f"{rec['step_collectives']}")
        if rec["losses"] != losses or rec["grad_norms"] != r0["grad_norms"]:
            raise AssertionError(f"train_fsdp: rank {r}'s metrics differ from rank 0's")
        if any(rec["launches"].values()):
            raise AssertionError(f"train_fsdp rank {r} launched hand kernels {rec['launches']}")
        if full and not rec["peak_bytes"] < FSDP_PEAK_BYTES:
            raise AssertionError(f"train_fsdp rank {r}: peak {rec['peak_bytes'] / 2**30:.2f} GiB")
        if rec["step_collectives"] != res.counted:
            raise AssertionError(f"train_fsdp rank {r}: a step's collectives "
                                 f"{rec['step_collectives']}, counted {res.counted}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    print(f"train_fsdp: {ARCH} {res.n_params / 1e9:.3f} B params as {res.mesh} (data, model) "
          f"ranks; losses {losses} vs one process {want} (rel {[f'{x:.3g}' for x in rel]}, "
          f"bars {FSDP_FIRST_RTOL} then {FSDP_LATER_RTOL}); the dry-run counts "
          f"{res.counted} a rank a step")
    if not all(math.isfinite(v) for v in losses + r0["grad_norms"]):
        raise AssertionError(f"train_fsdp: a loss or norm is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_fsdp: step {FSDP_STEPS}'s loss is not below step 1's")
    if not rel[0] <= FSDP_FIRST_RTOL or not all(x <= FSDP_LATER_RTOL for x in rel[1:]):
        raise AssertionError(f"train_fsdp: losses {losses} part from one process's {want}")
    for r, rec in enumerate(res.ranks):
        for arch in (ARCH, MLA_ARCH):
            c = rec["smoke"][arch]
            lrel = max(abs(a - b) / abs(b) for a, b in zip(c["losses"], c["cpu_losses"]))
            print(f"train_fsdp smoke {arch} rank {r}: losses {c['losses']} vs the CPU's "
                  f"unsharded {c['cpu_losses']} (rel {lrel:.3g}); params worst "
                  f"{c['worst']:.3g} of the bound")
            if not lrel <= TRAIN_LOSS_RTOL or not c["worst"] <= 1.0:
                raise AssertionError(f"train_fsdp smoke {arch} rank {r} parts from the CPU")
        c = rec["smoke"]["resume"]
        lrel = abs(c["loss"] - c["cpu_loss"]) / abs(c["cpu_loss"])
        print(f"train_fsdp checkpoint rank {r}: written at {FSDP_MESH}, restored at "
              f"{FSDP_CKPT_MESH} (step {c['step']}), step 2 loss {c['loss']} vs uninterrupted "
              f"{c['cpu_loss']} (rel {lrel:.3g}); params worst {c['worst']:.3g} of the bound")
        if c["step"] != 1 or not lrel <= TRAIN_LOSS_RTOL or not c["worst"] <= 1.0:
            raise AssertionError(f"train_fsdp checkpoint rank {r}: the resumed run parts")
        g = rec["ring"]
        print(f"train_fsdp ring rank {r}: mean_grads_int8 of {g['values']} f32 values on "
              f"{len(res.ranks)} ranks in {g['seconds']:.3f} s; median rel error "
              f"{g['median_rel']:.4g} (bar {RING_MEDIAN_REL}); against the host emulation "
              f"bitwise {g['bitwise']}, worst gap {g['emu_gap']:.3g} (values ~{g['scale']:.3g})")
        if not g["median_rel"] < RING_MEDIAN_REL or not g["emu_gap"] <= 1e-6 * g["scale"]:
            raise AssertionError(f"train_fsdp ring rank {r}: {g}")
