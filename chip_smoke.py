#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card, and hold every
hand-written kernel on that path against its plain PyTorch version.

    python3 chip_smoke.py            # from the root of a checkout, one card

Steps, each of which raises on failure (the exit code is then non-zero
and no result line is printed):

  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  3. with every launch count set to 0, run ``repro_torch.smoke.run``: the
     16-scenario DSE at the default NSGA-II config with oracle coverage,
     then the island model over the same 16 scenarios
     (``run_islands_multi``: 4 islands each, pop 128, 4 rounds of 16
     generations, 8 migrants; K1 over 64 populations of parents and
     children), its seconds, its K1 launches counted apart (> 0) and each
     scenario's front size and coverage beside ``explore_multi``'s, no
     front point dominated by its scenario's oracle front;
     ``dcimmap.plan("qwen2.5-3b", ...)``, the best int8 and bf16 designs,
     the compiler's output for the best-EDP point of each of the 16
     scenarios' fronts found on the card (Verilog, DEF floorplan and
     report under ``build/codegen/``, each audited against the cost
     model; host text generation, no kernel), and every qwen2.5-3b GEMM
     class at full width through both designs; then read the counts:
     K1-K3 must each be > 0, every K3 launch must have taken K3's vector
     path, and all 16 designs must be there with their audits passed;
  4. with every launch count set to 0 again, run ``repro_torch.smoke.serve``:
     qwen2.5-3b at full width and depth (bf16, weights drawn on the card)
     served through ``Scheduler.serve`` on a shared-prefix trace of 8
     requests, each served sequence held to the ``Engine``'s
     teacher-forced logits; then the same model served under the int8
     design's macro numerics (``dcim_sim``), held the same way; then read
     the counts: K4, K5 and K2 must each be > 0;
  5. within the same call and on the same params, ``smoke.serve_tenants``
     (its launches counted apart): the multi-tenant front end.  A
     ``Scheduler(max_slots=4, max_len=1024, page_size=16,
     prefill_chunk=200, max_queue=7)`` session queues 4 batch requests
     (priority 1, the float trace's first 4, 48 tokens each) and 3
     interactive ones (priority 3, arriving at steps 6, 12 and 12, 16
     tokens each; the first a 700-token prompt that fills in 4 chunks at
     context lengths 0, 200, 400 and 600, off the 16-row page grid); a
     producer thread's 8th submission must shed; the pump thread
     (``session.driving()``) serves the trace while a consumer thread per
     tenant streams and waits.  The trace must preempt at least one batch
     request (first admitted at step 0) and resume it, fill at least 4
     chunks at those context lengths, deliver every callback on the pump
     thread, and stay within ``SERVE_DELTA`` of the ``Engine``; every K4
     and K5 launch of it must take the tensor-core kernel.  Then 2 batch
     requests through ``paged=False`` (monolithic cache, plain attention,
     no kernel), held the same way;
  6. with every launch count set to 0 again, run
     ``repro_torch.smoke.serve_ssm``: falcon-mamba-7b at full width and
     depth (64 Mamba-1 layers, bf16, weights drawn on the card) served on
     the same trace (K7 in every layer of every prefill; prefix reuse
     gated off, 0 hit tokens), held to the ``Engine`` running the
     associative scan; then 8 of its 64 layers served under the int8
     design; then read the counts: K7 and K2 must each be > 0, and every
     K7 launch of both SSM serves must have taken a bf16 u;
  7. with every launch count set to 0 again, run
     ``repro_torch.smoke.serve_mla``: deepseek-v3-671b at full width, 2
     of its 61 layers (MLA + drop-free MoE over 256 experts, bf16,
     24.9 B params drawn on the card) served on the same trace (K5 at
     the MLA shape with prefix hits, K6 in every layer of every decode
     step), held to the ``Engine``; then the same model under the int8
     design; then read the counts: K6, K5 and K2 must each be > 0, and
     every K5 launch of the qwen and deepseek serves (bf16) must have
     taken K5's tensor-core kernel, every K4 launch of the qwen serves
     K4's, and every K6 launch of the deepseek serves K6's split walk;
  8. with every launch count set to 0 again, run
     ``repro_torch.smoke.serve_music``: musicgen-large at full width and
     depth (48 layers, sinusoidal positions, 2.425 B params) served on
     the same trace at its 2048-token vocabulary (prefix hits: K5 over
     reused pages; K4 at one query head per KV head, hd 64), held to the
     ``Engine``; then under the int8 design; K4, K5 and K2 must each be
     > 0, every K4 and K5 launch on the tensor-core kernels, and some
     prompt tokens prefix hits;
  9. with every launch count set to 0 again, run
     ``repro_torch.smoke.serve_vlm``: qwen2-vl-72b at full width, 24 of
     its 80 layers (22.3 B params), fed a stub frontend's embeddings and
     text-image-text M-RoPE position ids through ``lm.prefill`` and 16
     ``lm.decode_step`` s, every step's logits held to a teacher-forced
     forward; then 4 of those layers under the bf16 design (K3 then K2 in
     every projection); K3 and K2 must each be > 0 and every K3 launch
     on its vector path;
  10. with every launch count set to 0 again, run
     ``repro_torch.smoke.serve_hybrid``: jamba-v0.1-52b at full width, 16
     of its 32 layers (14 Mamba-1, 2 GQA, 8 MoE FFNs of 16 experts;
     ~26.0 B params) served top-2 on the same trace, held to the
     ``Engine`` on the associative scan with the Engine on the experts
     the served path chose (the count of token-layers whose expert sets
     differ and the gap on the Engine's own routing printed beside); K7,
     K4 and K5 must each be > 0, prefix reuse gated off (0 hit tokens),
     every K4 and K5 launch on the tensor-core kernels and every K7
     launch with a bf16 u;
  11. with every launch count set to 0 again, run
     ``repro_torch.smoke.serve_moe``: moonshot-v1-16b-a3b at full width
     and depth (48 layers, 64 experts top-6, 28.05 B params) served on
     the same trace with prefix hits, held to the ``Engine``; K4 and K5
     must each be > 0, every launch on the tensor-core kernels;
  12. ``repro_torch.smoke.serve_tp``: two processes on the one card over
     a gloo group.  First step 3's island run over them as a (scenario,
     island) = (1, 2) mesh (``run_islands_multi(mesh=)``: the 16
     scenarios, 2 of each scenario's 4 islands a rank, the migrants
     gathered around the ring): both ranks' results bitwise step 3's
     one-process results for every scenario, K1 launched on each rank,
     the seconds printed as two time-sliced ranks.  Then qwen2.5-3b at
     full width and depth served at tp = 2 (each rank draws the full
     params from the seed, keeps its shards and runs
     ``Scheduler(tp=2)``): step 4's float trace and its 2 int8 DCIM
     requests on step 3's best-EDP int8 design, both ranks calling
     ``serve()``; then step 5's two-tenant trace through the pumps, led
     by rank 0 (it queues before ``start()``, its producer thread's
     submission sheds, its consumer threads stream under ``driving()``;
     rank 1's pump follows the tick messages).  Every served token
     within ``SERVE_DELTA`` / ``DCIM_DELTA`` of the tp=1 ``Engine``'s
     teacher-forced logits, both ranks' tokens equal, the tenant trace's
     schedule (preemptions, chunks, shed, each request's admitted and
     finished step) equal on both ranks and to step 5's, on each rank
     every K4/K5 launch on the tensor-core kernels and K2 launched (at
     the rank-local shapes: 8 q heads over 1 kv head, N = 11008/2 and
     151936/2); the share of tokens equal to step 4's tp=1 serve, the
     decode step medians and each tenant request's first and last
     delivery printed beside the card's name and power limit, as two
     time-sliced ranks on one card, not a speed.  A rank's failure
     fails the script;
  13. with every launch count set to 0 again, run ``repro_torch.smoke.train``:
     qwen2.5-3b at full width and depth (36 layers, 3.397 B params, bf16
     params and compute, remat, the loss in chunks of 512 positions)
     trained by the port's ``Trainer`` for 8 AdamW steps of 4 x 1024
     tokens on a learnable stream, lr ``cosine_warmup(3e-4, 2, 8)``,
     clipped at norm 1; each step's loss and gradient norm, the median
     step time of steps 2-8, tokens/s and the peak device memory printed
     beside the card's name and power limit; every loss and norm finite
     and step 8's loss below step 1's.  Then qwen2.5-3b, deepseek-v3 and
     falcon-mamba at their smoke configs in float32, two AdamW steps on
     the card and on the CPU from one state (losses within 1e-5
     relative, parameters within 1e-4 of their leaf's largest magnitude
     plus 0.05 lr a step); one step each of 8-bit AdamW, Adafactor and
     int8 gradient compression, finite; a crash and resume through a
     checkpoint in a temporary directory, held to an uninterrupted run.
     Training runs no hand-written kernel (the reference's reaches no
     Pallas kernel): every launch count must still be 0 after it.  Then
     ``repro_torch.launch.dryrun`` counts the step it timed on fake
     tensors (on the host): its matmul FLOPs, which must lie within
     ``TRAIN_FLOPS_BOUNDS``, and bytes, printed beside the analytic
     ``model_flops``, the share of the bf16 peak the median step reached
     (counted FLOPs / (median step x peak)) and the card's name and power
     limit.  Then ``repro_torch.smoke.train_fsdp``: the same model at full
     width and depth trained as two FSDP ranks, two gloo processes on
     the one card over a ("data", "model") = (2, 1) mesh (each draws the
     full params from the seed, keeps its blocks of every parameter and
     optimizer leaf and frees the rest; a layer group's weights are
     gathered whole where the group runs), 4 AdamW steps of step 13's
     4 x 1024 tokens (2 x 1024 a rank) and schedule.  Both ranks' losses
     equal; step 1's loss within 2e-3 relative of step 13's step 1 and
     steps 2-4 within 2e-2 of step 13's; finite, step 4 below step 1;
     each rank's peak below 30 GiB; a step's all-gather and reduction
     bytes equal to ``launch.dryrun``'s count of a rank at those rows;
     no hand-kernel launch.  Then, on the same two ranks: the sharded
     smoke-size qwen2.5-3b and deepseek-v3 steps against the CPU's
     unsharded steps (step 13's bars); a checkpoint written at (2, 1),
     restored with ``shardings=`` at (1, 2) and continued, held to the
     uninterrupted run; ``mean_grads_int8`` on the ranks' 2^26-value f32
     vectors against the exact mean (median relative error under 0.02)
     and the host emulation, its seconds printed.  Every number beside
     the card's name and power limit; a rank's failure fails the script;
  14. serve each float trace of steps 4, 6 and 7 once more, warm, under ``torch.profiler``,
     and print the device-busy share of the host time and the device
     time by kernel family (K4, K5, K6, K7, the MoE's expert GEMMs, the
     other GEMMs, copies, the rest); then one warm step of step 13's
     training under it, its device time split into forward and backward,
     and optimizer, each into GEMMs and the rest;
  15. at the main paths' shapes, compare each kernel with its plain
     version on the card (K1-K3 bitwise, K4/K5 within ATTN_TOL at the
     shapes of each GQA serve: qwen2.5-3b, musicgen, jamba, moonshot, and
     one rank's of step 12's tp=2 serve, 8 q heads over 1 kv head; K6
     within MLA_TOL, K7 within SCAN_TOL) and time both with CUDA
     events, beside the card's bound and, where one exists, a single
     PyTorch call that computes the same function; K1, K4 and its library
     call, K6 and its library call, and K7, by replaying a captured CUDA
     graph of many calls (the events time printed beside it; K1 also at
     the DSE's pool shape, at the island run's (64, 256, 4) and at one
     rank's of step 12's, (32, 256, 4), beside an
     empty kernel's time, the launch floor); K3 also at the online operand x; K6 also
     with one split a slot against all splits; K7 with a bf16 u (the
     serve's types) and all in float32; K5 also at the MLA serve's
     shapes (with SDPA beside it); K2 also at the DCIM serves' decode
     shape, at a narrow one that splits K and at step 12's rank-local
     column shards, N = 11008/2 and 151936/2 (device time by the
     profiler);
  16. ``repro_torch.smoke.serve_moved`` in a fresh interpreter:
     qwen2.5-3b at full width and depth (36 layers, 3.397 B params) drawn
     by ``lm.init`` on the CPU and moved to the card with ``.to``, so that
     nothing resolved the card before; cuBLAS's bf16/f16 reduced-precision
     reduction flags must be on (torch's default) until ``Scheduler(...)``
     and off after it; 2 greedy requests of step 4's trace served (K4 and
     K5 > 0) and held to the ``Engine`` within ``SERVE_DELTA`` (0.25 in
     bf16); its seconds printed beside the card's name and power limit;
  17. the port's five examples (``examples/torch_*.py``), each through its
     ``main(["--device", "cuda", ...])`` in this process at its own
     settings (``torch_train_lm`` at ``--steps 30``), in a temporary
     working directory, with every launch count set to 0 just before it
     and read just after: quickstart must launch ``dominance``,
     dcim_for_llm ``dominance`` and ``dcim_mvm``, serve_lm
     ``paged_decode_gqa`` and ``prefix_prefill`` (its float32 compute and
     cache: their CUDA-core kernels), distributed_dse ``dominance`` on
     each of its two gloo ranks, and train_lm no hand kernel; each
     example's own results checked (the winner's audit, prefix hits and a
     warm trace that compiles nothing, finite losses, oracle coverage);
     each example's seconds and launches, and the step's total, printed
     beside the card's name and power limit;
  18. the contract lint on the card: ``repro_torch.analysis.lint.run_lint``
     over all eight contracts on ``cuda`` (the two multi-rank ones,
     ``serve.scheduler_tp`` and ``dist.train_dp``, as two gloo ranks
     time-sliced on the one card, as steps 12-13 run): zero ``error``
     findings; ``kernels.cuda`` must report all seven launch keys moved
     and every output covered; ``serve.scheduler`` and
     ``train.train_step`` must report their host syncs and the warnings
     of ``torch.cuda.set_sync_debug_mode("warn")``; the step's wall time
     must stay within ``BUDGET_FACTOR`` (2) times the committed ``cuda``
     baseline (``src/repro_torch/analysis/lint_budget.json``); each
     contract's seconds and the summary printed beside the card's name
     and power limit;
  19. print the codegen host seconds beside the card's name and power
     limit, the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
     line last.

It imports neither ``jax`` nor the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# The H100 SXM's published peaks, written once in the port's roofline.
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S, SFU_EXP_PER_S, TF32_OPS_PER_S,
)

# Step 13's counted FLOPs for one qwen2.5-3b train step (4 x 1024 tokens,
# remat, loss chunks of 512), stated before the count first ran on the
# card's host.  By hand: 6 x 3.086 B matmul params x 4096 tokens (7.58e13),
# remat's second forward of the blocks (2 x 2.775 B x 4096, 2.27e13), the
# loss chunks' second head forward (2 x 0.311 B x 4096, 0.25e13) and the
# attention's QK^T and PV over full 1024-key blocks in the forward, the
# second forward and the backward (~0.5e13): ~1.06e14.  The bounds allow
# +-10% around 1.0e14 for what the hand count leaves out or counts twice.
TRAIN_FLOPS_BOUNDS = (0.9e14, 1.1e14)
# Each kernel's bar against its plain version, written once in the port
# (``kernels.ops``: ATTN_TOL for K4/K5 on bf16 operands, SCAN_TOL for K7,
# MLA_TOL for K6; the contract lint holds the kernels to the same).
from repro_torch.kernels.ops import ATTN_TOL, MLA_TOL, SCAN_TOL  # noqa: E402
LINT_CONTRACTS = ("dist.train_dp", "kernels.cuda", "lm.prefill_paged", "nsga2.run_batched",
                  "serve.scheduler", "serve.scheduler_tp", "sim.dcim_serve", "train.train_step")
LINT_KEYS = ("dominance", "dcim_mvm", "fp_prealign", "selective_scan", "paged_decode_gqa",
             "prefix_prefill", "paged_decode_mla")
SERVE_KERNELS = ("paged_decode_gqa", "prefix_prefill", "dcim_mvm")
SSM_SERVE_KERNELS = ("selective_scan", "dcim_mvm")
MLA_SERVE_KERNELS = ("paged_decode_mla", "prefix_prefill", "dcim_mvm")
MUSIC_SERVE_KERNELS = ("paged_decode_gqa", "prefix_prefill", "dcim_mvm")
VLM_KERNELS = ("fp_prealign", "dcim_mvm")
HYBRID_SERVE_KERNELS = ("selective_scan", "paged_decode_gqa", "prefix_prefill")
MOE_SERVE_KERNELS = ("paged_decode_gqa", "prefix_prefill")
# Step 17: each example's extra arguments and the kernels it must launch
# (distributed_dse's on each of its ranks; train_lm none).
EXAMPLES = (("quickstart", (), ("dominance",)),
            ("dcim_for_llm", (), ("dominance", "dcim_mvm")),
            ("serve_lm", (), ("paged_decode_gqa", "prefix_prefill")),
            ("train_lm", ("--steps", "30"), ()),
            ("distributed_dse", (), ()))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up,
    by CUDA events around the batch of runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of ``fn`` per call: ``reps`` calls captured in one CUDA
    graph and replayed between CUDA events, after a warm-up call outside
    the capture (it sets a kernel's shared-memory attribute).  The replay
    launches no Python, so this times calls shorter than their host
    overhead, where events around a batch of calls would time the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / reps


def device_by_kernel(fn, reps: int) -> dict:
    """Device time of ``fn`` per run by kernel (and memset) name, in ms,
    summed by ``torch.profiler`` over ``reps`` runs after one warm-up;
    empty where the profiler recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-3 / reps
    return {k: v for k, v in by_name.items() if v > 0}


def device_ms(fn, reps: int) -> str:
    """Device time of ``fn`` (its kernels and memsets) per run, by
    ``device_by_kernel``, as text: for calls shorter than their host
    overhead, where CUDA events around a batch would time the host.  Late
    in a long process the profiler at times records no device activity:
    the measurement is then tried once more and otherwise reported as
    not measured (these times are printed, not checked)."""
    for _ in range(2):
        ms = sum(device_by_kernel(fn, reps).values())
        if ms > 0:
            return f"{ms:.4f} ms"
    return "not measured (the profiler recorded no device activity)"


def bound(nbytes: float, ops: float, ops_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want) -> float:
    import torch

    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    if not same:
        raise AssertionError(f"{name}: kernel differs from its plain version (max |diff| {err})")
    return err


def compare_close(name, got, want, tol) -> float:
    """max |got - want|; raises unless got is finite and within
    atol = rtol = tol of want everywhere."""
    import torch

    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    if not bool(torch.isfinite(got).all()) or bool((diff > tol + tol * want.double().abs()).any()):
        raise AssertionError(f"{name}: kernel differs from its plain version by {err} "
                             f"(> atol = rtol = {tol})")
    return err


def prefix_mask(ctx, L: int, T: int):
    """K5's mask for the library call: (B, 1, T, L + T) bool, context
    column j live where j < ctx[b], tail column c where c <= t."""
    import torch

    B, dev = ctx.shape[0], ctx.device
    tt = torch.arange(T, device=dev)
    return torch.cat([(torch.arange(L, device=dev)[None, :] < ctx[:, None])[:, None, :].expand(B, T, L),
                      (tt[None, :] <= tt[:, None])[None].expand(B, T, T)], dim=-1)[:, None]


def check_attention(serves, dev) -> list:
    """K4 and K5 at each GQA serve's shapes.  ``serves`` holds (arch,
    its ``ServeResult``, launches, tp), qwen2.5-3b's first with the whole
    run's counts, the others with their phase's; at tp > 1 the heads are
    one rank's (its q heads over the kv heads it attends) and the launches
    rank 0's, at the tp=1 serve's positions and bursts, which the tp
    serve shares (``check_serve_tp`` holds its schedule).  K4 runs at the decode
    step of the trace's slots over the pool's pages with the served
    requests' last positions, K5 at the widest burst the trace ran, over
    the slots' full gathered context where the serve reused prefixes
    (none where it did not).  Each is compared with its plain version
    within ATTN_TOL (raises otherwise) and timed beside its library call;
    the first serve's two rows go into the ``kernels`` line, every
    shape's is printed."""
    rows = []
    for i, (arch, sres, launches, tp) in enumerate(serves):
        got = attention_at(arch, sres, launches, dev, tp)
        at = arch if tp == 1 else f"{arch} tp={tp} rank"
        for r in got:
            print(f"check {r['name']} at {at} {r['shape']}: max|diff| {r['max_abs_err']:.3g} "
                  f"(tol {ATTN_TOL}), launches {r['launches']}, {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by {r['bound_by']}, "
                  f"library {r['library_ms']:.4f} ms){r.get('note', '')}")
        if i == 0:
            rows = got
    return rows


def attention_at(arch, sres, launches, dev, tp: int = 1) -> list:
    """``check_attention``'s two rows at one serve's shapes, one rank's
    heads of ``tp``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import decode_split, paged_decode_gqa, prefix_prefill

    cfg = configs.get_config(arch)
    sz = sres.sizes
    fl = sres.float_serve
    # A rank's kv heads: its share, or the one its q heads attend where
    # the kv heads replicate (``attention._kv_for_q``).
    H, Hk, hd = cfg.n_heads // tp, (cfg.n_kv // tp if cfg.n_kv % tp == 0 else 1), cfg.hd
    G = H // Hk
    nb = sz.max_len // sz.page_size
    n_pages = sz.max_slots * nb + 1
    rng = np.random.default_rng(2)
    bf = torch.bfloat16

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, bf)

    def expand(x):               # (B, S, Hk, d) -> (B, H, S, d), for the library call
        return x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()

    rows = []
    # K4: the decode step, with each slot at its request's last position.
    B = sz.max_slots
    last = fl.results[-B:]
    pos_np = np.asarray([r.prompt_len + r.generated.size - 2 for r in last], np.int32)
    bt_np = rng.permutation(np.arange(1, n_pages))[:B * nb].reshape(B, nb).astype(np.int32)
    q, kp, vp = rand(B, 1, H, hd), rand(n_pages, sz.page_size, Hk, hd), rand(n_pages, sz.page_size, Hk, hd)
    bt, pos = torch.from_numpy(bt_np).to(dev), torch.from_numpy(pos_np).to(dev)
    err = compare_close("paged_decode_gqa", paged_decode_gqa(q, kp, vp, bt, pos),
                        ref.paged_decode_gqa_ref(q, kp, vp, bt, pos), ATTN_TOL)
    keys = int((pos_np + 1).sum())
    b_ms, b_by = bound(2 * B * H * hd + 2 * keys * Hk * 2 * hd + 4 * B * nb + 4 * B
                       + 4 * B * H * hd, 2 * keys * H * 2 * hd, BF16_OPS_PER_S)
    kg, vg = expand(ref.gather_pages(kp, bt)), expand(ref.gather_pages(vp, bt))
    qs = q.transpose(1, 2).contiguous()
    mask = (torch.arange(nb * sz.page_size, device=dev)[None, :] <= pos[:, None])[:, None, None]
    k4 = lambda: paged_decode_gqa(q, kp, vp, bt, pos)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)  # noqa: E731
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pps = decode_split(B, Hk, G, sz.page_size, nb, sms)
    kps = pps * sz.page_size
    live = int((pos_np // kps + 1).sum())        # live splits over the slots
    by_kernel = device_by_kernel(k4, 50)         # the split walk and the merge
    walk = sum(v for k, v in by_kernel.items() if "gqa_mma" in k)
    merge = sum(v for k, v in by_kernel.items() if "gqa_merge" in k)
    rows.append(dict(
        name="paged_decode_gqa", route="cuda", source="src/repro_torch/csrc/paged_decode_gqa.cu",
        replaces="src/repro/kernels/paged_attention.py:69", launches=launches["paged_decode_gqa"],
        max_abs_err=err, ms=graph_ms(k4, 200),
        plain_ms=time_ms(lambda: ref.paged_decode_gqa_ref(q, kp, vp, bt, pos), 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=graph_ms(sdpa, 200),
        shape=f"q {tuple(q.shape)} bf16, pages {tuple(kp.shape)} bf16, bt {tuple(bt.shape)}, "
              f"pos {pos_np.tolist()}",
        note=f"; ms and library by CUDA graph replay; CUDA events around 200 calls: "
             f"{time_ms(k4, 200):.4f} ms, library {time_ms(sdpa, 200):.4f} ms; "
             f"{-(-nb // pps)} splits of {kps} keys a slot, {live * Hk * -(-G // 16)} live "
             f"CTAs, {live * H * (hd + 2) * 4 / 1e6:.3f} MB of partials (written, then read); "
             + (f"by the profiler: split walk {walk:.5f} ms, merge {merge:.5f} ms" if by_kernel
                else "the profiler recorded no device activity"),
    ))

    # K5: the widest burst of the trace, over the slots' full gathered
    # context, or none where the serve gated prefix reuse off (L = 0).
    Bw, T, _ = max(fl.stats.prefill_s, key=lambda p: p[0] * p[1])
    L = nb * sz.page_size if fl.stats.prefix_reuse_active else 0
    ctx_np = np.zeros(Bw, np.int32)
    hits = [r.prefix_hit_tokens for r in fl.results if r.prefix_hit_tokens][-Bw:]
    ctx_np[:len(hits)] = hits
    q = rand(Bw, T, H, hd)
    kc, vc, kt, vt = rand(Bw, L, Hk, hd), rand(Bw, L, Hk, hd), rand(Bw, T, Hk, hd), rand(Bw, T, Hk, hd)
    if not L:
        kc = vc = None
    ctx = torch.from_numpy(ctx_np).to(dev)
    err = compare_close("prefix_prefill", prefix_prefill(q, kc, vc, kt, vt, ctx),
                        ref.prefix_prefill_ref(q, kc, vc, kt, vt, ctx), ATTN_TOL)
    pairs = int(T * ctx_np.sum()) + Bw * T * (T + 1) // 2
    b_ms, b_by = bound(2 * Bw * T * H * hd + 2 * int(ctx_np.sum()) * Hk * 2 * hd
                       + 2 * Bw * T * Hk * 2 * hd + 4 * Bw + 4 * Bw * T * H * hd,
                       2 * pairs * H * 2 * hd, BF16_OPS_PER_S)
    ka, va = (expand(kt), expand(vt)) if kc is None else (
        expand(torch.cat([kc, kt], dim=1)), expand(torch.cat([vc, vt], dim=1)))
    qs = q.transpose(1, 2).contiguous()
    mask = prefix_mask(ctx, L, T)
    rows.append(dict(
        name="prefix_prefill", route="cuda", source="src/repro_torch/csrc/prefix_prefill.cu",
        replaces="src/repro/kernels/paged_attention.py:226", launches=launches["prefix_prefill"],
        max_abs_err=err, ms=time_ms(lambda: prefix_prefill(q, kc, vc, kt, vt, ctx), 50),
        plain_ms=time_ms(lambda: ref.prefix_prefill_ref(q, kc, vc, kt, vt, ctx), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ka, va, attn_mask=mask), 50),
        shape=f"q {tuple(q.shape)} bf16, ctx {(Bw, L, Hk, hd)} bf16, ctx_len {ctx_np.tolist()}",
    ))
    return rows


def mla_mmas(pos, r: int, dr: int, H: int, kps: int, tk: int, qr_planes: int) -> int:
    """The m16n8k16 MMAs K6's split walk issues for slots at ``pos``,
    counted as its loops skip them (``csrc/paged_decode_mla.cu``): per
    16-head CTA and tile of n live keys, a warp's scores over 8 NT keys
    when its first is live (3 planes over c_kv, ``qr_planes`` over
    k_rope), and PV over each 16-key step with a live key, 3 planes and 2
    n-tiles a 16-column chunk of the warp's DV columns below r."""
    nt = 2 if tk == 64 else 1
    dv = 64 if r <= 256 else (128 if r <= 512 else 256)
    rp16, dr16 = -(-r // 16) * 16, -(-dr // 16) * 16
    chunks = sum(1 for w in range(4) for c in range(0, dv, 16) if w * dv + c < rp16)
    per_score_warp = (rp16 // 16 * 3 + dr16 // 16 * qr_planes) * nt
    total = 0
    for p in pos:
        last = int(p)
        for k_lo in range(0, last + 1, kps):
            k_end = min(k_lo + kps, last + 1)
            for t0 in range(k_lo, k_end, tk):
                n = min(tk, k_end - t0)
                total += sum(per_score_warp for w in range(4) if w * 8 * nt < n)
                total += sum(chunks * 2 * 3 for kp in range(tk // 16) if kp * 16 < n)
    return total * -(-H // 16)


def check_mla(mres, launches, dev) -> list:
    """K6 at the MLA float serve's decode step: 4 slots over 257 pages
    of 16 rows (r 512, dr 64, 128 heads) with the served requests' last
    positions, q_abs of the model's scale (~0.5); and K5 at the MLA
    serve's prefill shapes (hd 192, hdv 128, one query head per KV head):
    a (4 x 256) tail over a 1024-row gathered context with ctx_len 256
    (the shared prefix), and a (4 x 512) burst without context."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (mla_decode_plan, mla_decode_split,
                                                     paged_decode_mla, prefix_prefill)
    from repro_torch.smoke import MLA_ARCH

    cfg = configs.get_config(MLA_ARCH)
    m = cfg.mla
    sz = mres.sizes
    H, r, dr = cfg.n_heads, m.kv_lora_rank, m.qk_rope_dim
    nb = sz.max_len // sz.page_size
    n_pages = sz.max_slots * nb + 1
    rng = np.random.default_rng(4)
    bf = torch.bfloat16

    def rand(*shape, dtype=bf, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev, dtype)

    B = sz.max_slots
    last = mres.float_serve.results[-B:]
    pos_np = np.asarray([r_.prompt_len + r_.generated.size - 2 for r_ in last], np.int32)
    bt_np = rng.permutation(np.arange(1, n_pages))[:B * nb].reshape(B, nb).astype(np.int32)
    qa, qr = rand(B, 1, H, r, dtype=torch.float32, scale=0.5), rand(B, 1, H, dr)
    cp, rp = rand(n_pages, sz.page_size, r), rand(n_pages, sz.page_size, dr)
    bt, pos = torch.from_numpy(bt_np).to(dev), torch.from_numpy(pos_np).to(dev)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    args = (qa, qr, cp, rp, bt, pos, scale)
    err = compare_close("paged_decode_mla", paged_decode_mla(*args),
                        ref.paged_decode_mla_ref(*args), MLA_TOL)
    keys = int((pos_np + 1).sum())
    nbytes = (4 * B * H * r + 2 * B * H * dr + 2 * keys * (r + dr) + 4 * B * nb + 4 * B
              + 4 * B * H * r)
    ops = 2 * keys * H * (2 * r + dr)
    # The function's operations at the TF32 tensor-core rate (the pages are
    # bf16, exact in TF32); bytes bound it all the same.  The kernel runs
    # its products as exact bf16 planes: their time at the bf16 peak is
    # printed beside it.
    b_ms, b_by = bound(nbytes, ops, TF32_OPS_PER_S)
    S = nb * sz.page_size
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tk, stages, smem = mla_decode_plan(r, dr)
    kps = mla_decode_split(B, H, r, dr, sz.page_size, nb, sms) * sz.page_size
    groups = -(-H // 16)
    ctas = -(-S // kps) * B * groups
    live = int((pos_np // kps + 1).sum()) * groups
    mmas = mla_mmas(pos_np, r, dr, H, kps, tk, qr_planes=1)
    cg, rg = ref.gather_pages(cp, bt).float(), ref.gather_pages(rp, bt).float()
    q_cat = torch.cat([qa, qr.float()], dim=-1).transpose(1, 2)           # (B, H, 1, r + dr)
    k_cat = torch.cat([cg, rg], dim=-1)[:, None].expand(B, H, S, r + dr)
    v_all = cg[:, None].expand(B, H, S, r)
    mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None])[:, None, None]
    k6 = lambda: paged_decode_mla(*args)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q_cat, k_cat, v_all, attn_mask=mask, scale=scale)
    by_kernel = device_by_kernel(k6, 50)         # the split walk and the merge
    walk = sum(v for k, v in by_kernel.items() if "mla_mma" in k)
    merge = sum(v for k, v in by_kernel.items() if "mla_merge" in k)
    rows = [dict(
        name="paged_decode_mla", route="cuda", source="src/repro_torch/csrc/paged_decode_mla.cu",
        replaces="src/repro/kernels/paged_attention.py:144", launches=launches["paged_decode_mla"],
        max_abs_err=err, ms=graph_ms(k6, 200),
        plain_ms=time_ms(lambda: ref.paged_decode_mla_ref(*args), 50),
        bound_ms=b_ms, bound_by=b_by, library_ms=graph_ms(sdpa, 200),
        shape=f"q_abs {tuple(qa.shape)} f32, q_rope bf16, pages {tuple(cp.shape)} / "
              f"{tuple(rp.shape)} bf16, pos {pos_np.tolist()}",
        note=f"; ms and library by CUDA graph replay; CUDA events around 200 calls: "
             f"{time_ms(k6, 200):.4f} ms, library {time_ms(sdpa, 200):.4f} ms; "
             f"{-(-S // kps)} splits of {kps} keys a slot, {ctas} CTAs ({live} live) of "
             f"{smem} bytes of shared memory, {tk}-key tiles in {stages} stages; {mmas} bf16 "
             f"MMAs (m16n8k16) take {mmas * 4096 / BF16_OPS_PER_S * 1e3:.5f} ms at the bf16 "
             f"peak (the function's {ops / 1e9:.3f} GFLOP as {mmas * 4096 / 1e9:.3f}); "
             + (f"by the profiler: split walk {walk:.5f} ms, merge {merge:.5f} ms" if by_kernel
                else "the profiler recorded no device activity"),
    )]
    r0 = rows[0]
    print(f"check {r0['name']} {r0['shape']}: max|diff| {err:.3g} (tol {MLA_TOL}), launches "
          f"{r0['launches']} ({launches['paged_decode_mla_mma']} on the split walk), "
          f"{r0['ms']:.4f} ms (plain {r0['plain_ms']:.4f} ms, bound {b_ms:.5f} ms by {b_by}, "
          f"library {r0['library_ms']:.4f} ms){r0['note']}")
    # The cost of the splits: every slot at the last key of its first split
    # (one split a slot) against every slot at its last key (all splits).
    edge = []
    for p in (kps - 1, S - 1):
        at = torch.full_like(pos, p)
        edge.append(graph_ms(lambda: paged_decode_mla(qa, qr, cp, rp, bt, at, scale), 200))
    print(f"check paged_decode_mla per split (graph replay): {edge[0]:.4f} ms at 1 split a slot "
          f"({B * groups} CTAs live), {edge[1]:.4f} ms at {-(-S // kps)} splits a slot "
          f"({ctas} CTAs live)")

    # K5 at the MLA prefill shapes (printed; the kernels line keeps qwen's K5 row).
    hd, hdv = m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
    for T, L, ctx_len in ((256, S, min(sz.prefix, S)), (512, 0, 0)):
        q = rand(B, T, H, hd)
        kt, vt = rand(B, T, H, hd), rand(B, T, H, hdv)
        kc, vc = (rand(B, L, H, hd), rand(B, L, H, hdv)) if L else (None, None)
        ctx = torch.full((B,), ctx_len, dtype=torch.int32, device=dev)
        kw = (q, kc, vc, kt, vt, ctx)
        err = compare_close("prefix_prefill (MLA shape)", prefix_prefill(*kw),
                            ref.prefix_prefill_ref(*kw), ATTN_TOL)
        pairs = B * T * ctx_len + B * T * (T + 1) // 2
        kb, kb_by = bound(2 * B * T * H * hd + 2 * B * ctx_len * H * (hd + hdv)
                          + 2 * B * T * H * (hd + hdv) + 4 * B + 4 * B * T * H * hdv,
                          2 * pairs * H * (hd + hdv), BF16_OPS_PER_S)
        ms = time_ms(lambda: prefix_prefill(*kw), 20)
        plain = time_ms(lambda: ref.prefix_prefill_ref(*kw), 5)
        # The library call on the same inputs (one query head per KV head).
        ka = torch.cat([kc, kt], dim=1) if L else kt
        va = torch.cat([vc, vt], dim=1) if L else vt
        qs, ka, va = (x.transpose(1, 2).contiguous() for x in (q, ka, va))
        mask = prefix_mask(ctx, L, T)
        lib = time_ms(lambda: F.scaled_dot_product_attention(qs, ka, va, attn_mask=mask), 20)
        print(f"check prefix_prefill at the MLA shape q {tuple(q.shape)} bf16, hdv {hdv}, "
              f"context {L} rows (ctx_len {ctx_len}): max|diff| {err:.3g} (tol {ATTN_TOL}), "
              f"{ms:.4f} ms (plain {plain:.4f} ms, bound {kb:.5f} ms by {kb_by}, "
              f"library {lib:.4f} ms)")
    return rows


def _family(name: str) -> str:
    low = name.lower()
    for kernel, fam in (("paged_decode_gqa", "paged_decode_gqa (K4)"),
                        ("prefix_prefill", "prefix_prefill (K5)"),
                        ("paged_decode_mla", "paged_decode_mla (K6)"),
                        ("selective_scan", "selective_scan (K7)")):
        if kernel in low:
            return fam
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "GEMM"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other kernels"


def _range_kernels(events, name: str):
    """(name, us) of every device kernel launched inside a ``name`` range
    (``record_function``), through the profiler's links from the CPU ops
    to their kernels."""
    out = []

    def walk(e):
        out.extend((k.name, k.duration) for k in e.kernels)
        for c in e.cpu_children:
            walk(c)

    for e in events:
        if e.name == name:
            walk(e)
    return out


def profile_float_serve(dev, arch: str, sz, **overrides) -> dict:
    """Where a float serve's time goes: the same model (the same seed,
    ``configs.get_config(arch, **overrides)``) serves the same trace
    again, warm, under ``torch.profiler``; the device time of every
    kernel and copy is summed by family and set against the host clock
    around ``Scheduler.serve``.  Kernels inside the MoE's ``moe_experts``
    range count as "MoE GEMM" (the expert products) or "MoE other"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs, smoke
    from repro_torch.models import lm
    from repro_torch.serve import Scheduler

    gc.collect()        # the last phase's model, held in a Scheduler/session cycle
    cfg = configs.get_config(arch, **overrides)
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED)
    params = lm.init(cfg, gen, dev)
    sched = Scheduler(cfg, params, max_slots=sz.max_slots, max_len=sz.max_len,
                      page_size=sz.page_size, seed=smoke.SEED)
    reqs = smoke.serve_trace(sz, cfg.vocab_size)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.serve(reqs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    families = {"paged_decode_gqa (K4)": 0.0, "prefix_prefill (K5)": 0.0,
                "paged_decode_mla (K6)": 0.0, "selective_scan (K7)": 0.0, "MoE GEMM": 0.0,
                "MoE other": 0.0, "GEMM": 0.0, "copies": 0.0, "other kernels": 0.0}
    by_name = {}
    events = prof.events()
    for e in events:
        # The profiler mirrors a ``record_function`` range on the device
        # timeline; it spans kernels counted on their own.
        if (e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False)
                or e.name == "moe_experts"):
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        families[_family(e.name)] += us
    # The MoE's expert products and their elementwise work.
    for name, us in _range_kernels(events, "moe_experts"):
        fam = _family(name)
        families[fam] -= us
        families["MoE GEMM" if fam == "GEMM" else "MoE other"] += us
    busy_s = sum(families.values()) * 1e-6
    if busy_s <= 0:
        raise AssertionError("profile: torch.profiler recorded no device activity")
    stats = sched.last_stats
    print(f"profile {arch} float serve (warm, under torch.profiler): host {wall_s:.2f} s, device busy "
          f"{busy_s:.3f} s ({100 * busy_s / wall_s:.1f}%), idle {100 * (1 - busy_s / wall_s):.1f}%; "
          f"decode step median {sorted(stats.decode_step_s)[len(stats.decode_step_s) // 2] * 1e3:.2f} ms")
    print(f"profile {arch} device time by family: " + ", ".join(
        f"{k} {v * 1e-3:.1f} ms" for k, v in sorted(families.items(), key=lambda kv: -kv[1])))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile {arch} top kernels: " + "; ".join(f"{n[:60]} {us * 1e-3:.1f} ms" for n, us in top))
    return {"wall_s": wall_s, "busy_s": busy_s, "families_ms": {k: v * 1e-3 for k, v in families.items()}}


def profile_train_step(dev) -> dict:
    """Where a training step's time goes: the full qwen2.5-3b of the train
    phase (the same seed) takes two warm steps, then one under
    ``torch.profiler``; its device time is split into the optimizer's part
    (the ``train_optimizer`` range: the clip and AdamW) and the forward
    and backward (the rest), each into GEMMs and other kernels, and set
    against the host clock around the step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs, smoke
    from repro_torch.train import build

    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config(smoke.ARCH)
    sz = smoke.TRAIN_FULL
    state, step_fn = build(cfg, "adamw", smoke.TRAIN_PEAK_LR, seed=smoke.SEED, device=dev)
    batch = smoke.LearnableLM(cfg.vocab_size, sz.batch, sz.seq).next_batch()
    for _ in range(2):
        state, m = step_fn(state, batch)
        float(m["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.events()
    total = {"GEMM": 0.0, "other": 0.0}
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) or \
                e.name.startswith("train_"):
            continue
        total["GEMM" if _family(e.name) == "GEMM" else "other"] += e.time_range.elapsed_us()
    opt = {"GEMM": 0.0, "other": 0.0}
    for name, us in _range_kernels(events, "train_optimizer"):
        opt["GEMM" if _family(name) == "GEMM" else "other"] += us
    parts = {"forward and backward": {k: total[k] - opt[k] for k in total}, "optimizer": opt}
    busy_s = sum(total.values()) * 1e-6
    if busy_s <= 0:
        raise AssertionError("profile: torch.profiler recorded no device activity")
    print(f"profile train step (warm, under torch.profiler): host {wall_s:.3f} s, device busy "
          f"{busy_s:.3f} s ({100 * busy_s / wall_s:.1f}%); " + "; ".join(
              f"{k} GEMM {v['GEMM'] * 1e-3:.1f} ms, other {v['other'] * 1e-3:.1f} ms"
              for k, v in parts.items()))
    top = sorted((a for a in prof.key_averages() if not a.key.startswith("train_")),
                 key=lambda a: -getattr(a, "device_time_total", getattr(a, "cuda_time_total", 0)))
    print("profile train step top ops by device time: " + "; ".join(
        f"{a.key[:50]} {getattr(a, 'device_time_total', getattr(a, 'cuda_time_total', 0)) * 1e-3:.1f} ms"
        for a in top[:10]))
    del state, step_fn
    return {"wall_s": wall_s, "busy_s": busy_s, "parts_ms": parts}


def count_train_step(trres, card: str) -> None:
    """Step 13's counted step: ``launch.dryrun.count_step`` on the train
    phase's exact step (qwen2.5-3b full, its batch and sequence, AdamW),
    on fake tensors on the host; its FLOPs must lie within
    ``TRAIN_FLOPS_BOUNDS``."""
    from repro_torch import configs, smoke
    from repro_torch.launch import dryrun, roofline

    cfg = configs.get_config(smoke.ARCH)
    sz = trres.sizes
    t0 = time.perf_counter()
    c = dryrun.count_step(cfg, "train", sz.batch, sz.seq, "adamw")
    flops, nbytes = c["analysis"]["dot_flops"], c["analysis"]["mem_bytes"]
    model = roofline.model_flops(cfg, "train", sz.seq, sz.batch)
    lo, hi = TRAIN_FLOPS_BOUNDS
    print(f"train counted ({smoke.ARCH}, {sz.batch} x {sz.seq}, AdamW; fake tensors, "
          f"{time.perf_counter() - t0:.1f} s on the host): {flops:.4e} matmul FLOPs (bounds "
          f"{lo:.2e}-{hi:.2e}), {nbytes:.4e} bytes unfused, model_flops {model:.4e} (MODEL / "
          f"counted {model / flops:.3f}), arguments {c['memory']['argument_size_in_bytes'] / 1e9:.2f}"
          f" GB; the median step {trres.median_step_s * 1e3:.1f} ms reaches "
          f"{flops / (trres.median_step_s * BF16_OPS_PER_S):.4f} of the bf16 peak (floor "
          f"{flops / BF16_OPS_PER_S * 1e3:.1f} ms), bytes at HBM rate "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.1f} ms, on {card}")
    print("train counted top ops by FLOPs: " + "; ".join(f"{k} {v:.3e}" for k, v in c["top_flops"])
          + "; by bytes: " + "; ".join(f"{k} {v:.3e}" for k, v in c["top_bytes"][:8]))
    if not lo <= flops <= hi:
        raise AssertionError(f"train counted: {flops:.4e} FLOPs outside {TRAIN_FLOPS_BOUNDS}")


def check_train_fsdp(trres, card: str, dev) -> None:
    """Step 13's sharded run (``smoke.train_fsdp`` raises on every failed
    check, a rank's included), its numbers beside the card."""
    import torch
    from repro_torch import smoke

    t0 = time.perf_counter()
    res = smoke.train_fsdp(dev, full=True, want_losses=trres.losses[:smoke.FSDP_STEPS])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counted = res.counted
    for r, rec in enumerate(res.ranks):
        coll = rec["step_collectives"]
        gathered = coll.get("all-gather", {}).get("bytes", 0.0)
        reduced = sum(coll.get(k, {}).get("bytes", 0.0) for k in ("reduce-scatter", "all-reduce"))
        steps = sorted(rec["step_s"][1:])
        print(f"train_fsdp on {card}: rank {r} of (data, model) = {res.mesh}, two gloo ranks "
              f"time-sliced on one card (not a speed): losses {[round(v, 4) for v in rec['losses']]}"
              f" (step 13: {[round(v, 4) for v in res.want_losses]}); state blocks "
              f"{rec['state_bytes'] / 2**30:.2f} GiB, peak {rec['peak_bytes'] / 2**30:.2f} GiB "
              f"(one process {trres.peak_bytes / 2**30:.2f} GiB); median step (2-"
              f"{smoke.FSDP_STEPS}) {steps[len(steps) // 2] * 1e3:.1f} ms; a step all-gathers "
              f"{gathered / 1e9:.3f} GB and reduces {reduced / 1e9:.3f} GB (the dry-run at the "
              f"rank's rows: {counted}); init {rec['init_s']:.2f} s; ring "
              f"{rec['ring']['values']} values {rec['ring']['seconds']:.3f} s, median rel error "
              f"{rec['ring']['median_rel']:.4g}")
    print(f"main path (train_fsdp): {seconds:.2f} s on {card}; no hand-kernel launch on either "
          f"rank")


def check_scan(ssres, launches, dev) -> list:
    """K7 at the SSM float serve's widest prefill program: its (width,
    bucket) as (B, S), D = d_inner, N = d_state, with inputs in the
    model's ranges (dt log-uniform in [1e-3, 1e-1], A = -(1..N) per
    channel, D = 1, unit-normal u, B and C), in the serve's types (u bf16,
    the rest float32) and all in float32.  Timed by replaying a captured
    CUDA graph (CUDA events around back-to-back calls printed beside)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models.config import ssm_dims
    from repro_torch.smoke import SSM_ARCH

    cfg = configs.get_config(SSM_ARCH)
    D, _ = ssm_dims(cfg)
    N = cfg.ssm.d_state
    B, S, _ = max(ssres.float_serve.stats.prefill_s, key=lambda p: p[0] * p[1])
    rng = np.random.default_rng(3)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    u32, Bc, Cc = (t(rng.standard_normal(shape)) for shape in ((B, S, D), (B, S, N), (B, S, N)))
    dt = t(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, D))))
    A = t(-np.tile(np.arange(1, N + 1), (D, 1)))
    Ds = t(np.ones(D))
    # The launch's geometry (csrc/selective_scan.cu, Tile): 8 states a
    # lane, 128 threads a CTA, one batch row a CTA.
    lanes = N // min(8, N)
    ctas = -(-D // (128 // lanes)) * B
    times = {}
    err = 0.0
    for label, u in (("f32", u32), ("bf16 u", u32.to(torch.bfloat16))):
        got = selective_scan(u, dt, Bc, Cc, A, Ds)
        want = ref.selective_scan_ref(u.float(), dt, Bc, Cc, A, Ds)
        err = max(err, compare_close(f"selective_scan y ({label})", got[0], want[0], SCAN_TOL),
                  compare_close(f"selective_scan h_last ({label})", got[1], want[1], SCAN_TOL))
        del got, want
        k7 = lambda: selective_scan(u, dt, Bc, Cc, A, Ds)  # noqa: E731
        nbytes = (u.element_size() * B * S * D + 4 * (2 * B * S * D + 2 * B * S * N + D * N + D
                                                      + B * D * N))
        times[label] = dict(graph=graph_ms(k7, 50), events=time_ms(k7, 50), nbytes=nbytes,
                            plain=time_ms(lambda: ref.selective_scan_ref(u, dt, Bc, Cc, A, Ds), 3))
    exps = B * S * D * N
    serve = times["bf16 u"]
    b_ms, b_by = bound(serve["nbytes"], exps, SFU_EXP_PER_S)
    row = dict(
        name="selective_scan", route="cuda", source="src/repro_torch/csrc/selective_scan.cu",
        replaces="src/repro/kernels/selective_scan.py:68", launches=launches["selective_scan"],
        max_abs_err=err, ms=serve["graph"], plain_ms=serve["plain"],
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"u ({B}, {S}, {D}) bf16, dt f32, B/C ({B}, {S}, {N}), A ({D}, {N})",
    )
    print(f"check {row['name']} {row['shape']}: max|diff| {err:.3g} over both u types (tol "
          f"{SCAN_TOL}), launches {row['launches']} ({launches['selective_scan_bf16u']} with "
          f"bf16 u); {ctas} CTAs of 128 threads, {ctas * 4} warps, {lanes} lanes a channel")
    for label, tm in times.items():
        print(f"check selective_scan ({label}): {tm['graph']:.4f} ms by CUDA graph replay, "
              f"{tm['events']:.4f} ms by CUDA events (plain {tm['plain']:.4f} ms); "
              f"{tm['nbytes'] / 1e6:.1f} MB over HBM {tm['nbytes'] / HBM_BYTES_PER_S * 1e3:.5f} "
              f"ms, {exps / 1e6:.1f} M exp on the SFUs {exps / SFU_EXP_PER_S * 1e3:.5f} ms")
    print(f"check selective_scan: ms {row['ms']:.4f} (bf16 u, graph replay), bound "
          f"{b_ms:.5f} ms by {b_by}; library none")
    return [row]


def check_kernels(result, launches, dev) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from repro_torch import smoke
    from repro_torch.core import nsga2, scenario
    from repro_torch.core.explorer import island_table
    from repro_torch.core.scenario import ScenarioTable
    from repro_torch.kernels import cuda_lib, ref
    from repro_torch.kernels.dcim_mvm import dcim_mvm
    from repro_torch.kernels.dcim_mvm import plan as dcim_mvm_plan
    from repro_torch.kernels.fp_prealign import fp_prealign
    from repro_torch.kernels.pareto_rank import dominance_matrix
    from repro_torch.sim.functional import DCIMMacroSim, quantize_sym
    from repro_torch.smoke import SCENARIOS

    rows = []
    rng = np.random.default_rng(1)

    # K1 at the DSE's two shapes: survivor selection over 16 scenarios x
    # (parents + children), and the pool.  At a few microseconds, events
    # around back-to-back calls time the wrapper: the row's time is by
    # graph replay, beside an empty kernel's (the launch floor).
    table = ScenarioTable.from_specs(SCENARIOS, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    pop = nsga2.init_population(table, nsga2.NSGA2Config(pop_size=256), gen)
    F, v = scenario.evaluate(table, pop)
    F2, v2 = scenario.evaluate(table, nsga2.init_population(
        table, nsga2.NSGA2Config(pop_size=128), gen))
    # The island run's survivor selection: 16 scenarios x 4 islands.
    islands = island_table(table, smoke.ISLANDS["n_islands"], dev)
    F3, v3 = scenario.evaluate(islands, nsga2.init_population(
        islands, nsga2.NSGA2Config(pop_size=256), gen))
    S, P, M = F.shape
    err = compare("dominance", [dominance_matrix(F, v)], [ref.dominance_matrix_ref(F, v)])
    compare("dominance pool", [dominance_matrix(F2, v2)], [ref.dominance_matrix_ref(F2, v2)])
    compare("dominance islands", [dominance_matrix(F3, v3)], [ref.dominance_matrix_ref(F3, v3)])
    # One rank's of step 12's island run over (scenario, island) = (1, TP).
    F4, v4 = F3[:F3.shape[0] // smoke.TP], v3[:F3.shape[0] // smoke.TP]
    compare("dominance island rank", [dominance_matrix(F4, v4)],
            [ref.dominance_matrix_ref(F4, v4)])

    def k1_bound(S, P):
        return bound(S * P * M * 4 + S * P * 4 + S * P * P, S * P * P * (2 * M + 3),
                     F32_OPS_PER_S)

    b_ms, b_by = k1_bound(S, P)
    b3_ms, b3_by = k1_bound(*F3.shape[:2])
    b4_ms, b4_by = k1_bound(*F4.shape[:2])

    def empty():
        cuda_lib.check(cuda_lib.lib().empty_launch(
            dev.index, torch.cuda.current_stream(dev).cuda_stream), "empty")

    floor_ms = graph_ms(empty, 200)
    pool_ms = graph_ms(lambda: dominance_matrix(F2, v2), 200)
    rows.append(dict(
        name="dominance", route="cuda", source="src/repro_torch/csrc/dominance.cu",
        replaces="src/repro/kernels/pareto_rank.py:44", launches=launches["dominance"],
        max_abs_err=err, ms=graph_ms(lambda: dominance_matrix(F, v), 200),
        plain_ms=time_ms(lambda: ref.dominance_matrix_ref(F, v), 200),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"F {tuple(F.shape)} (graph replay)",
        note=f"; the island run's F {tuple(F3.shape)}: "
             f"{graph_ms(lambda: dominance_matrix(F3, v3), 200):.5f} ms by graph replay (plain "
             f"{time_ms(lambda: ref.dominance_matrix_ref(F3, v3), 50):.4f} ms, bound "
             f"{b3_ms:.5f} ms by {b3_by}), bitwise; one rank's of step 12's island run, F "
             f"{tuple(F4.shape)}: {graph_ms(lambda: dominance_matrix(F4, v4), 200):.5f} ms by "
             f"graph replay (plain {time_ms(lambda: ref.dominance_matrix_ref(F4, v4), 50):.4f} "
             f"ms, bound {b4_ms:.5f} ms by {b4_by}), bitwise",
    ))
    print(f"check dominance: an empty kernel {floor_ms:.5f} ms by graph replay (the launch "
          f"floor); F {tuple(F.shape)} {rows[-1]['ms']:.5f} ms by graph replay, "
          f"{time_ms(lambda: dominance_matrix(F, v), 200):.5f} by events; F {tuple(F2.shape)} "
          f"{pool_ms:.5f} by graph replay, bitwise")

    d_int, d_fp = result.designs["int8"], result.designs["bf16"]
    K, N, Mr = 2048, 151936, 128                 # the lm_head GEMM, 128 token rows
    x = torch.from_numpy(rng.standard_normal((Mr, K), dtype=np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32) * np.float32(0.02)).to(dev)

    # K2 at the int8 design's lm_head call, and at the bf16 design's
    # batched group call (attn_q's width, to keep the plain version small).
    qx, _ = quantize_sym(x, 8)
    qw, _ = quantize_sym(w, 8)
    args = dict(B_x=8, B_w=8, k=d_int.k)
    err = compare("dcim_mvm", [dcim_mvm(qx, qw, **args)], [ref.dcim_mvm_ref(qx, qw, **args)])
    # The bound is the function's own (x @ w mod 2^32 on int32 codes): its
    # bytes, and one multiply-add per (m, k, n) at the int8 peak.  The
    # kernel takes `products` 8-bit digit products (balanced base-256
    # digits, i + j < 4), and only the lowest where a step's high digits
    # are all 0, as for these in-range codes; their time at the int8 peak
    # is printed beside it, not used as the bound.
    b_ms, b_by = bound(4 * (Mr * K + K * N + Mr * N), 2 * Mr * K * N, INT8_OPS_PER_S)
    products, _ = dcim_mvm_plan(1, Mr, K, N, 8, 8, dev)
    digits_ms, _ = bound(0.0, 2 * Mr * K * N * products, INT8_OPS_PER_S)
    # Yardstick only (the port never calls it): cuBLAS's int8 product of
    # the same codes, which computes the same function for these widths.
    qx8, qw8 = qx.to(torch.int8), qw.to(torch.int8)
    library_ms = time_ms(lambda: torch._int_mm(qx8, qw8), 5)
    rows.append(dict(
        name="dcim_mvm", route="cuda", source="src/repro_torch/csrc/dcim_mvm.cu",
        replaces="src/repro/kernels/dcim_mvm.py:92", launches=launches["dcim_mvm"],
        max_abs_err=err, ms=time_ms(lambda: dcim_mvm(qx, qw, **args), 10),
        plain_ms=time_ms(lambda: ref.dcim_mvm_ref(qx, qw, **args), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        shape=f"x {tuple(qx.shape)} w {tuple(qw.shape)} int8 k={d_int.k}",
        note=f"; its {products} digit products alone take {digits_ms:.4f} ms at the int8 peak "
             f"(in-range codes: the lowest alone, {digits_ms / products:.4f} ms)",
    ))
    # K2 at the DCIM serves' decode shape (2 slots, qwen2.5-3b's FFN up
    # projection), at a narrow one that splits K (its K/V projection), and
    # at the tp=2 DCIM serve's rank-local column shards of the FFN up
    # projection and the head (75968 columns end in a 64-column tile).
    for what, Kd, Nd in (("decode", K, 11008), ("decode", K, 256),
                         ("tp=2 rank decode", K, 11008 // 2), ("tp=2 rank decode", K, N // 2)):
        dx, _ = quantize_sym(x[:2, :Kd].contiguous(), 8)
        dw, _ = quantize_sym(w[:Kd, :Nd].contiguous(), 8)
        compare(f"dcim_mvm {what}", [dcim_mvm(dx, dw, **args)],
                [ref.dcim_mvm_ref(dx, dw, **args)])
        d_ms, d_by = bound(4 * (2 * Kd + Kd * Nd + 2 * Nd), 2 * 2 * Kd * Nd, INT8_OPS_PER_S)
        print(f"check dcim_mvm {what} {tuple(dx.shape)} @ {tuple(dw.shape)} int8 k={d_int.k}: "
              f"bitwise, {dcim_mvm_plan(1, 2, Kd, Nd, 8, 8, dev)[1]} K-splits, "
              f"{device_ms(lambda: dcim_mvm(dx, dw, **args), 50)} device time "
              f"(plain {time_ms(lambda: ref.dcim_mvm_ref(dx, dw, **args), 3):.4f} ms, bound "
              f"{d_ms:.4f} ms by {d_by})")
    # Where a DCIM serve's projection spends its time at the decode shape:
    # the macro simulator re-quantizes the weight on every call.
    sim = DCIMMacroSim.from_point(d_int)
    xd = x[:2].to(torch.bfloat16)
    wd = w[:, :11008].to(torch.bfloat16).contiguous()
    qd, _ = quantize_sym(wd.to(torch.float32), 8)
    qxd, _ = quantize_sym(xd.to(torch.float32), 8)
    quant_ms = device_ms(lambda: quantize_sym(wd.to(torch.float32), 8), 20)
    print(f"check DCIMMacroSim.matmul decode {tuple(xd.shape)} @ {tuple(wd.shape)} bf16, int8 "
          f"design: {time_ms(lambda: sim.matmul(xd, wd), 20):.4f} ms a call (CUDA events), "
          f"{device_ms(lambda: sim.matmul(xd, wd), 20)} device time, of which "
          f"quantize_sym of the weight {quant_ms} "
          f"and K2 {device_ms(lambda: dcim_mvm(qxd, qd, **args), 20)}")
    H = math.gcd(d_fp.H, K)
    G = K // H
    mant_x, _ = fp_prealign(x.reshape(Mr, G, H).contiguous(), 8)
    mant_w, _ = fp_prealign(w[:, :2048].t().reshape(2048, G, H).contiguous(), 8)
    mx = mant_x.permute(1, 0, 2).contiguous()
    mw = mant_w.permute(1, 2, 0).contiguous()
    fargs = dict(B_x=9, B_w=9, k=d_fp.k)
    compare("dcim_mvm batched", [dcim_mvm(mx, mw, **fargs)], [ref.dcim_mvm_ref(mx, mw, **fargs)])
    print(f"check dcim_mvm batched {tuple(mx.shape)} @ {tuple(mw.shape)} bf16 k={d_fp.k}: "
          f"bitwise, {time_ms(lambda: dcim_mvm(mx, mw, **fargs), 3):.3f} ms")

    # K3 at the bf16 design's two operands: the online x and the lm_head
    # weight (the row's).
    xg = x.reshape(Mr, G, H).contiguous()
    compare("fp_prealign x", list(fp_prealign(xg, 8)), list(ref.fp_prealign_ref(xg, 8)))
    print(f"check fp_prealign x {tuple(xg.shape)} B_M=8: bitwise, "
          f"{graph_ms(lambda: fp_prealign(xg, 8), 200):.5f} ms by graph replay, "
          f"{time_ms(lambda: fp_prealign(xg, 8), 200):.5f} by events (bound "
          f"{bound(8 * xg.numel() + 4 * Mr * G, 0.0, F32_OPS_PER_S)[0]:.5f} ms by bytes)")
    wt = w.t().reshape(N, G, H).contiguous()
    err = compare("fp_prealign", list(fp_prealign(wt, 8)), list(ref.fp_prealign_ref(wt, 8)))
    n_el = N * G * H
    b_ms, b_by = bound(4 * n_el + 4 * n_el + 4 * N * G, 0.0, F32_OPS_PER_S)
    rows.append(dict(
        name="fp_prealign", route="cuda", source="src/repro_torch/csrc/fp_prealign.cu",
        replaces="src/repro/kernels/fp_prealign.py:54", launches=launches["fp_prealign"],
        max_abs_err=err, ms=time_ms(lambda: fp_prealign(wt, 8), 10),
        plain_ms=time_ms(lambda: ref.fp_prealign_ref(wt, 8), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"w^T {tuple(wt.shape)} B_M=8",
    ))
    for r in rows:
        print(f"check {r['name']} {r['shape']}: bitwise, max|diff| {r['max_abs_err']}, "
              f"launches {r['launches']}, {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library {r['library_ms']})"
              f"{r.get('note', '')}")
    return rows


def check_codegen(result, out_dir: str) -> None:
    """Every scenario's design generated from the card's front, audited
    and written, and the front recorded."""
    from repro_torch import smoke
    from repro_torch.core.results import ResultStore

    store = ResultStore(os.path.join(out_dir, "results"))
    if "explore_multi" not in store:
        raise AssertionError("codegen: the DSE front was not recorded")
    for prec, w in smoke.SCENARIOS:
        c = result.codegen.get(f"{prec}/{w}")
        if c is None or not c.audit_ok:
            raise AssertionError(f"codegen {prec}/{w}: missing or failed its audit ({c})")
        rep = os.path.join(out_dir, f"{prec}_{w}", "report.json")
        with open(rep) as f:
            if not json.load(f)["audit"]["ok"]:
                raise AssertionError(f"codegen {prec}/{w}: {rep} records a failed audit")
    print(f"main path (run): all {len(result.codegen)} designs generated from the card's front "
          f"passed their audits")


def check_serve_tp(result, sres, int8, card: str, dev) -> dict:
    """Step 12: step 3's island run and qwen2.5-3b at tp=2, two ranks on
    this card (``smoke.serve_tp`` raises on every failed check, a rank's
    included).  Returns rank 0's launches over its three serves."""
    import torch
    from repro_torch import smoke

    t0 = time.perf_counter()
    fl, tn1 = sres.float_serve, sres.tenants.serve
    tp1 = {"float": [r.generated.tolist() for r in fl.results],
           "dcim": [r.generated.tolist() for r in sres.dcim_serve.results]}
    res = smoke.serve_tp(dev, full=True, design=int8, tp1_tokens=tp1, islands=result.islands,
                         tp1_tenants=smoke.tenant_schedule(tn1.results, tn1.stats))
    torch.cuda.synchronize()
    print(f"main path (serve_tp): {time.perf_counter() - t0:.2f} s; launches by rank "
          f"{[{n: rec['serves'][n]['launches'] for n in smoke.TP_SERVES} for rec in res.ranks]}"
          f"; the tenant trace's {[rec['tenants']['launches'] for rec in res.ranks]}")
    for r, rec in enumerate(res.ranks):
        isl = rec["islands"]
        print(f"serve_tp islands rank {r} on {card}: {len(smoke.SCENARIOS)} scenarios x "
              f"{smoke.ISLANDS['n_islands']} islands over (scenario, island) = (1, {res.tp}) in "
              f"{isl['seconds']:.2f} s as {res.tp} processes time-sliced on one card (not a "
              f"speed; one process: {result.seconds['islands']:.2f} s), {isl['launches']} "
              f"dominance launches; results bitwise the one-process run's")
    tn = res.ranks[0]["tenants"]
    tdec = sorted(tn["decode_step_s"])
    print(f"serve_tp tenants on {card}: tp={res.tp} led by rank 0 under driving(), as {res.tp} "
          f"processes time-sliced on one card (not a speed): {sum(map(len, tn['tokens'].values()))} "
          f"tokens in {tn['seconds']:.2f} s, decode step median {tdec[len(tdec) // 2] * 1e3:.2f} "
          f"ms over {len(tdec)} steps; schedule {tn['schedule']} equal to the tp=1 trace's; "
          f"worst logit gap to the tp=1 Engine {tn['worst_gap']:.4g} (delta {tn['delta']}); "
          f"follower {res.ranks[1]['tenants']['seconds']:.2f} s")
    for rid in sorted(tn["first_token_s"], key=int):
        print(f"serve_tp tenants on {card}: rid {rid}: first token {tn['first_token_s'][rid]:.3f} "
              f"s, last {tn['last_token_s'][rid]:.3f} s after the pump started (time-sliced)")
    for name in smoke.TP_SERVES:
        for r, rec in enumerate(res.ranks):
            got = rec["serves"][name]["launches"]
            print(f"serve_tp {name} rank {r}: all {got['paged_decode_gqa']} paged_decode_gqa and "
                  f"{got['prefix_prefill']} prefix_prefill launches took the tensor-core kernel; "
                  f"dcim_mvm {got['dcim_mvm']}")
        rec = res.serve(name)
        dec = sorted(rec["decode_step_s"])
        print(f"serve_tp {name} on {card}: tp={res.tp} as {res.tp} processes time-sliced on one "
              f"card (not a speed): {sum(map(len, rec['tokens']))} tokens in "
              f"{rec['seconds']:.2f} s, decode step median {dec[len(dec) // 2] * 1e3:.2f} ms over "
              f"{len(dec)} steps; worst logit gap to the tp=1 Engine {rec['worst_gap']:.4g} "
              f"(delta {rec['delta']}), exact argmax share {rec['exact_share']:.3f}, tokens "
              f"equal to the tp=1 serve's {res.same_as_tp1[name]:.3f}")
    # The rank-local K4/K5 checks of step 15 take the tp=1 float serve's
    # positions and bursts: the tp=2 serve ran the same trace at the same
    # sizes, and the host Scheduler's choices do not depend on tp.
    rec = res.serve("float")
    hits = sum(r.prefix_hit_tokens for r in fl.results)
    if (rec["prefix_hit_tokens"], len(rec["decode_step_s"])) != (hits, len(fl.stats.decode_step_s)):
        raise AssertionError(f"serve_tp float: {rec['prefix_hit_tokens']} prefix-hit tokens over "
                             f"{len(rec['decode_step_s'])} decode steps, tp=1: {hits} over "
                             f"{len(fl.stats.decode_step_s)}")
    return {k: sum(res.serve(n)["launches"][k] for n in smoke.TP_SERVES) + tn["launches"][k]
            for k in res.serve("float")["launches"]}


def check_moved(card: str) -> None:
    """Step 16: ``smoke.serve_moved`` at full width in a fresh
    interpreter (the reduction flags are process-global); raises if it
    fails."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    sys.stdout.flush()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, 'src'); "
                          "from repro_torch import smoke; smoke.serve_moved('cuda', full=True)"],
                         cwd=ROOT, timeout=900)
    secs = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"serve_moved exited with {out.returncode}")
    print(f"serve_moved on {card}: {secs:.2f} s in a fresh interpreter (its start, the CPU draw, "
          f"the move, the serve and the Engine check)")


def _check_example(name: str, res: dict, got: dict) -> None:
    """An example's own results, by the repo's means."""
    if name == "quickstart" and not (res["front"] > 0 and res["audit_ok"]):
        raise AssertionError(f"example quickstart: front {res['front']}, audit {res['audit_ok']}")
    if name == "dcim_for_llm" and not math.isfinite(res["median_rel_err"]):
        raise AssertionError(f"example dcim_for_llm: median rel err {res['median_rel_err']}")
    if name == "serve_lm" and not (res["prefix_hit_tokens"] > 0 and res["cross_trace_hit_tokens"] > 0
                                   and res["compiled_after"] == res["compiled_before"]
                                   and res["stream_equals_result"]):
        raise AssertionError(f"example serve_lm: {res}")
    if name == "train_lm":
        losses = [h["loss"] for h in res["history"]]
        if res["final_step"] != 30 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"example train_lm: step {res['final_step']}, losses {losses}")
        if any(got.values()):
            raise AssertionError(f"example train_lm launched hand kernels {got}")
    if name == "distributed_dse":
        if min(res["rank_dominance"]) <= 0:
            raise AssertionError(f"example distributed_dse: dominance launches by rank "
                                 f"{res['rank_dominance']}")
        low = {k: v for k, v in res["coverage"].items() if v[0] < 0.9 * v[1]}
        if low:
            raise AssertionError(f"example distributed_dse: oracle coverage under 0.9 in {low}")


def check_examples(card: str) -> None:
    """Step 17: every ``examples/torch_*.py`` on the card through its
    ``main``; raises on a failed example, a required kernel never
    launched, or a wrong result."""
    import torch
    from repro_torch.kernels import cuda_lib

    gc.collect()
    torch.cuda.empty_cache()
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    total = 0.0
    with tempfile.TemporaryDirectory() as d, contextlib.chdir(d):
        for name, argv, kernels in EXAMPLES:
            mod = importlib.import_module(f"torch_{name}")
            t0 = time.perf_counter()
            cuda_lib.reset_launches()
            res = mod.main(["--device", "cuda", *argv])
            torch.cuda.synchronize()
            got = dict(cuda_lib.launches)
            secs = time.perf_counter() - t0
            total += secs
            ranks = (f"; dominance launches by rank {res['rank_dominance']}"
                     if name == "distributed_dse" else "")
            print(f"example {name} on {card}: {secs:.2f} s; launches "
                  + " ".join(f"{k}={n}" for k, n in got.items() if n) + ranks)
            idle = [k for k in kernels if got[k] <= 0]
            if idle:
                raise AssertionError(f"example {name} never launched {idle}")
            _check_example(name, res, got)
    print(f"examples on {card}: {total:.2f} s for all {len(EXAMPLES)}")


def check_lint(card: str) -> None:
    """Step 18: the contract lint over every contract on the card; raises
    on any error finding, a contract that did not run, a kernel whose
    launch key did not move or whose output was not covered, a
    scheduler / train-step contract without its sync counts, or a wall
    time over its budget (2x the committed ``cuda`` baseline)."""
    from repro_torch.analysis.lint import (BENCH_PATH, BUDGET_FACTOR, check_runtime_budget,
                                           contract_seconds, run_lint)

    with open(BENCH_PATH) as f:
        baseline = json.load(f).get("cuda")
    if baseline is None:
        raise AssertionError(f"no committed cuda baseline in {BENCH_PATH}")

    t0 = time.perf_counter()
    report = run_lint(device="cuda", ranks=2)
    wall = time.perf_counter() - t0
    for f in report.findings:
        print(f"lint [{f.severity}] {f.check}/{f.contract}: {f.message}")
    errors = report.by_severity("error")
    if errors:
        raise AssertionError(f"the contract lint found {len(errors)} error(s): "
                             f"{[f.check + '/' + f.contract for f in errors]}")
    missing = set(LINT_CONTRACTS) - set(report.contracts_executed)
    if missing:
        raise AssertionError(f"the contract lint did not run {sorted(missing)}")
    took = {f.data["key"] for f in report.findings
            if f.check == "kernels" and "output covered" in f.message}
    if took != set(LINT_KEYS):
        raise AssertionError(f"lint kernels.cuda: launched and covered only {sorted(took)}")
    print(f"lint kernels.cuda: all {len(took)} launch keys moved, every output covered")
    for contract in ("serve.scheduler", "train.train_step"):
        rec = [f for f in report.findings if f.check == "transfers" and f.contract == contract]
        if not rec or "sync_warnings" not in rec[0].data:
            raise AssertionError(f"lint {contract}: no sync counts reported")
        d = rec[0].data
        print(f"lint {contract} on {card}: {d['syncs']} host syncs over {d['hot_calls']} hot "
              f"call(s) {d['syncs_by_kind']} (budget {d['sync_budget']} a call), "
              f"{d['sync_warnings']} set_sync_debug_mode warnings, transfers {d['transfers']}")
    secs = contract_seconds(report)
    print(f"lint on {card}: {wall:.2f} s (budget {BUDGET_FACTOR * baseline['total_wall_s']:.2f} s, "
          f"{BUDGET_FACTOR}x the committed cuda baseline {baseline['total_wall_s']} s); "
          f"seconds per contract " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(secs.items())))
    over = check_runtime_budget(report, wall, record=False, device="cuda")
    if over:
        raise AssertionError(over)
    print(f"lint on {card}: summary {report.summary()} over "
          f"{len(set(report.contracts_executed))} contracts, "
          f"{len(set(report.checks_executed))} checks")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda_lib
    from repro_torch import smoke

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)

    build_s = cuda_lib.build(force=True)
    print(f"kernels built in {build_s:.2f} s into {cuda_lib.LIB_PATH}")
    cuda_lib.lib()

    codegen_dir = os.path.join(ROOT, "build", "codegen")
    shutil.rmtree(codegen_dir, ignore_errors=True)
    t0 = time.perf_counter()
    cuda_lib.reset_launches()
    result = smoke.run(dev, full=True, out_dir=codegen_dir)
    torch.cuda.synchronize()
    run_launches = dict(cuda_lib.launches)
    print(f"main path (run): {time.perf_counter() - t0:.2f} s; launches {run_launches}")
    for name in smoke.RUN_KERNELS:
        if run_launches[name] <= 0:
            raise AssertionError(f"the main path (run) never launched {name}")
    n, vec = run_launches["fp_prealign"], run_launches["fp_prealign_vec"]
    if vec != n:
        raise AssertionError(f"the main path (run): {vec} of {n} fp_prealign launches took "
                             f"the vector path")
    print(f"main path (run): all {n} fp_prealign launches took the vector path")
    if result.island_launches <= 0:
        raise AssertionError("the island run never launched dominance")
    print(f"main path (run): islands {result.seconds['islands']:.2f} s on {card}, "
          f"{result.island_launches} dominance launches (of the run's {run_launches['dominance']})")
    check_codegen(result, codegen_dir)

    def drive(name, fn, kernels):
        """Run one path with every launch count set to 0 just before it;
        returns (its result, the counts just after), each of ``kernels``
        required > 0."""
        t0 = time.perf_counter()
        cuda_lib.reset_launches()
        res = fn(dev, full=True)
        torch.cuda.synchronize()
        got = dict(cuda_lib.launches)
        print(f"main path ({name}): {time.perf_counter() - t0:.2f} s; launches {got}")
        idle = [k for k in kernels if got[k] <= 0]
        if idle:
            raise AssertionError(f"the main path ({name}) never launched {idle}")
        return res, got

    int8 = result.designs["int8"]
    sres, serve_launches = drive("serve", lambda d, full: smoke.serve(d, full, design=int8),
                                 SERVE_KERNELS)
    tn, up = sres.tenants, sres.unpaged_serve
    tst = tn.serve.stats
    dec = sorted(tst.decode_step_s)
    print(f"serve tenants on {card}: {tst.generated_tokens} tokens in {tn.serve.seconds:.2f} s, "
          f"decode step median {dec[len(dec) // 2] * 1e3:.2f} ms over {len(dec)} steps, "
          f"preemptions {tst.preemptions}, prefill_chunks {tst.prefill_chunks} (context "
          f"lengths {tn.prefill_ctx}), shed {tst.shed}, {tn.callbacks} callbacks on "
          f"{tn.callback_threads}, compile_counts {tn.counts}, worst logit gap "
          f"{tn.serve.worst_gap:.4g} (delta {tn.serve.delta})")
    for r in tn.serve.results:
        print(f"serve tenants on {card}: rid {r.rid} {r.tenant}: first token "
              f"{tn.first_token_s[r.rid]:.3f} s, last {tn.last_token_s[r.rid]:.3f} s after the "
              f"pump started, preemptions {r.preemptions}")
    udec = sorted(up.stats.decode_step_s)
    print(f"serve paged=False on {card}: {up.stats.generated_tokens} tokens in {up.seconds:.2f} s, "
          f"decode step median {udec[len(udec) // 2] * 1e3:.2f} ms over {len(udec)} steps, "
          f"worst logit gap {up.worst_gap:.4g} (delta {up.delta})")
    ssres, ssm_launches = drive(
        "serve_ssm", lambda d, full: smoke.serve_ssm(d, full, design=int8), SSM_SERVE_KERNELS)
    mres, mla_launches = drive(
        "serve_mla", lambda d, full: smoke.serve_mla(d, full, design=int8), MLA_SERVE_KERNELS)
    mures, music_launches = drive(
        "serve_music", lambda d, full: smoke.serve_music(d, full, design=int8),
        MUSIC_SERVE_KERNELS)
    vres, vlm_launches = drive(
        "serve_vlm", lambda d, full: smoke.serve_vlm(d, full, design=result.designs["bf16"]),
        VLM_KERNELS)
    n, vec = vlm_launches["fp_prealign"], vlm_launches["fp_prealign_vec"]
    if vec != n:
        raise AssertionError(f"the main path (serve_vlm): {vec} of {n} fp_prealign launches "
                             f"took the vector path")
    print(f"main path (serve_vlm): all {n} fp_prealign launches took the vector path")
    hres, hybrid_launches = drive("serve_hybrid", smoke.serve_hybrid, HYBRID_SERVE_KERNELS)
    moeres, moe_launches = drive("serve_moe", smoke.serve_moe, MOE_SERVE_KERNELS)
    tp_launches = check_serve_tp(result, sres, int8, card, dev)
    # The serves run in bf16: every K4 and K5 launch takes the tensor-core kernel.
    gqa_serves = (sres.float_serve, sres.dcim_serve, tn.serve, mures.float_serve,
                  mures.dcim_serve, hres.float_serve, moeres.float_serve)
    for chk in gqa_serves + (mres.float_serve, mres.dcim_serve):
        n, mma = chk.launches["prefix_prefill"], chk.launches["prefix_prefill_mma"]
        if n <= 0 or mma != n:
            raise AssertionError(f"serve {chk.name}: {mma} of {n} prefix_prefill launches "
                                 f"took the tensor-core kernel")
        print(f"serve {chk.name}: all {n} prefix_prefill launches took the tensor-core kernel")
    for chk in gqa_serves:
        n, mma = chk.launches["paged_decode_gqa"], chk.launches["paged_decode_gqa_mma"]
        if n <= 0 or mma != n:
            raise AssertionError(f"serve {chk.name}: {mma} of {n} paged_decode_gqa launches "
                                 f"took the tensor-core kernel")
        print(f"serve {chk.name}: all {n} paged_decode_gqa launches took the tensor-core kernel")
    # The MLA serves keep bf16 pages: every K6 launch takes the split walk.
    for chk in (mres.float_serve, mres.dcim_serve):
        n, mma = chk.launches["paged_decode_mla"], chk.launches["paged_decode_mla_mma"]
        if n <= 0 or mma != n:
            raise AssertionError(f"serve {chk.name}: {mma} of {n} paged_decode_mla launches "
                                 f"took the tensor-core split walk")
        print(f"serve {chk.name}: all {n} paged_decode_mla launches took the tensor-core "
              f"split walk")
    # The SSM serves hand K7 the post-conv u in bf16, as the kernel takes it.
    for chk in (ssres.float_serve, ssres.dcim_serve, hres.float_serve):
        n, bf = chk.launches["selective_scan"], chk.launches["selective_scan_bf16u"]
        if n <= 0 or bf != n:
            raise AssertionError(f"serve {chk.name}: {bf} of {n} selective_scan launches "
                                 f"took a bf16 u")
        print(f"serve {chk.name}: all {n} selective_scan launches took a bf16 u")
    for chk, what in ((mures.float_serve, "> 0"), (moeres.float_serve, "> 0"),
                      (hres.float_serve, "0, reuse gated off")):
        print(f"serve {chk.name}: {sum(r.prefix_hit_tokens for r in chk.results)} prefix-hit "
              f"tokens ({what})")
    trres, train_launches = drive("train", smoke.train, ())
    if any(train_launches.values()):
        raise AssertionError(f"the training path launched hand kernels {train_launches}")
    print(f"train on {card}: {trres.n_params / 1e9:.3f} B params, {trres.sizes.steps} steps of "
          f"{trres.sizes.batch} x {trres.sizes.seq} tokens, losses "
          f"{[round(v, 4) for v in trres.losses]}, grad norms "
          f"{[round(v, 4) for v in trres.grad_norms]}; median step (steps 2-"
          f"{trres.sizes.steps}) {trres.median_step_s * 1e3:.1f} ms, {trres.tokens_per_s:.0f} "
          f"tokens/s, peak device memory {trres.peak_bytes / 2**30:.2f} GiB; no hand-kernel "
          f"launch")
    count_train_step(trres, card)
    check_train_fsdp(trres, card, dev)
    phases = (run_launches, serve_launches, ssm_launches, mla_launches, music_launches,
              vlm_launches, hybrid_launches, moe_launches)
    launches = {k: sum(p[k] for p in phases) for k in run_launches}
    profile_float_serve(dev, smoke.ARCH, smoke.SERVE_FULL)
    profile_float_serve(dev, smoke.SSM_ARCH, smoke.SSM_SERVE_FULL)
    profile_float_serve(dev, smoke.MLA_ARCH, smoke.MLA_SERVE_FULL, n_layers=smoke.MLA_LAYERS,
                        mtp=False)
    profile_train_step(dev)
    gc.collect()

    torch.backends.cuda.matmul.allow_tf32 = False
    serves = ((smoke.ARCH, sres, launches, 1), (smoke.MUSIC_ARCH, mures, music_launches, 1),
              (smoke.JAMBA_ARCH, hres, hybrid_launches, 1), (smoke.MOE_ARCH, moeres, moe_launches, 1),
              (smoke.ARCH, sres, tp_launches, smoke.TP))
    rows = (check_kernels(result, launches, dev) + check_attention(serves, dev)
            + check_mla(mres, launches, dev) + check_scan(ssres, launches, dev))
    check_moved(card)
    check_examples(card)
    check_lint(card)
    n_bytes = sum(c.bytes for c in result.codegen.values())
    print(f"codegen (host): {len(result.codegen)} designs, {n_bytes} bytes in "
          f"{result.seconds['codegen']:.3f} s on {card}")
    print(card)
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k not in ("shape", "note")}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
