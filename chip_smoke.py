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
     ``dcimmap.plan("qwen2.5-3b", ...)``, the best int8 and bf16 designs,
     and every qwen2.5-3b GEMM class at full width through both designs;
     then read the counts: K1-K3 must each be > 0, and every K3 launch
     must have taken K3's vector path;
  4. with every launch count set to 0 again, run ``repro_torch.smoke.serve``:
     qwen2.5-3b at full width and depth (bf16, weights drawn on the card)
     served through ``Scheduler.serve`` on a shared-prefix trace of 8
     requests, each served sequence held to the ``Engine``'s
     teacher-forced logits; then the same model served under the int8
     design's macro numerics (``dcim_sim``), held the same way; then read
     the counts: K4, K5 and K2 must each be > 0;
  5. with every launch count set to 0 again, run
     ``repro_torch.smoke.serve_ssm``: falcon-mamba-7b at full width and
     depth (64 Mamba-1 layers, bf16, weights drawn on the card) served on
     the same trace (K7 in every layer of every prefill; prefix reuse
     gated off, 0 hit tokens), held to the ``Engine`` running the
     associative scan; then 8 of its 64 layers served under the int8
     design; then read the counts: K7 and K2 must each be > 0, and every
     K7 launch of both SSM serves must have taken a bf16 u;
  6. with every launch count set to 0 again, run
     ``repro_torch.smoke.serve_mla``: deepseek-v3-671b at full width, 2
     of its 61 layers (MLA + drop-free MoE over 256 experts, bf16,
     24.9 B params drawn on the card) served on the same trace (K5 at
     the MLA shape with prefix hits, K6 in every layer of every decode
     step), held to the ``Engine``; then the same model under the int8
     design; then read the counts: K6, K5 and K2 must each be > 0, and
     every K5 launch of the qwen and deepseek serves (bf16) must have
     taken K5's tensor-core kernel, every K4 launch of the qwen serves
     K4's, and every K6 launch of the deepseek serves K6's split walk;
  7. serve each float trace once more, warm, under ``torch.profiler``,
     and print the device-busy share of the host time and the device
     time by kernel family (K4, K5, K6, K7, the MoE's expert GEMMs, the
     other GEMMs, copies, the rest);
  8. at the main paths' shapes, compare each kernel with its plain
     version on the card (K1-K3 bitwise, K4/K5 within ATTN_TOL, K6
     within MLA_TOL, K7 within SCAN_TOL) and time both with CUDA
     events, beside the card's bound and, where one exists, a single
     PyTorch call that computes the same function; K1, K4 and its library
     call, K6 and its library call, and K7, by replaying a captured CUDA
     graph of many calls (the events time printed beside it; K1 also at
     the DSE's pool shape, beside an empty kernel's time, the launch
     floor); K3 also at the online operand x; K6 also
     with one split a slot against all splits; K7 with a bf16 u (the
     serve's types) and all in float32; K5 also at the MLA serve's
     shapes (with SDPA beside it); K2 also at the DCIM serves' decode
     shape and at a narrow one that splits K (device time by the
     profiler);
  9. print the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
     line last.

It imports neither ``jax`` nor the ``repro`` package.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s,
# int8 tensor-core ops/s, float32 (non-tensor) ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
# exp's per second on the special-function units: 16 per clock per SM
# (CUDA programming guide, compute capability 9.0) x 132 SMs x the
# 1.98 GHz boost clock (data sheet).
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# K4/K5 against their plain versions on bf16 operands: the kernels round
# the unnormalised softmax weights to bf16, the plain versions the
# normalised ones, one bf16 ulp (2^-8) apart per weight at most.
ATTN_TOL = 2e-2
# K7 against its plain version, both in float32 (a bf16 u widened exactly
# on both sides): they take exp(dt A) as exp2 of dt * (A log2 e) on the
# SFUs and as expf, exp(dt A) h + (dt u) B with and without a fused
# multiply-add, and the N-sum in another order, a few ulps of |y| <= ~5
# apart; the recurrence contracts (|exp(dt A)| <= 1), so the differences
# do not grow along S.
SCAN_TOL = 1e-5
# K6 against its plain version: the split walk runs its products on bf16
# tensor cores, but as exact planes: the pages are bf16, and q_abs and the
# softmax weights are cut into three bf16 planes that sum exactly to the
# float32 values, so every plane product is exact in float32 and the two
# differ by summation order, the online softmax's and the merge's
# rescaling only, a few float32 ulps of outputs of magnitude ~1-3.
MLA_TOL = 1e-5
SERVE_KERNELS = ("paged_decode_gqa", "prefix_prefill", "dcim_mvm")
SSM_SERVE_KERNELS = ("selective_scan", "dcim_mvm")
MLA_SERVE_KERNELS = ("paged_decode_mla", "prefix_prefill", "dcim_mvm")


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


def check_attention(sres, launches, dev) -> list:
    """K4 and K5 at the float serve's shapes: K4 at the decode step of 4
    slots over 257 pages with the served requests' last positions, K5 at
    the widest burst the trace ran, over a 1024-row gathered context."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import decode_split, paged_decode_gqa, prefix_prefill
    from repro_torch.smoke import ARCH

    cfg = configs.get_config(ARCH)
    sz = sres.sizes
    fl = sres.float_serve
    H, Hk, hd = cfg.n_heads, cfg.n_kv, cfg.hd
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

    # K5: the widest burst of the trace, over the slots' full gathered context.
    Bw, T, _ = max(fl.stats.prefill_s, key=lambda p: p[0] * p[1])
    L = nb * sz.page_size
    ctx_np = np.zeros(Bw, np.int32)
    hits = [r.prefix_hit_tokens for r in fl.results if r.prefix_hit_tokens][-Bw:]
    ctx_np[:len(hits)] = hits
    q = rand(Bw, T, H, hd)
    kc, vc, kt, vt = rand(Bw, L, Hk, hd), rand(Bw, L, Hk, hd), rand(Bw, T, Hk, hd), rand(Bw, T, Hk, hd)
    ctx = torch.from_numpy(ctx_np).to(dev)
    err = compare_close("prefix_prefill", prefix_prefill(q, kc, vc, kt, vt, ctx),
                        ref.prefix_prefill_ref(q, kc, vc, kt, vt, ctx), ATTN_TOL)
    pairs = int(T * ctx_np.sum()) + Bw * T * (T + 1) // 2
    b_ms, b_by = bound(2 * Bw * T * H * hd + 2 * int(ctx_np.sum()) * Hk * 2 * hd
                       + 2 * Bw * T * Hk * 2 * hd + 4 * Bw + 4 * Bw * T * H * hd,
                       2 * pairs * H * 2 * hd, BF16_OPS_PER_S)
    ka, va = expand(torch.cat([kc, kt], dim=1)), expand(torch.cat([vc, vt], dim=1))
    qs = q.transpose(1, 2).contiguous()
    mask = prefix_mask(ctx, L, T)
    rows.append(dict(
        name="prefix_prefill", route="cuda", source="src/repro_torch/csrc/prefix_prefill.cu",
        replaces="src/repro/kernels/paged_attention.py:226", launches=launches["prefix_prefill"],
        max_abs_err=err, ms=time_ms(lambda: prefix_prefill(q, kc, vc, kt, vt, ctx), 50),
        plain_ms=time_ms(lambda: ref.prefix_prefill_ref(q, kc, vc, kt, vt, ctx), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ka, va, attn_mask=mask), 50),
        shape=f"q {tuple(q.shape)} bf16, ctx {tuple(kc.shape)} bf16, ctx_len {ctx_np.tolist()}",
    ))
    for r in rows:
        print(f"check {r['name']} {r['shape']}: max|diff| {r['max_abs_err']:.3g} "
              f"(tol {ATTN_TOL}), launches {r['launches']}, {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by {r['bound_by']}, "
              f"library {r['library_ms']:.4f} ms){r.get('note', '')}")
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


def _moe_kernels(events):
    """(name, us) of every device kernel launched inside a ``moe_experts``
    range (``models.moe``'s expert products and their elementwise work),
    through the profiler's links from the CPU ops to their kernels."""
    out = []

    def walk(e):
        out.extend((k.name, k.duration) for k in e.kernels)
        for c in e.cpu_children:
            walk(c)

    for e in events:
        if e.name == "moe_experts":
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
    for name, us in _moe_kernels(events):
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

    from repro_torch.core import nsga2, scenario
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
    S, P, M = F.shape
    err = compare("dominance", [dominance_matrix(F, v)], [ref.dominance_matrix_ref(F, v)])
    compare("dominance pool", [dominance_matrix(F2, v2)], [ref.dominance_matrix_ref(F2, v2)])
    b_ms, b_by = bound(S * P * M * 4 + S * P * 4 + S * P * P, S * P * P * (2 * M + 3),
                       F32_OPS_PER_S)

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
    # projection) and at a narrow one that splits K (its K/V projection).
    for Kd, Nd in ((K, 11008), (K, 256)):
        dx, _ = quantize_sym(x[:2, :Kd].contiguous(), 8)
        dw, _ = quantize_sym(w[:Kd, :Nd].contiguous(), 8)
        compare("dcim_mvm decode", [dcim_mvm(dx, dw, **args)], [ref.dcim_mvm_ref(dx, dw, **args)])
        d_ms, d_by = bound(4 * (2 * Kd + Kd * Nd + 2 * Nd), 2 * 2 * Kd * Nd, INT8_OPS_PER_S)
        print(f"check dcim_mvm decode {tuple(dx.shape)} @ {tuple(dw.shape)} int8 k={d_int.k}: "
              f"bitwise, {dcim_mvm_plan(1, 2, Kd, Nd, 8, 8, dev)[1]} K-splits, "
              f"{device_ms(lambda: dcim_mvm(dx, dw, **args), 50)} device time "
              f"(bound {d_ms:.4f} ms by {d_by})")
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

    t0 = time.perf_counter()
    cuda_lib.reset_launches()
    result = smoke.run(dev, full=True)
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

    t0 = time.perf_counter()
    cuda_lib.reset_launches()
    sres = smoke.serve(dev, full=True, design=result.designs["int8"])
    torch.cuda.synchronize()
    serve_launches = dict(cuda_lib.launches)
    print(f"main path (serve): {time.perf_counter() - t0:.2f} s; launches {serve_launches}")
    for name in SERVE_KERNELS:
        if serve_launches[name] <= 0:
            raise AssertionError(f"the main path (serve) never launched {name}")

    t0 = time.perf_counter()
    cuda_lib.reset_launches()
    ssres = smoke.serve_ssm(dev, full=True, design=result.designs["int8"])
    torch.cuda.synchronize()
    ssm_launches = dict(cuda_lib.launches)
    print(f"main path (serve_ssm): {time.perf_counter() - t0:.2f} s; launches {ssm_launches}")
    for name in SSM_SERVE_KERNELS:
        if ssm_launches[name] <= 0:
            raise AssertionError(f"the main path (serve_ssm) never launched {name}")

    t0 = time.perf_counter()
    cuda_lib.reset_launches()
    mres = smoke.serve_mla(dev, full=True, design=result.designs["int8"])
    torch.cuda.synchronize()
    mla_launches = dict(cuda_lib.launches)
    print(f"main path (serve_mla): {time.perf_counter() - t0:.2f} s; launches {mla_launches}")
    for name in MLA_SERVE_KERNELS:
        if mla_launches[name] <= 0:
            raise AssertionError(f"the main path (serve_mla) never launched {name}")
    # The serves run in bf16: every K5 launch takes the tensor-core kernel.
    for chk in (sres.float_serve, sres.dcim_serve, mres.float_serve, mres.dcim_serve):
        n, mma = chk.launches["prefix_prefill"], chk.launches["prefix_prefill_mma"]
        if n <= 0 or mma != n:
            raise AssertionError(f"serve {chk.name}: {mma} of {n} prefix_prefill launches "
                                 f"took the tensor-core kernel")
        print(f"serve {chk.name}: all {n} prefix_prefill launches took the tensor-core kernel")
    for chk in (sres.float_serve, sres.dcim_serve):
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
    for chk in (ssres.float_serve, ssres.dcim_serve):
        n, bf = chk.launches["selective_scan"], chk.launches["selective_scan_bf16u"]
        if n <= 0 or bf != n:
            raise AssertionError(f"serve {chk.name}: {bf} of {n} selective_scan launches "
                                 f"took a bf16 u")
        print(f"serve {chk.name}: all {n} selective_scan launches took a bf16 u")
    launches = {k: run_launches[k] + serve_launches[k] + ssm_launches[k] + mla_launches[k]
                for k in run_launches}
    profile_float_serve(dev, smoke.ARCH, smoke.SERVE_FULL)
    profile_float_serve(dev, smoke.SSM_ARCH, smoke.SSM_SERVE_FULL)
    profile_float_serve(dev, smoke.MLA_ARCH, smoke.MLA_SERVE_FULL, n_layers=smoke.MLA_LAYERS)
    gc.collect()

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = (check_kernels(result, launches, dev) + check_attention(sres, launches, dev)
            + check_mla(mres, launches, dev) + check_scan(ssres, launches, dev))
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
