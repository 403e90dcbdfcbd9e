"""K4, K5 and K6 wrappers: paged GQA decode, [context ; causal tail]
prefill attention, and paged absorbed-MLA decode.

Replace ``repro/kernels/paged_attention.py:paged_decode_gqa_pallas``,
``prefix_prefill_pallas`` and ``paged_decode_mla_pallas``; the kernels
are ``csrc/paged_decode_gqa.cu``, ``csrc/prefix_prefill.cu`` and
``csrc/paged_decode_mla.cu``.  A CUDA tensor goes to the kernel (or the
call raises: an unsupported dtype, a non-contiguous operand, KV heads
that do not divide the query heads, dims past a kernel's limit); a CPU
tensor goes to the plain version in ``ref``.  q and the K/V operands are
each float32 or bfloat16 (K6's q_abs float32); the output is float32.
"""
from __future__ import annotations

import math

import torch

from . import cuda_lib, ref

_TYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
ROWS_PER_CTA = 64     # K5: a CTA holds Tt * G <= 64 query rows (shared memory)
MAX_RANK = 1024       # K6: c_kv rank, 32 registers a lane
MAX_ROPE_DIM = 128    # K6: k_rope width, 4 registers a lane


def _check(name, tensors, kv):
    """Same device, contiguous, float32/bfloat16 operands; the K/V ones
    (``kv``) of one dtype."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous operands required")
    for t in [tensors[0], *kv]:
        if t.dtype not in _TYPES:
            raise ValueError(f"{name}: float32 or bfloat16 operands required, got {t.dtype}")
    if any(t.dtype != kv[0].dtype for t in kv):
        raise ValueError(f"{name}: K and V operands must share a dtype")


def _check_heads(name, H, Hk, hd, hdv):
    if Hk < 1 or H % Hk:
        raise ValueError(f"{name}: {Hk} KV heads do not divide {H} query heads")
    if not (1 <= hd <= MAX_HEAD_DIM and 1 <= hdv <= MAX_HEAD_DIM):
        raise ValueError(f"{name}: head dims {hd}/{hdv} outside 1..{MAX_HEAD_DIM}")


def _int32(name, t, shape, dev):
    if (t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"{name}: contiguous int32 {shape} on {dev} required, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t


def paged_decode_gqa(q, k_pages, v_pages, block_table, pos):
    """q (B, 1, H, hd) against the pages (n_pages, page, Hk, hd[v]) named
    by ``block_table`` (B, nb) int32, keys s <= pos[b] ((B,) int32) ->
    (B, 1, H, hdv) float32."""
    if not q.is_cuda:
        return ref.paged_decode_gqa_ref(q, k_pages, v_pages, block_table, pos)
    name = "paged_decode_gqa"
    _check(name, [q, k_pages, v_pages], [k_pages, v_pages])
    if q.dim() != 4 or q.shape[1] != 1 or k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError(f"{name}: q (B, 1, H, hd) and pages (n, page, Hk, hd) required")
    B, _, H, hd = q.shape
    n_pages, page, Hk, hd_k = k_pages.shape
    hdv = v_pages.shape[-1]
    if hd_k != hd or tuple(v_pages.shape[:3]) != (n_pages, page, Hk):
        raise ValueError(f"{name}: pages {tuple(k_pages.shape)} / {tuple(v_pages.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    _check_heads(name, H, Hk, hd, hdv)
    nb = block_table.shape[-1]
    bt = _int32(name, block_table, (B, nb), q.device)
    ps = _int32(name, pos, (B,), q.device)
    out = torch.empty((B, 1, H, hdv), dtype=torch.float32, device=q.device)
    status = cuda_lib.lib().paged_decode_gqa_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(), ps.data_ptr(),
        out.data_ptr(), B, H, Hk, hd, hdv, page, nb, n_pages, 1.0 / math.sqrt(hd),
        int(q.dtype == torch.bfloat16), int(k_pages.dtype == torch.bfloat16),
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_lib.check(status, name)
    cuda_lib.launches[name] += 1
    return out


def prefix_prefill(q, k_ctx, v_ctx, k_tail, v_tail, ctx_len):
    """q (B, T, H, hd) tail queries against ``[context ; causal tail]``:
    k/v_ctx (B, L, Hk, hd[v]) or None (L = 0), k/v_tail (B, T, Hk, hd[v]),
    ctx_len (B,) int32 valid context rows -> (B, T, H, hdv) float32."""
    if not q.is_cuda:
        return ref.prefix_prefill_ref(q, k_ctx, v_ctx, k_tail, v_tail, ctx_len)
    name = "prefix_prefill"
    if (k_ctx is None) != (v_ctx is None):
        raise ValueError(f"{name}: pass both context operands or neither")
    kv = [k_tail, v_tail] + ([] if k_ctx is None else [k_ctx, v_ctx])
    _check(name, [q, *kv], kv)
    if any(t.dim() != 4 for t in [q, *kv]):
        raise ValueError(f"{name}: (B, S, heads, dim) operands required")
    B, T, H, hd = q.shape
    Hk, hdv = k_tail.shape[2], v_tail.shape[-1]
    L = 0 if k_ctx is None else k_ctx.shape[1]
    if (tuple(k_tail.shape) != (B, T, Hk, hd) or tuple(v_tail.shape[:3]) != (B, T, Hk)
            or (L and (tuple(k_ctx.shape) != (B, L, Hk, hd)
                       or tuple(v_ctx.shape) != (B, L, Hk, hdv)))):
        raise ValueError(f"{name}: K/V shapes do not fit q {tuple(q.shape)}")
    _check_heads(name, H, Hk, hd, hdv)
    if B > 65535:
        raise ValueError(f"{name}: batch {B} exceeds the grid's limit")
    cl = _int32(name, ctx_len, (B,), q.device)
    Tt = max(1, min(T, ROWS_PER_CTA // (H // Hk)))
    out = torch.empty((B, T, H, hdv), dtype=torch.float32, device=q.device)
    status = cuda_lib.lib().prefix_prefill_launch(
        q.data_ptr(), None if k_ctx is None else k_ctx.data_ptr(),
        None if v_ctx is None else v_ctx.data_ptr(), k_tail.data_ptr(), v_tail.data_ptr(),
        cl.data_ptr(), out.data_ptr(), B, T, L, H, Hk, hd, hdv, Tt, 1.0 / math.sqrt(hd),
        int(q.dtype == torch.bfloat16), int(k_tail.dtype == torch.bfloat16),
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_lib.check(status, name)
    cuda_lib.launches[name] += 1
    return out


def paged_decode_mla(q_abs, q_rope, ckv_pages, krope_pages, block_table, pos, scale: float):
    """Absorbed MLA decode in the compressed c_kv space: q_abs (B, 1, H,
    r) float32 and q_rope (B, 1, H, dr) against the pages (n_pages, page,
    r) / (n_pages, page, dr) named by ``block_table`` (B, nb) int32, keys
    j <= pos[b] ((B,) int32), scores ``(q_abs . c + q_rope . k_rope) *
    scale`` -> the (B, 1, H, r) float32 context."""
    if not q_abs.is_cuda:
        return ref.paged_decode_mla_ref(q_abs, q_rope, ckv_pages, krope_pages, block_table,
                                        pos, scale)
    name = "paged_decode_mla"
    _check(name, [q_abs, q_rope, ckv_pages, krope_pages], [ckv_pages, krope_pages])
    if q_abs.dtype != torch.float32 or q_rope.dtype not in _TYPES:
        raise ValueError(f"{name}: float32 q_abs and float32/bfloat16 q_rope required, got "
                         f"{q_abs.dtype} / {q_rope.dtype}")
    if (q_abs.dim() != 4 or q_abs.shape[1] != 1 or q_rope.dim() != 4
            or ckv_pages.dim() != 3 or krope_pages.dim() != 3):
        raise ValueError(f"{name}: q (B, 1, H, r|dr) and pages (n, page, r|dr) required")
    B, _, H, r = q_abs.shape
    dr = q_rope.shape[-1]
    n_pages, page, _ = ckv_pages.shape
    if (tuple(q_rope.shape[:3]) != (B, 1, H) or tuple(ckv_pages.shape) != (n_pages, page, r)
            or tuple(krope_pages.shape) != (n_pages, page, dr)):
        raise ValueError(f"{name}: q_rope {tuple(q_rope.shape)}, pages "
                         f"{tuple(ckv_pages.shape)} / {tuple(krope_pages.shape)} do not fit "
                         f"q_abs {tuple(q_abs.shape)}")
    if not (1 <= r <= MAX_RANK and 1 <= dr <= MAX_ROPE_DIM):
        raise ValueError(f"{name}: rank {r} / rope dim {dr} outside 1..{MAX_RANK} / "
                         f"1..{MAX_ROPE_DIM}")
    nb = block_table.shape[-1]
    bt = _int32(name, block_table, (B, nb), q_abs.device)
    ps = _int32(name, pos, (B,), q_abs.device)
    out = torch.empty((B, 1, H, r), dtype=torch.float32, device=q_abs.device)
    status = cuda_lib.lib().paged_decode_mla_launch(
        q_abs.data_ptr(), q_rope.data_ptr(), ckv_pages.data_ptr(), krope_pages.data_ptr(),
        bt.data_ptr(), ps.data_ptr(), out.data_ptr(), B, H, r, dr, page, nb, n_pages,
        float(scale), int(q_rope.dtype == torch.bfloat16),
        int(ckv_pages.dtype == torch.bfloat16), q_abs.device.index or 0,
        torch.cuda.current_stream(q_abs.device).cuda_stream,
    )
    cuda_lib.check(status, name)
    cuda_lib.launches[name] += 1
    return out
