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
Each of K4, K5 and K6 has two kernels in its source, chosen by dtype
alone.  K4 and K5: bf16 q, K and V take the tensor-core kernel (K4's
splits the page walk across CTAs and merges the partials in a second
launch), the pairs with a float32 operand the CUDA-core one.  K6: bf16
pages take the tensor-core split walk and its merge (the float32 q_abs,
and an f32 q_rope, cut into three exact bf16 planes), float32 pages the
CUDA-core kernel.
"""
from __future__ import annotations

import math

import torch

from ..analysis.scopes import in_call
from . import cuda_lib, ref

_TYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
ROWS_PER_CTA = 64     # K5's CUDA-core kernel: Tt * G <= 64 query rows a CTA (shared memory)
MAX_RANK = 1024       # K6: c_kv rank (the CUDA-core kernel: 32 registers a lane)
MAX_ROPE_DIM = 128    # K6: k_rope width (the CUDA-core kernel: 4 registers a lane)
DECODE_TILE_KEYS = 64  # K4's tensor-core kernel: keys a tile, 16 a warp
DECODE_ROWS = 16       # ... and query heads a CTA (one m16 row tile); K6's too
SMEM_PER_CTA = 232448  # an H100 block's shared memory at most (bytes)
SMEM_PER_SM = 233472   # an H100 SM's, of which 1 KB is reserved a CTA


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


def decode_split(B: int, Hk: int, G: int, page: int, nb: int, sms: int) -> int:
    """Pages a split of K4's tensor-core walk takes: enough splits that
    the CTAs (B * Hk * ceil(G / 16) a split) number about twice the SMs,
    each split at least one 64-key tile and no more splits than pages.
    From the shapes alone: reading ``pos`` on the host would sync."""
    ctas = B * Hk * -(-G // DECODE_ROWS)
    want = -(-2 * sms // ctas)
    return min(nb, max(-(-DECODE_TILE_KEYS // page), -(-nb // want)))


def mla_decode_plan(r: int, dr: int) -> tuple[int, int, int]:
    """(keys a tile, ring stages, shared-memory bytes a CTA) of K6's
    tensor-core split walk: three bf16 planes of 16 query rows of [q_abs ;
    q_rope] and the ring of tiles, rows of r + dr padded to 16 each plus
    8, and a 16 x (tk + 8) float32 score block.  64 keys a tile up to r
    512, 32 above (where the Q planes alone take half of it); two stages
    where they fit in a block's shared memory, else one."""
    tk = 64 if r <= 512 else 32
    w = -(-r // 16) * 16 + -(-dr // 16) * 16 + 8
    for stages in (2, 1):
        smem = 2 * w * (3 * DECODE_ROWS + stages * tk) + 4 * DECODE_ROWS * (tk + 8)
        if smem <= SMEM_PER_CTA:
            return tk, stages, smem
    raise ValueError(f"paged_decode_mla: rank {r} / rope dim {dr} do not fit a CTA")


def mla_decode_split(B: int, H: int, r: int, dr: int, page: int, nb: int, sms: int) -> int:
    """Pages a split of K6's tensor-core walk takes: enough splits that
    the CTAs (B * ceil(H / 16) a split) fill about two waves at the CTAs
    an SM that the shared memory allows, so that about one wave is live
    when the slots stand at half the pool; each split at least one tile
    and no more splits than pages.  From the shapes alone: reading
    ``pos`` on the host would sync."""
    tk, _, smem = mla_decode_plan(r, dr)
    per_sm = max(1, SMEM_PER_SM // (smem + 1024))
    ctas = B * -(-H // DECODE_ROWS)
    want = -(-2 * sms * per_sm // ctas)
    return min(nb, max(-(-tk // page), -(-nb // want)))


@in_call("paged_decode_gqa")
def paged_decode_gqa(q, k_pages, v_pages, block_table, pos):
    """q (B, 1, H, hd) against the pages (n_pages, page, Hk, hd[v]) named
    by ``block_table`` (B, nb) int32, keys s <= pos[b] ((B,) int32) ->
    (B, 1, H, hdv) float32.  On the card, bf16 q and pages launch the
    tensor-core split walk and its merge (counted also as
    ``paged_decode_gqa_mma``), any other pair the CUDA-core kernel."""
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
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(), ps.data_ptr())
    dev, stream = q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream
    mma = q.dtype == torch.bfloat16 and k_pages.dtype == torch.bfloat16
    if mma:
        pps = decode_split(B, Hk, H // Hk, page, nb,
                           torch.cuda.get_device_properties(q.device).multi_processor_count)
        splits = -(-nb // pps)
        ws = torch.empty(B * H * splits * (hdv + 2), dtype=torch.float32, device=q.device)
        status = cuda_lib.lib().paged_decode_gqa_mma_launch(
            *ptrs, ws.data_ptr(), out.data_ptr(), B, H, Hk, hd, hdv, page, nb, n_pages, pps,
            1.0 / math.sqrt(hd), dev, stream)
    else:
        status = cuda_lib.lib().paged_decode_gqa_launch(
            *ptrs, out.data_ptr(), B, H, Hk, hd, hdv, page, nb, n_pages, 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16), int(k_pages.dtype == torch.bfloat16), dev, stream)
    cuda_lib.check(status, name)
    cuda_lib.launches[name] += 1
    if mma:
        cuda_lib.launches["paged_decode_gqa_mma"] += 1
    return out


@in_call("prefix_prefill")
def prefix_prefill(q, k_ctx, v_ctx, k_tail, v_tail, ctx_len):
    """q (B, T, H, hd) tail queries against ``[context ; causal tail]``:
    k/v_ctx (B, L, Hk, hd[v]) or None (L = 0), k/v_tail (B, T, Hk, hd[v]),
    ctx_len (B,) int32 valid context rows -> (B, T, H, hdv) float32.
    On the card, bf16 q, K and V launch the tensor-core kernel (counted
    also as ``prefix_prefill_mma``), any other pair the CUDA-core one."""
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
    out = torch.empty((B, T, H, hdv), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), None if k_ctx is None else k_ctx.data_ptr(),
            None if v_ctx is None else v_ctx.data_ptr(), k_tail.data_ptr(), v_tail.data_ptr(),
            cl.data_ptr(), out.data_ptr())
    dev, stream = q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream
    mma = q.dtype == torch.bfloat16 and k_tail.dtype == torch.bfloat16
    if mma:
        status = cuda_lib.lib().prefix_prefill_mma_launch(
            *ptrs, B, T, L, H, Hk, hd, hdv, 1.0 / math.sqrt(hd), dev, stream)
    else:
        Tt = max(1, min(T, ROWS_PER_CTA // (H // Hk)))
        status = cuda_lib.lib().prefix_prefill_launch(
            *ptrs, B, T, L, H, Hk, hd, hdv, Tt, 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16), int(k_tail.dtype == torch.bfloat16), dev, stream)
    cuda_lib.check(status, name)
    cuda_lib.launches[name] += 1
    if mma:
        cuda_lib.launches["prefix_prefill_mma"] += 1
    return out


@in_call("paged_decode_mla")
def paged_decode_mla(q_abs, q_rope, ckv_pages, krope_pages, block_table, pos, scale: float):
    """Absorbed MLA decode in the compressed c_kv space: q_abs (B, 1, H,
    r) float32 and q_rope (B, 1, H, dr) against the pages (n_pages, page,
    r) / (n_pages, page, dr) named by ``block_table`` (B, nb) int32, keys
    j <= pos[b] ((B,) int32), scores ``(q_abs . c + q_rope . k_rope) *
    scale`` -> the (B, 1, H, r) float32 context.  On the card, bf16 pages
    launch the tensor-core split walk and its merge (counted also as
    ``paged_decode_mla_mma``), float32 pages the CUDA-core kernel."""
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
    ptrs = (q_abs.data_ptr(), q_rope.data_ptr(), ckv_pages.data_ptr(), krope_pages.data_ptr(),
            bt.data_ptr(), ps.data_ptr())
    qr_bf16 = int(q_rope.dtype == torch.bfloat16)
    dev, stream = q_abs.device.index or 0, torch.cuda.current_stream(q_abs.device).cuda_stream
    mma = ckv_pages.dtype == torch.bfloat16
    if mma:
        tk, stages, _ = mla_decode_plan(r, dr)
        pps = mla_decode_split(B, H, r, dr, page, nb,
                               torch.cuda.get_device_properties(q_abs.device).multi_processor_count)
        splits = -(-nb // pps)
        ws = torch.empty(B * splits * H * (r + 2), dtype=torch.float32, device=q_abs.device)
        status = cuda_lib.lib().paged_decode_mla_mma_launch(
            *ptrs, ws.data_ptr(), out.data_ptr(), B, H, r, dr, page, nb, n_pages, pps, tk,
            stages, float(scale), qr_bf16, dev, stream)
    else:
        status = cuda_lib.lib().paged_decode_mla_launch(
            *ptrs, out.data_ptr(), B, H, r, dr, page, nb, n_pages, float(scale), qr_bf16, dev,
            stream)
    cuda_lib.check(status, name)
    cuda_lib.launches[name] += 1
    if mma:
        cuda_lib.launches["paged_decode_mla_mma"] += 1
    return out
