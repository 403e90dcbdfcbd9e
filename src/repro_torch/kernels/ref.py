"""Plain PyTorch versions of the hand-written kernels.

Each is written *differently* from its kernel, as the reference's
oracles are (``repro.kernels.ref``), so that agreement means something:

  * dominance_matrix_ref: broadcasted tensor comparisons.
  * dcim_mvm_ref: the bit-serial decomposition as exact integer
    products (``_int_dot``): int64 matmuls on the CPU; on the card, which
    has no integer ``torch.matmul``, float32 matmuls of 8-bit digits over
    K in chunks of 2^16, every partial sum an integer below 2^24 and so
    exact.  Shifts and sums run in int64 and wrap to int32 at the end,
    which is what int32 arithmetic gives.
  * fp_prealign_ref: mantissa/exponent via ``torch.frexp`` instead of
    the kernel's int32 bit-twiddling.
  * paged_decode_gqa_ref / prefix_prefill_ref / paged_decode_mla_ref:
    gather the pages (or concatenate context and tail) into contiguous
    K/V, then one full masked softmax over every key
    (``decode_attention`` / ``prefix_attention`` / ``mla_attend_core``),
    where the kernels walk only the live keys with an online softmax.
  * selective_scan_ref: the recurrence as whole-batch tensor ops, one
    step of S at a time (the kernel gives each channel a thread that
    walks S with its state in registers).

The CPU tests use them, and ``chip_smoke.py`` holds each kernel against
them on the card.  The same code runs on either device.
"""
from __future__ import annotations

import math

import torch

from ..analysis.scopes import in_island


# --- pareto_rank -----------------------------------------------------------
def dominance_matrix_ref(F, violation=None):
    """F (..., P, M), violation (..., P) or None -> (..., P, P) bool."""
    F = F.to(torch.float32)
    F = torch.where(torch.isnan(F), torch.inf, F)
    le = torch.all(F.unsqueeze(-2) <= F.unsqueeze(-3), dim=-1)
    lt = torch.any(F.unsqueeze(-2) < F.unsqueeze(-3), dim=-1)
    pdom = le & lt
    if violation is None:
        return pdom
    v = violation.to(torch.float32)
    feas = v <= 0.0
    return (feas.unsqueeze(-1) & feas.unsqueeze(-2) & pdom) | (
        v.unsqueeze(-1) < v.unsqueeze(-2)
    )


# --- dcim_mvm ---------------------------------------------------------------
_MASK32 = 0xFFFFFFFF


def _shift_add(acc: torch.Tensor, term: torch.Tensor, shift: int, sign: int = 1):
    """``acc + sign * (term << shift)`` modulo 2^32, as int32 arithmetic
    gives it: a shift of 32 or more leaves nothing."""
    if shift >= 32:
        return acc
    return (acc + sign * (term << shift)) & _MASK32


_DIGIT = 8          # bits of a digit of the card's float32 product
_K_CHUNK = 1 << 16  # 2^16 * (2^8 - 1) < 2^24: a chunk's sums stay exact


def _int_dot(a: torch.Tensor, b: torch.Tensor, a_bits: int, b_bits: int) -> torch.Tensor:
    """The exact int64 product ``a @ b`` of non-negative int64 operands of
    at most ``a_bits`` and ``b_bits`` bits, one of them a bit (0 or 1):
    an int64 matmul on the CPU, :func:`int_dot_digits` on the card."""
    if not a.is_cuda:
        return torch.matmul(a, b)
    if a_bits < b_bits:
        return int_dot_digits(b.mT, a.mT, b_bits).mT
    return int_dot_digits(a, b, a_bits)


def int_dot_digits(a: torch.Tensor, bits: torch.Tensor, a_bits: int) -> torch.Tensor:
    """The exact int64 product of ``a`` (non-negative, at most ``a_bits``
    bits) and ``bits`` (0 or 1) by float32 matmuls: ``a`` in 8-bit digits
    and K in chunks of 2^16, so that every product sums to an integer
    below 2^24, exact in float32 (TF32 would round the operands to 11
    significant bits: the digits fit); the digits' products are added
    back in int64.  For the card, which has no integer ``torch.matmul``."""
    K = a.shape[-1]
    bf = bits.to(torch.float32)
    out = None
    for d in range(-(-a_bits // _DIGIT)):
        digit = ((a >> (d * _DIGIT)) & ((1 << _DIGIT) - 1)).to(torch.float32)
        for k0 in range(0, K, _K_CHUNK):
            p = torch.matmul(digit[..., k0:k0 + _K_CHUNK], bf[..., k0:k0 + _K_CHUNK, :])
            p = p.to(torch.int64) << (d * _DIGIT)
            out = p if out is None else out + p
    return out


def dcim_mvm_ref(x, w, B_x=8, B_w=8, k=4, x_signed=True, w_signed=True):
    """The bit-serial dataflow (slices x bit-planes + two's-complement
    corrections): x (..., M, K) @ w (..., K, N) -> (..., M, N) int32."""
    x = x.to(torch.int64)
    w = w.to(torch.int64)
    U = x & ((1 << B_x) - 1)
    V = w & ((1 << B_w) - 1)

    n_slices = -(-B_x // k)
    # All k-bit slices of U stacked on a leading axis: (n_slices, ..., M, K).
    slices = torch.stack(
        [(U >> (s * k)) & ((1 << k) - 1) for s in range(n_slices)]
    )
    acc = torch.zeros(x.shape[:-1] + w.shape[-1:], dtype=torch.int64, device=x.device)
    for b in range(B_w):
        per_slice = _int_dot(slices, ((V >> b) & 1).unsqueeze(0), k, 1)
        for s in range(n_slices):
            acc = _shift_add(acc, per_slice[s], b + s * k)
    neg_w = (w < 0).to(torch.int64)
    neg_x = (x < 0).to(torch.int64)
    if w_signed:
        acc = _shift_add(acc, _int_dot(U, neg_w, B_x, 1), B_w, -1)
    if x_signed:
        acc = _shift_add(acc, _int_dot(neg_x, V, 1, B_w), B_x, -1)
        if w_signed:
            acc = _shift_add(acc, _int_dot(neg_x, neg_w, 1, 1), B_x + B_w)
    # acc is in [0, 2^32): reinterpret as two's-complement int32.
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


# --- fp_prealign -------------------------------------------------------------
def fp_prealign_ref(x, B_M=8):
    """x (M, G, H) f32 -> aligned int32 mantissas + biased group exponents,
    via torch.frexp (no bit twiddling).  Subnormals flush to zero, matching
    the hardware datapath."""
    x = x.to(torch.float32)
    tiny = 2.0 ** -126
    is_zero = torch.abs(x) < tiny
    frac, e = torch.frexp(torch.where(is_zero, 1.0, x))   # |frac| in [0.5, 1)
    exp = torch.where(is_zero, 0, e + 126).to(torch.int32)  # IEEE biased exponent
    mant = torch.floor(torch.abs(frac) * (1 << B_M)).to(torch.int32)
    mant = torch.where(is_zero, 0, mant)
    mant = torch.where(x < 0, -mant, mant)
    emax = torch.max(exp, dim=-1).values
    shift = torch.clamp_max(emax.unsqueeze(-1) - exp, 31)
    # Arithmetic right shift == floor division by 2^shift.
    return (mant >> shift).to(torch.int32), emax.to(torch.int32)


def fp_matmul_f32_ref(x, w):
    """Plain float32 matmul — the accuracy yardstick for the pre-aligned
    block-FP pipeline (callers on the card set
    ``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


# --- attention -----------------------------------------------------------------
NEG_INF = -1e30


def _scaled(q: torch.Tensor) -> torch.Tensor:
    """q * (1/sqrt(hd)), rounded to q's dtype (as the reference's
    ``q * scale`` is)."""
    return q * (1.0 / math.sqrt(q.shape[-1]))


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """(n_pages, page, ...) pages + (B, nb) block table -> contiguous
    per-slot views (B, nb * page, ...)."""
    g = pages[block_table.long()]                     # (B, nb, page, ...)
    return g.reshape(g.shape[0], -1, *g.shape[3:])


@in_island("attn")
def decode_attention(q, k_cache, v_cache, pos):
    """q (B, 1, H, hd) at position ``pos`` (an int, or a (B,) tensor of
    per-row positions) against caches (B, S, Hk, hd[v]): keys s <= pos
    attended; scores and softmax in f32, the weights rounded to the V
    dtype before PV.  Returns (B, 1, H, hdv) f32."""
    B, _, H, hd = q.shape
    _, S, Hk, hdv = v_cache.shape
    G = H // Hk
    qg = _scaled(q).reshape(B, Hk, G, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float())
    ar = torch.arange(S, device=q.device)
    if torch.is_tensor(pos) and pos.dim() == 1:
        mask = (ar[None, :] <= pos[:, None])[:, None, None, :]      # (B, 1, 1, S)
    else:
        mask = (ar <= int(pos))[None, None, None]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return o.reshape(B, 1, H, hdv)


@in_island("attn")
def prefix_attention(q, k_all, v_all, ctx_len, L: int):
    """Tail-only prefill over a reused prefix: q (B, T, H, hd) against
    ``[context ; tail]`` keys (B, L + T, Hk, hd[v]); context column j
    valid where ``j < ctx_len[b]``, tail column c where ``c <= t``.  One
    plain masked softmax.  Returns (B, T, H, hdv) f32."""
    B, T, H, hd = q.shape
    Hk, hdv = k_all.shape[2], v_all.shape[-1]
    G = H // Hk
    qg = _scaled(q).reshape(B, T, Hk, G, hd)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k_all.float())   # (B, Hk, G, T, L+T)
    dev = q.device
    mask_ctx = torch.arange(L, device=dev)[None, :] < ctx_len[:, None].to(dev)    # (B, L)
    tt = torch.arange(T, device=dev)
    mask_tail = tt[None, :] <= tt[:, None]                                         # (T, T)
    mask = torch.cat([mask_ctx[:, None, :].expand(B, T, L),
                      mask_tail[None].expand(B, T, T)], dim=-1)                    # (B, T, L+T)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", p.to(v_all.dtype).float(), v_all.float())
    return o.reshape(B, T, H, hdv)


def paged_decode_gqa_ref(q, k_pages, v_pages, block_table, pos):
    """K4's function: gather the slot's pages, then ``decode_attention``."""
    return decode_attention(q, gather_pages(k_pages, block_table),
                            gather_pages(v_pages, block_table), pos)


def prefix_prefill_ref(q, k_ctx, v_ctx, k_tail, v_tail, ctx_len):
    """K5's function: concatenate context (None when L = 0) and tail,
    then ``prefix_attention``."""
    if k_ctx is None:
        return prefix_attention(q, k_tail, v_tail, ctx_len, 0)
    return prefix_attention(q, torch.cat([k_ctx, k_tail], dim=1),
                            torch.cat([v_ctx, v_tail], dim=1), ctx_len, k_ctx.shape[1])


@in_island("attn")
def mla_attend_core(q_abs, q_rope, ckv, krope, pos, scale: float):
    """The absorbed-MLA masked attend over contiguous cache views, in the
    compressed c_kv space: q_abs (B, q, H, r) and q_rope (B, q, H, dr)
    against ckv (B, S, r) / krope (B, S, dr); scores
    ``(q_abs . c + q_rope . k_rope) * scale`` (the scale after the sum),
    keys s <= pos masked in (``pos`` an int or a (B,) tensor), softmax
    and the context ``p . c`` in float32.  Returns the (B, q, H, r)
    float32 context (``w_uv`` stays with the caller)."""
    ckv = ckv.float()
    s = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), ckv)
         + torch.einsum("bqhd,bsd->bhqs", q_rope.float(), krope.float())) * scale
    ar = torch.arange(ckv.shape[1], device=ckv.device)
    if torch.is_tensor(pos) and pos.dim() == 1:
        mask = (ar[None, :] <= pos[:, None])[:, None, None, :]      # (B, 1, 1, S)
    else:
        mask = (ar <= int(pos))[None, None, None]
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    return torch.einsum("bhqs,bsr->bqhr", p, ckv)


def paged_decode_mla_ref(q_abs, q_rope, ckv_pages, krope_pages, block_table, pos,
                         scale: float):
    """K6's function: gather the slot's c_kv and k_rope pages, then
    ``mla_attend_core``."""
    return mla_attend_core(q_abs, q_rope, gather_pages(ckv_pages, block_table),
                           gather_pages(krope_pages, block_table), pos, scale)


# --- selective_scan --------------------------------------------------------------
def selective_scan_ref(u, dt, B_c, C_c, A, D_skip, h0=None):
    """The Mamba-1 recurrence, one step at a time, in float32:

        h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t ;  y_t = h_t . C_t + D u_t

    u, dt (B, S, D); B_c, C_c (B, S, N); A (D, N); D_skip (D,); h0
    (B, D, N) or None (zeros).  Returns (y (B, S, D), h_last (B, D, N))."""
    u = u.to(torch.float32)
    dt = dt.to(torch.float32)
    B_c = B_c.to(torch.float32)
    C_c = C_c.to(torch.float32)
    A = A.to(torch.float32)
    D_skip = D_skip.to(torch.float32)
    Bsz, S, D = u.shape
    N = B_c.shape[-1]
    h = (torch.zeros((Bsz, D, N), dtype=torch.float32, device=u.device) if h0 is None
         else h0.to(torch.float32))
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * u[:, t])[..., None] * B_c[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C_c[:, t]) + D_skip * u[:, t])
    y = torch.stack(ys, dim=1) if ys else u.new_zeros((Bsz, 0, D))
    return y, h
