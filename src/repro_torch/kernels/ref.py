"""Plain PyTorch versions of the hand-written kernels.

Each is written *differently* from its kernel, as the reference's
oracles are (``repro.kernels.ref``), so that agreement means something:

  * dominance_matrix_ref: broadcasted tensor comparisons.
  * dcim_mvm_ref: the bit-serial decomposition as float64 matmuls
    (``torch.matmul`` has no int32 product on CUDA).  Every plane x slice
    dot is an integer of magnitude <= K * 2^max(B_x, B_w) << 2^53, so the
    float64 product is exact; shifts and sums run in int64 and wrap to
    int32 at the end, which is what int32 arithmetic gives.
  * fp_prealign_ref: mantissa/exponent via ``torch.frexp`` instead of
    the kernel's int32 bit-twiddling.

The CPU tests use them, and ``chip_smoke.py`` holds each kernel against
them on the card.  The same code runs on either device.
"""
from __future__ import annotations

import torch


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


def dcim_mvm_ref(x, w, B_x=8, B_w=8, k=4, x_signed=True, w_signed=True):
    """The bit-serial dataflow (slices x bit-planes + two's-complement
    corrections): x (..., M, K) @ w (..., K, N) -> (..., M, N) int32."""
    x = x.to(torch.int64)
    w = w.to(torch.int64)
    U = x & ((1 << B_x) - 1)
    V = w & ((1 << B_w) - 1)

    def dot(a, b):
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int64)

    n_slices = -(-B_x // k)
    # All k-bit slices of U stacked on a leading axis: (n_slices, ..., M, K).
    slices = torch.stack(
        [(U >> (s * k)) & ((1 << k) - 1) for s in range(n_slices)]
    )
    acc = torch.zeros(x.shape[:-1] + w.shape[-1:], dtype=torch.int64, device=x.device)
    for b in range(B_w):
        per_slice = dot(slices, ((V >> b) & 1).unsqueeze(0))
        for s in range(n_slices):
            acc = _shift_add(acc, per_slice[s], b + s * k)
    neg_w = (w < 0).to(torch.int64)
    neg_x = (x < 0).to(torch.int64)
    if w_signed:
        acc = _shift_add(acc, dot(U, neg_w), B_w, -1)
    if x_signed:
        acc = _shift_add(acc, dot(neg_x, V), B_x, -1)
        if w_signed:
            acc = _shift_add(acc, dot(neg_x, neg_w), B_x + B_w)
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
