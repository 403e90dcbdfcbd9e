"""Public entry points to the kernels, and the FP-DCIM composition.

Dispatch is by the tensor's device and nothing else: a CUDA tensor goes
to the hand-written kernel (``pareto_rank``, ``dcim_mvm``,
``fp_prealign``, ``paged_decode_gqa``, ``prefix_prefill``,
``paged_decode_mla``, ``selective_scan``, built from ``csrc/``), a CPU
tensor to the kernel's plain PyTorch version (``ref``).  There is no
backend switch and no fallback: a kernel that cannot launch raises.
"""
from __future__ import annotations

import math

import torch

from ..analysis.scopes import in_call
from .dcim_mvm import dcim_mvm
from .fp_prealign import fp_prealign as _fp_prealign_groups
from .paged_attention import (  # noqa: F401  (re-export)
    paged_decode_gqa,
    paged_decode_mla,
    prefix_prefill,
)
from .pareto_rank import dominance_matrix  # noqa: F401  (re-export)
from .selective_scan import selective_scan  # noqa: F401  (re-export)

# Byte budget of one chunk of (G, M, Nc) int32 group partials in
# ``dcim_fp_matmul``.  The partials of the whole output would be
# G*M*N*4 bytes — 80 GB for a 2048 x 151936 weight at H = 2 and M = 128.
PARTIAL_BYTES = 1 << 29


@in_call("fp_prealign")
def fp_prealign(x: torch.Tensor, H: int, B_M: int = 8):
    """x (M, K) f32, groups of H along K -> (mant (M, G, H) int32, group
    biased exponents (M, G) int32)."""
    M, K = x.shape
    if K % H:
        raise ValueError(f"K={K} not divisible by group height H={H}")
    xg = x.to(torch.float32).reshape(M, K // H, H).contiguous()
    return _fp_prealign_groups(xg, B_M=B_M)


def _group_partials(mx, mw, B_M, B_w, k, narrow):
    """Per-group integer MACs: mx (G, M, H) @ mw (G, H, Nc) int32 mantissas
    -> (G, M, Nc) float32 partial sums, one batched dcim_mvm per term."""
    if narrow:
        # Exact in int32: the hardware's B_r-wide accumulator fits.
        return dcim_mvm(mx, mw, B_x=B_M + 1, B_w=B_w + 1, k=k).to(torch.float32)
    # Wide-mantissa path (FP32): split each mantissa into a signed high
    # half and an unsigned 12-bit low half; 4 partial integer matmuls
    # emulate the hardware's B_r-wide adder.  The 2^24/2^12 recombination
    # happens in f32 (one extra rounding vs hardware, bounded by 2^-24
    # relative), in the reference's order.
    SPLIT = 12
    xh, xl = (mx >> SPLIT).contiguous(), (mx & ((1 << SPLIT) - 1)).contiguous()
    wh, wl = (mw >> SPLIT).contiguous(), (mw & ((1 << SPLIT) - 1)).contiguous()

    def mm(a, b, bx, bw, xs, ws):
        return dcim_mvm(a, b, B_x=bx, B_w=bw, k=k, x_signed=xs, w_signed=ws).to(torch.float32)

    hi_bits = max(B_M, B_w) + 1 - SPLIT + 1
    p_hh = mm(xh, wh, hi_bits, hi_bits, True, True)
    p_hl = mm(xh, wl, hi_bits, SPLIT, True, False)
    p_lh = mm(xl, wh, SPLIT, hi_bits, False, True)
    p_ll = mm(xl, wl, SPLIT, SPLIT, False, False)
    return p_hh * float(2 ** (2 * SPLIT)) + (p_hl + p_lh) * float(2**SPLIT) + p_ll


@in_call("dcim_fp_matmul")
def dcim_fp_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    H: int = 64,
    B_M: int = 8,
    B_w: int = 8,
    k: int = 4,
) -> torch.Tensor:
    """Full pre-aligned FP-DCIM pipeline (paper Fig. 3), end to end:

      1. online: pre-align input mantissas per H-group along K,
      2. offline: pre-align weight mantissas per H-group along K,
      3. integer mantissa MAC in the DCIM array (dcim_mvm, all G groups
         as one batch),
      4. INT->FP conversion: scale each group's integer partial sum by
         2^(ex + ew) and accumulate in f32.

    x: (M, K) f32;  w: (K, N) f32;  returns (M, N) f32 approximating x @ w
    with block-FP (shared-group-exponent) numerics.  Output columns are
    produced in chunks whose (G, M, Nc) partials fit ``PARTIAL_BYTES``;
    each column's sum over G does not depend on the chunking.
    """
    M, K = x.shape
    K2, N = w.shape
    if K != K2 or K % H:
        raise ValueError(f"dcim_fp_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}, H={H}")
    G = K // H

    narrow = (B_M + 1) + (B_w + 1) + math.ceil(math.log2(H)) <= 31
    if not narrow:
        SPLIT = 12
        # Operand magnitudes: |hi| <= 2^(B-SPLIT), lo < 2^SPLIT.
        worst = 2 ** (2 * max(max(B_M, B_w) - SPLIT, SPLIT))
        if H * worst > 2**31:
            raise ValueError(
                f"H={H} too large for wide-mantissa emulation (B_M={B_M})"
            )

    mant_x, ex = fp_prealign(x, H, B_M)                  # (M,G,H), (M,G)
    mant_w, ew = fp_prealign(w.t(), H, B_w)              # (N,G,H), (N,G)
    mx = mant_x.permute(1, 0, 2).contiguous()            # (G, M, H)
    ex_g = ex.t().to(torch.float32).unsqueeze(-1)        # (G, M, 1)
    bias = 2 * 127 + (B_M - 1) + (B_w - 1)

    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    chunk = max(1, PARTIAL_BYTES // max(1, G * M * 4))
    for n0 in range(0, N, chunk):
        n1 = min(N, n0 + chunk)
        mw = mant_w[n0:n1].permute(1, 2, 0).contiguous()  # (G, H, Nc)
        partials = _group_partials(mx, mw, B_M, B_w, k, narrow)
        # INT->FP converter: 2^(ex+ew) group scale, remove the two mantissa
        # fixed-point offsets (B_M-1 / B_w-1) and the two IEEE biases (127).
        scale = torch.exp2(ex_g + ew[n0:n1].t().to(torch.float32).unsqueeze(1) - bias)
        out[:, n0:n1] = torch.sum(partials * scale, dim=0)
    return out


# Each kernel's bar against its plain version (``chip_smoke.py`` and the
# kernels lint hold them to these).  K4/K5 on bf16 operands: the kernels
# round the unnormalised softmax weights to bf16, the plain versions the
# normalised ones, one bf16 ulp (2^-8) apart per weight at most.
ATTN_TOL = 2e-2
# K7, both in float32: exp2 of dt * (A log2 e) on the SFUs against expf,
# with and without a fused multiply-add and the N-sum in another order, a
# few ulps of |y| <= ~5 apart; the recurrence contracts, so they do not
# grow along S.
SCAN_TOL = 1e-5
# K6: the split walk's products are exact bf16 planes, so it and its plain
# version differ by summation order and the online softmax's rescaling, a
# few float32 ulps of outputs of magnitude ~1-3.
MLA_TOL = 1e-5


# ------------------------------ lint contract --------------------------------
from ..analysis.registry import Built, KernelTrace, register_contract  # noqa: E402


@register_contract(
    "kernels.cuda",
    checks=("kernels", "precision"),
    description="all seven hand-written kernels at ragged shapes (the reference's Pallas "
                "contract's, plus K6 at a smoke MLA shape): on the card each wrapper must "
                "launch its kernel and write its whole output (poisoned blocks, held to the "
                "plain version: K1-K3 bitwise, K4/K5 ATTN_TOL, K6 MLA_TOL, K7 SCAN_TOL); "
                "the plain versions must hold kernel-level precision hygiene (no f64, "
                "integer products at 32 bits or more, low-precision products accumulating "
                "in f32; register upcasts are idiomatic, so the widening audit is off)",
)
def _build_kernels_contract(device) -> Built:
    from ..analysis.op_trace import record
    from ..analysis.registry import PrecisionPolicy
    from . import ref
    from .fp_prealign import fp_prealign as fp_prealign_groups

    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype).to(device)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32).to(device)

    # K4-K6: two slots of nb = 3 pages of 8 rows, slot b's pages 1 + 3b..3 + 3b.
    Bd, Hk, G, hd, page, nb = 2, 2, 4, 128, 8, 3
    btab = (1 + torch.arange(Bd * nb, dtype=torch.int32).reshape(Bd, nb)).to(device)
    pos = torch.tensor([13, 21], dtype=torch.int32).to(device)
    T, L = 8, 16
    r, dr, H = 16, 8, 4                     # deepseek-v3-671b's smoke MLA widths
    traces = [
        KernelTrace("pareto_rank.dominance_matrix", "dominance", dominance_matrix,
                    ref.dominance_matrix_ref, (randn(130, 4),)),
        KernelTrace("dcim_mvm.dcim_mvm", "dcim_mvm",
                    lambda a, b: dcim_mvm(a, b, B_x=8, B_w=8, k=4),
                    lambda a, b: ref.dcim_mvm_ref(a, b, B_x=8, B_w=8, k=4),
                    (randint(-127, 128, 32, 64), randint(-127, 128, 64, 16))),
        KernelTrace("fp_prealign.fp_prealign", "fp_prealign",
                    lambda a: fp_prealign_groups(a, B_M=8),
                    lambda a: ref.fp_prealign_ref(a, B_M=8), (randn(10, 3, 64),)),
        KernelTrace("selective_scan.selective_scan", "selective_scan", selective_scan,
                    ref.selective_scan_ref,
                    (randn(2, 64, 128), randn(2, 64, 128).abs() * 0.1, randn(2, 64, 16),
                     randn(2, 64, 16), -randn(128, 16).abs(), randn(128)), SCAN_TOL),
        KernelTrace("paged_attention.paged_decode_gqa", "paged_decode_gqa", paged_decode_gqa,
                    ref.paged_decode_gqa_ref,
                    (randn(Bd, 1, Hk * G, hd),
                     randn(nb * Bd + 1, page, Hk, hd, dtype=torch.bfloat16),
                     randn(nb * Bd + 1, page, Hk, hd, dtype=torch.bfloat16), btab, pos),
                    ATTN_TOL),
        KernelTrace("paged_attention.prefix_prefill", "prefix_prefill", prefix_prefill,
                    ref.prefix_prefill_ref,
                    (randn(Bd, T, Hk * G, hd), randn(Bd, L, Hk, hd, dtype=torch.bfloat16),
                     randn(Bd, L, Hk, hd, dtype=torch.bfloat16),
                     randn(Bd, T, Hk, hd, dtype=torch.bfloat16),
                     randn(Bd, T, Hk, hd, dtype=torch.bfloat16),
                     torch.tensor([16, 5], dtype=torch.int32).to(device)),
                    ATTN_TOL),
        KernelTrace("paged_attention.paged_decode_mla", "paged_decode_mla",
                    lambda *a: paged_decode_mla(*a, 0.2), lambda *a: ref.paged_decode_mla_ref(*a, 0.2),
                    (randn(Bd, 1, H, r), randn(Bd, 1, H, dr),
                     randn(nb * Bd + 1, page, r, dtype=torch.bfloat16),
                     randn(nb * Bd + 1, page, dr, dtype=torch.bfloat16), btab, pos),
                    MLA_TOL),
    ]
    programs = [(f"plain:{t.label}", record(t.plain, *t.inputs)) for t in traces]
    return Built(kernels=traces, programs=programs, precision=PrecisionPolicy(
        compute_dtype="float32", audit_widening=False,
    ))
