"""K2 wrapper: the DCIM macro's exact integer matmul.

Replaces ``repro/kernels/dcim_mvm.py:dcim_mvm_pallas``; the kernel is
``csrc/dcim_mvm.cu``.  A CUDA tensor goes to the kernel (or the call
raises); a CPU tensor goes to the plain version in ``ref``, which keeps
the TPU kernel's bit-serial decomposition (weight bit-planes x k-bit
input slices + two's-complement corrections) as the specification.

The function, for any int32 ``x`` and ``w`` and widths B_x, B_w <= 24:

    X' = (x & (2^B_x - 1)) - (x_signed and x < 0 ? 2^B_x : 0)
    W' = (w & (2^B_w - 1)) - (w_signed and w < 0 ? 2^B_w : 0)
    Y  = X' @ W'  mod 2^32, read as int32

For in-range codes that is x @ w, exact while |x @ w| < 2^31
(guaranteed when K * 2^(B_x + B_w) < 2^31).  ``k`` (the macro's input
bits per cycle) does not change Y; its range (1..16) is still checked.

The kernel computes Y by balanced base-256 digits on the int8 tensor
cores: X', in [-2^B_x, 2^B_x - 1], has D_x digits, each an s8 (digit i
is byte i of (X' + bias) ^ bias, bias = 0x80 in each of the D_x low
bytes), D_x being the least D with 127 (256^D - 1) / 255 >= 2^B_x - 1
(1 up to 7 bits, 2 up to 14, 3 up to 22, 4 for 23 and 24); the same for
W'.  Then Y = sum over i + j < 4 of
(d^x_i @ d^w_j) << 8(i + j) mod 2^32, each digit product one
``mma.sync`` .s8.s8 with s32 accumulation that wraps (no saturation:
only Y mod 2^32 matters).  4 products for int8 x int8 and for the bf16
path's 9-bit mantissas, 8 for int16, at most 10.  On an H100 it is bound
by reading the int32 codes; it tiles 16 rows where M <= 16 (decode) and
64 above, and splits K across blocks, adding the
partials with atomics (bitwise the same in any order, mod 2^32), where
the output tiles alone would leave SMs idle.  Still one launch a call.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib, ref

MAX_BITS = 24   # csrc/dcim_mvm.cu: MAX_BITS
MAX_K = 16      # the macro's k; kept as the TPU kernel's contract


def dcim_mvm(
    x: torch.Tensor,
    w: torch.Tensor,
    B_x: int = 8,
    B_w: int = 8,
    k: int = 4,
    x_signed: bool = True,
    w_signed: bool = True,
) -> torch.Tensor:
    """x (M, K) or (Bt, M, K) int32 @ w (K, N) or (Bt, K, N) int32 ->
    (M, N) or (Bt, M, N) int32, exact modulo 2^32."""
    if not x.is_cuda:
        return ref.dcim_mvm_ref(x, w, B_x=B_x, B_w=B_w, k=k,
                                x_signed=x_signed, w_signed=w_signed)
    if x.dtype != torch.int32 or w.dtype != torch.int32:
        raise ValueError(f"dcim_mvm: int32 operands required, got {x.dtype}, {w.dtype}")
    if w.device != x.device:
        raise ValueError("dcim_mvm: x and w on different devices")
    if x.dim() != w.dim() or x.dim() not in (2, 3):
        raise ValueError(f"dcim_mvm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (1 <= B_x <= MAX_BITS and 1 <= B_w <= MAX_BITS and 1 <= k <= MAX_K):
        raise ValueError(f"dcim_mvm: B_x={B_x}, B_w={B_w}, k={k} outside the kernel's range")
    batched = x.dim() == 3
    xb = x if batched else x.unsqueeze(0)
    wb = w if batched else w.unsqueeze(0)
    Bt, M, K = xb.shape
    Bt2, K2, N = wb.shape
    if Bt != Bt2 or K != K2:
        raise ValueError(f"dcim_mvm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (xb.is_contiguous() and wb.is_contiguous()):
        raise ValueError("dcim_mvm: contiguous operands required")
    # Split-K launches add into this output; the launch function zeroes
    # it on the stream first.
    out = torch.empty((Bt, M, N), dtype=torch.int32, device=x.device)
    status = cuda_lib.lib().dcim_mvm_launch(
        xb.data_ptr(), wb.data_ptr(), out.data_ptr(), Bt, M, K, N,
        B_x, B_w, k, int(x_signed), int(w_signed),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(status, "dcim_mvm")
    cuda_lib.launches["dcim_mvm"] += 1
    return out if batched else out[0]


def plan(Bt: int, M: int, K: int, N: int, B_x: int, B_w: int,
         device: torch.device) -> tuple[int, int]:
    """The kernel's launch plan for these sizes on ``device``: (8-bit digit
    products per k-step, K-splits).  A query of ``csrc/dcim_mvm.cu``; it
    launches nothing."""
    products, splits = ctypes.c_int(), ctypes.c_int()
    cuda_lib.lib().dcim_mvm_plan(Bt, M, K, N, B_x, B_w, device.index or 0,
                                 ctypes.byref(products), ctypes.byref(splits))
    return products.value, splits.value
