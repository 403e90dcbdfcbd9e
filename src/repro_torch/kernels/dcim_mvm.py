"""K2 wrapper: exact integer matmul through the DCIM bit-serial dataflow.

Replaces ``repro/kernels/dcim_mvm.py:dcim_mvm_pallas``; the kernel is
``csrc/dcim_mvm.cu``.  A CUDA tensor goes to the kernel (or the call
raises); a CPU tensor goes to the plain version in ``ref``.

Validity range, as for the TPU kernel: the result is exact while
|x @ w| < 2^31 (it is computed modulo 2^32), guaranteed when
K * 2^(B_x + B_w) < 2^31.
"""
from __future__ import annotations

import torch

from . import cuda_lib, ref

MAX_BITS = 24   # csrc/dcim_mvm.cu: MAX_BITS
MAX_K = 16      # slices are staged as uint16


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
    (M, N) or (Bt, M, N) int32, through the bit-serial dataflow."""
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
    if Bt > 65535 or M > 65535 * 64:
        raise ValueError(f"dcim_mvm: batch {Bt} / rows {M} exceed the grid's limits")
    out = torch.empty((Bt, M, N), dtype=torch.int32, device=x.device)
    status = cuda_lib.lib().dcim_mvm_launch(
        xb.data_ptr(), wb.data_ptr(), out.data_ptr(), Bt, M, K, N,
        B_x, B_w, k, int(x_signed), int(w_signed),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(status, "dcim_mvm")
    cuda_lib.launches["dcim_mvm"] += 1
    return out if batched else out[0]
