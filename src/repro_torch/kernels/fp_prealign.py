"""K3 wrapper: floating-point pre-alignment per H-group.

Replaces ``repro/kernels/fp_prealign.py:fp_prealign_pallas``; the kernel
is ``csrc/fp_prealign.cu``.  A CUDA tensor goes to the kernel (or the
call raises); a CPU tensor goes to the plain version in ``ref``.
"""
from __future__ import annotations

import torch

from . import cuda_lib, ref


def fp_prealign(x: torch.Tensor, B_M: int = 8):
    """x (M, G, H) float32 -> (aligned int32 mantissas (M, G, H), biased
    group exponents (M, G) int32)."""
    if not x.is_cuda:
        return ref.fp_prealign_ref(x, B_M=B_M)
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"fp_prealign: float32 (M, G, H) required, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("fp_prealign: contiguous input required")
    if not 1 <= B_M <= 24:
        raise ValueError(f"fp_prealign: B_M={B_M} outside [1, 24]")
    M, G, H = x.shape
    if M * G * min(H, 32) >= 2**31 * 256:
        raise ValueError("fp_prealign: input exceeds the launch grid")
    mant = torch.empty((M, G, H), dtype=torch.int32, device=x.device)
    emax = torch.empty((M, G), dtype=torch.int32, device=x.device)
    status = cuda_lib.lib().fp_prealign_launch(
        x.data_ptr(), mant.data_ptr(), emax.data_ptr(), M * G, H, B_M,
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_lib.check(status, "fp_prealign")
    cuda_lib.launches["fp_prealign"] += 1
    return mant, emax
