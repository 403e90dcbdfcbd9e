"""K1 wrapper: pairwise constrained-Pareto dominance matrix.

Replaces ``repro/kernels/pareto_rank.py:dominance_matrix_pallas``; the
kernel is ``csrc/dominance.cu``.  A CUDA tensor goes to the kernel (or
the call raises); a CPU tensor goes to the plain version in ``ref``.
"""
from __future__ import annotations

import torch

from . import cuda_lib, ref


def dominance_matrix(F: torch.Tensor, violation: torch.Tensor | None = None) -> torch.Tensor:
    """F (P, M) or (S, P, M) objectives [+ violation (P,) / (S, P)] ->
    (P, P) / (S, P, P) bool, D[..., i, j] iff i constrained-dominates j."""
    if not F.is_cuda:
        return ref.dominance_matrix_ref(F, violation)
    if F.dtype != torch.float32 or F.dim() not in (2, 3):
        raise ValueError(f"dominance: F must be float32 (P, M) or (S, P, M), got {F.dtype} {tuple(F.shape)}")
    batched = F.dim() == 3
    Fb = (F if batched else F.unsqueeze(0)).contiguous()
    S, P, M = Fb.shape
    v = None
    if violation is not None:
        if violation.device != F.device or violation.dtype != torch.float32:
            raise ValueError("dominance: violation must be float32 on F's device")
        v = (violation if batched else violation.unsqueeze(0)).contiguous()
        if tuple(v.shape) != (S, P):
            raise ValueError(f"dominance: violation shape {tuple(violation.shape)} != {(S, P)[not batched:]}")
    if S > 65535:
        raise ValueError(f"dominance: {S} scenarios exceed the grid's z limit")
    out = torch.empty((S, P, P), dtype=torch.uint8, device=F.device)
    status = cuda_lib.lib().dominance_launch(
        Fb.data_ptr(), None if v is None else v.data_ptr(), out.data_ptr(),
        S, P, M, F.device.index or 0, torch.cuda.current_stream(F.device).cuda_stream,
    )
    cuda_lib.check(status, "dominance")
    cuda_lib.launches["dominance"] += 1
    out = out.view(torch.bool)
    return out if batched else out[0]
