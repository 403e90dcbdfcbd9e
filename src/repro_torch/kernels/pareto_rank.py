"""K1 wrapper: pairwise constrained-Pareto dominance matrix.

Replaces ``repro/kernels/pareto_rank.py:dominance_matrix_pallas``; the
kernel is ``csrc/dominance.cu``.  A CUDA tensor goes to the kernel (or
the call raises); a CPU tensor goes to the plain version in ``ref``.
The kernel's geometry is ``plan``'s.
"""
from __future__ import annotations

import torch

from . import cuda_lib, ref

CHUNK_FLOATS = 8192     # a CTA's shared-memory chunk of objective rows and violations: 32 KB


def plan(P: int, M: int) -> tuple[int, int, bool]:
    """The kernel's geometry: (jc, wj, stage_f).  A CTA is 4 warps, each 8
    rows i x 4 slots of 16 consecutive j; wj of them lie along j (1, 2 or
    4: the least power of two whose slots cover P's 16-column groups, at
    most 4) and the rest along i, so a CTA takes 32 // wj rows.  It stages
    jc rows of v, and of F where 16 of F's rows and v's fit 8192 floats
    (stage_f; else F is read from global memory), at a time: jc a
    multiple of 16, as many 16-row groups as the chunk holds, at least
    one, and no more than P needs."""
    groups = max(1, -(-P // 16))
    wj = min(4, 1 << (-(-groups // 4) - 1).bit_length())
    stage_f = 16 * (M + 1) <= CHUNK_FLOATS
    jc = 16 * min(groups, CHUNK_FLOATS // (16 * ((M if stage_f else 0) + 1)))
    return jc, wj, stage_f


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
    jc, wj, stage_f = plan(P, M)
    if S * -(-P // (32 // wj)) >= 2**31:
        raise ValueError(f"dominance: {S} scenarios of {P} rows exceed the launch grid")
    out = torch.empty((S, P, P), dtype=torch.uint8, device=F.device)
    status = cuda_lib.lib().dominance_launch(
        Fb.data_ptr(), None if v is None else v.data_ptr(), out.data_ptr(),
        S, P, M, jc, wj, int(stage_f), F.device.index or 0, torch.cuda.current_stream(F.device).cuda_stream,
    )
    cuda_lib.check(status, "dominance")
    cuda_lib.launches["dominance"] += 1
    out = out.view(torch.bool)
    return out if batched else out[0]
