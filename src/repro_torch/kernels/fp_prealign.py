"""K3 wrapper: floating-point pre-alignment per H-group.

Replaces ``repro/kernels/fp_prealign.py:fp_prealign_pallas``; the kernel
is ``csrc/fp_prealign.cu``.  A CUDA tensor goes to the kernel (or the
call raises); a CPU tensor goes to the plain version in ``ref``.

The kernel has two paths.  The vector path (``plan`` says which takes a
call) reads and writes 16-byte chunks of 4 elements: it takes H % 4 == 0
up to ``VEC_MAX_H`` with x's storage 16-byte aligned, which covers every
call of the compile path.  Every other input takes the scalar path, one
element a lane.
"""
from __future__ import annotations

import torch

from . import cuda_lib, ref

VEC_MAX_H = 2048        # 32 lanes x 16 chunks x 4 floats: the design space's largest H
_THREADS = 256          # a CTA of either path


def plan(H: int, x_aligned: bool = True) -> tuple[bool, int, int]:
    """The kernel's geometry for groups of H: (vector path?, log2 of the
    lanes a group, 16-byte chunks a lane).  The vector path gives a group
    ceil(H / 4) chunks, over L lanes (that count rounded up to a power of
    two, at most 32), NC chunks a lane (a power of two: 1 up to H = 128);
    the scalar path gives it L lanes of one element (H rounded up to a
    power of two, at most 32) and nc 0."""
    if H % 4 == 0 and H <= VEC_MAX_H and x_aligned:
        chunks = H // 4
        log_l = min(5, max(0, (chunks - 1).bit_length()))
        nc = 1 << max(0, (-(-chunks // 32) - 1).bit_length())
        return True, log_l, nc
    return False, min(5, max(0, (H - 1).bit_length())), 0


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
    R = M * G
    vec, log_l, nc = plan(H, x.data_ptr() % 16 == 0)
    # A vector CTA takes at least 8 groups (8 warps, one group each at 32
    # lanes); a scalar CTA 256 lanes of 2^log_l a group.
    blocks = -(-R // 8) if vec else -(-(R << log_l) // _THREADS)
    if blocks >= 2**31:
        raise ValueError("fp_prealign: input exceeds the launch grid")
    mant = torch.empty((M, G, H), dtype=torch.int32, device=x.device)
    emax = torch.empty((M, G), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    device = x.device.index or 0
    if vec:
        status = cuda_lib.lib().fp_prealign_vec_launch(
            x.data_ptr(), mant.data_ptr(), emax.data_ptr(), R, H, B_M, log_l, nc, device, stream)
    else:
        status = cuda_lib.lib().fp_prealign_launch(
            x.data_ptr(), mant.data_ptr(), emax.data_ptr(), R, H, B_M, log_l, device, stream)
    cuda_lib.check(status, "fp_prealign")
    cuda_lib.launches["fp_prealign"] += 1
    if vec:
        cuda_lib.launches["fp_prealign_vec"] += 1
    return mant, emax
