"""K7 wrapper: the Mamba-1 selective scan, forward.

Replaces ``repro/kernels/selective_scan.py:selective_scan_pallas``; the
kernel is ``csrc/selective_scan.cu``.  A CUDA tensor goes to the kernel
(or the call raises: operands on different devices, a non-contiguous
operand, shapes that do not fit, or a state width N other than the
kernel's 8 and 16); a CPU tensor goes to the plain version in ``ref``.
A bf16 ``u`` goes to the kernel as bf16 (the serve's type; the kernel
widens it in registers, exactly as the reference's cast does); every
other operand, and ``u`` of any other type, is cast to float32 first, as
the reference's call casts them.  y and h_last are float32.
"""
from __future__ import annotations

import torch

from ..analysis.scopes import in_call
from . import cuda_lib, ref

STATE_WIDTHS = (8, 16)      # the kernel's template instances (the configs' d_state)


@in_call("selective_scan")
def selective_scan(u, dt, B_c, C_c, A, D_skip, h0=None):
    """u, dt (B, S, D); B_c, C_c (B, S, N); A (D, N); D_skip (D,); h0
    (B, D, N) or None (zeros) -> (y (B, S, D), h_last (B, D, N)), float32.
    Steps with dt = 0 carry the state unchanged (the caller's padding)."""
    if not u.is_cuda:
        return ref.selective_scan_ref(u, dt, B_c, C_c, A, D_skip, h0)
    name = "selective_scan"
    u_bf16 = u.dtype == torch.bfloat16
    ops = [u if u_bf16 else u.to(torch.float32)]
    ops += [t.to(torch.float32) for t in (dt, B_c, C_c, A, D_skip)]
    if h0 is not None:
        ops.append(h0.to(torch.float32))
    for t in ops:
        if t.device != u.device:
            raise ValueError(f"{name}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous operands required")
    u, dt, B_c, C_c, A, D_skip = ops[:6]
    h0 = ops[6] if h0 is not None else None
    if u.dim() != 3 or B_c.dim() != 3:
        raise ValueError(f"{name}: u (B, S, D) and B_c (B, S, N) required")
    Bsz, S, D = u.shape
    N = B_c.shape[-1]
    if (tuple(dt.shape) != (Bsz, S, D) or tuple(B_c.shape) != (Bsz, S, N)
            or tuple(C_c.shape) != (Bsz, S, N) or tuple(A.shape) != (D, N)
            or tuple(D_skip.shape) != (D,)
            or (h0 is not None and tuple(h0.shape) != (Bsz, D, N))):
        raise ValueError(f"{name}: operand shapes do not fit u {tuple(u.shape)}, N = {N}")
    if N not in STATE_WIDTHS:
        raise ValueError(f"{name}: state width N = {N} not in {STATE_WIDTHS}")
    if Bsz > 65535:
        raise ValueError(f"{name}: batch {Bsz} exceeds the grid's limit")
    y = torch.empty((Bsz, S, D), dtype=torch.float32, device=u.device)
    h_last = torch.empty((Bsz, D, N), dtype=torch.float32, device=u.device)
    status = cuda_lib.lib().selective_scan_launch(
        u.data_ptr(), dt.data_ptr(), B_c.data_ptr(), C_c.data_ptr(), A.data_ptr(),
        D_skip.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), Bsz, S, D, N, int(u_bf16), u.device.index or 0,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    cuda_lib.check(status, name)
    cuda_lib.launches[name] += 1
    if u_bf16:
        cuda_lib.launches["selective_scan_bf16u"] += 1
    return y, h_last
