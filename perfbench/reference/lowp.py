"""The controls' lower precision: fp8 products, as a later change might
serve or train the bf16 configurations in.

``fp8_linear(x, w)`` rounds x per row and w per output column to
float8 e4m3 (the scale puts each row's or column's largest magnitude at
448, e4m3's largest finite value), multiplies the rounded values in
float32 and returns float32.  Under autograd the backward rounds the
incoming gradient per row to float8 e5m2 and takes both products from
the rounded operands, as an fp8 training recipe does.  Everything else
stays float32.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dim: int, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


def rows_e4m3(x):
    return _round(x, -1, torch.float8_e4m3fn, E4M3_MAX)


def cols_e4m3(w):
    return _round(w, 0, torch.float8_e4m3fn, E4M3_MAX)


def rows_e5m2(g):
    return _round(g, -1, torch.float8_e5m2, E5M2_MAX)


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = rows_e4m3(x), cols_e4m3(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = rows_e5m2(g)
        return gq @ wq.t(), xq.t() @ gq


def fp8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with both operands in fp8, float32 out."""
    lead = x.shape[:-1]
    y = _Fp8Linear.apply(x.reshape(-1, x.shape[-1]).float(), w.float())
    return y.reshape(*lead, w.shape[-1])


def exact_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's product: float32 operands, float32 accumulation."""
    return x.float() @ w.float()
