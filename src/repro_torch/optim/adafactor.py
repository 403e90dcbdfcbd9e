"""Adafactor (Shazeer & Stern 2018): factored second moments, O(n + m)
optimizer state for an (n, m) weight instead of O(nm); the reference's
arithmetic, in float32."""
from __future__ import annotations

import torch

from ..tree import flatten, unflatten
from .adamw import Transform, _transform


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, min_dim_size_to_factor: int = 128) -> Transform:
    """Leaves whose last two dims are both >= ``min_dim_size_to_factor``
    keep row and column means of g^2 (``vr``, ``vc``); the rest a full
    ``v``.  beta_t = 1 - t^-decay; each update is clipped to RMS
    ``clip_threshold``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def factored(shape):
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def one(p):
            z = dict(dtype=torch.float32, device=p.device)
            if factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}

        leaves, tdef = flatten(params)
        dev = leaves[0].device if leaves else None
        return {"mu": unflatten(tdef, [one(p) for p in leaves]),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def one(g, s, p, step, lr_t):
        beta = 1.0 - torch.pow(step.to(torch.float32), -decay)
        g = g.to(torch.float32)
        g2 = g * g + eps
        if "vr" in s:
            vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            denom = torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True), eps)
            u = g / torch.sqrt(vr / denom)[..., None] / torch.sqrt(vc)[..., None, :]
            new = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            u = g / torch.sqrt(v)
            new = {"v": v}
        rms = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp_min(rms / clip_threshold, 1.0)
        return -lr_t * (u + weight_decay * p.to(torch.float32)), new

    return _transform(init, one, lr_fn)
