"""The weights of a cell, drawn by the benchmark on the card from ``--seed``.

The layout (which leaves, their shapes and types) is the program's:
``lm.init`` on the meta device allocates nothing.  The values are the
benchmark's own, one large call a leaf (layers are stacked on a leading
axis), in the type the leaf is served in, by one ``torch.Generator`` on
the device.  Both sides, the program and the plain reference, get these
same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of a nested dict / list tree, in a
    fixed order: "blocks/0/mixer/wq/w"."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, t in enumerate(tree):
            out += leaves(t, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def by_path(tree) -> Dict[str, torch.Tensor]:
    return dict(leaves(tree))


def _fill(path: str, t: torch.Tensor, gen: torch.Generator) -> None:
    name = path.rsplit("/", 1)[-1]
    parent = path.rsplit("/", 2)[-2] if path.count("/") else ""

    def normal(std: float, mean: float = 0.0):
        # Leaves past 2^30 elements go in slices of the layer axis: the
        # generator's kernel is far slower on a single call that large.
        rows = max(1, (1 << 30) // max(1, t[0].numel())) if t.dim() > 1 else t.shape[0]
        for r in range(0, t.shape[0] if t.dim() else 1, rows):
            (t[r:r + rows] if t.dim() else t).normal_(mean, std, generator=gen)

    if name == "scale":                       # norm scales
        normal(0.1, 1.0)
    elif name in ("b", "bias", "conv_b"):
        normal(0.02)
    elif name == "A_log":                     # S4D-real: A = -(1..N) per channel
        n = t.shape[-1]
        t.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=t.device))
                .expand(t.shape))
    elif name == "dt_bias":                   # dt log-uniform in [1e-3, 1e-1]
        u = torch.empty_like(t).uniform_(generator=gen)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        t.copy_(dt + torch.log(-torch.expm1(-dt)))
    elif name == "D":
        t.fill_(1.0)
    elif name == "conv_w":
        normal(1.0 / math.sqrt(t.shape[-1]))
    elif parent == "embed":
        normal(0.02)
    elif name == "w":
        normal(1.0 / math.sqrt(t.shape[-2]))
    else:
        raise ValueError(f"no rule to draw leaf {path}")


def draw(cfg, seed: int, device) -> Dict:
    """The program's parameter tree for ``cfg``, drawn from ``seed``."""
    from repro_torch.models import lm

    meta = lm.init(cfg, torch.Generator("cpu"), "meta")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def real(tree):
        if isinstance(tree, dict):
            return {k: real(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [real(v) for v in tree]
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)

    params = real(meta)
    for path, t in leaves(params):
        _fill(path, t, gen)
    return params
