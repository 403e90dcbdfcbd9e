"""Input specs: fake-tensor stand-ins for every model input, per
(arch config x shape x step kind), and the concrete batch maker for
smoke tests and examples.

``batch_struct`` never allocates: its tensors are fake (shapes and
dtypes only), which is what the dry-run counts a step on.
``concrete_batch`` draws from ``np.random.default_rng(seed)`` exactly as
the reference's does, so the two batches are equal element for element.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..device import resolve
from ..models.config import LMConfig


def batch_struct(cfg: LMConfig, kind: str, batch: int, seq: int,
                 mode: Optional[FakeTensorMode] = None) -> Dict[str, torch.Tensor]:
    """Fake input dict for one step kind, made in ``mode`` (a fresh
    ``FakeTensorMode`` when None):

    train:   full batch with targets
    prefill: prompt only
    decode:  one new token (seq == S_max of the existing cache)
    """
    s = 1 if kind == "decode" else seq
    with mode or FakeTensorMode():
        out: Dict[str, torch.Tensor] = {}
        if cfg.external_embed:
            out["embeds"] = torch.empty((batch, s, cfg.d_model), dtype=cfg.cdtype)
        else:
            out["tokens"] = torch.empty((batch, s), dtype=torch.int32)
        if cfg.pos == "mrope":
            out["position_ids"] = torch.empty((3, batch, s), dtype=torch.int32)
        if kind == "train":
            out["targets"] = torch.empty((batch, seq), dtype=torch.int32)
    return out


def concrete_batch(cfg: LMConfig, kind: str, batch: int, seq: int, seed: int = 0,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Deterministic synthetic batch with the same keys as
    :func:`batch_struct`, on ``device``."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    s = 1 if kind == "decode" else seq
    out: Dict[str, torch.Tensor] = {}
    if cfg.external_embed:
        out["embeds"] = torch.from_numpy(
            rng.normal(size=(batch, s, cfg.d_model)).astype(np.float32)).to(dev, cfg.cdtype)
    else:
        out["tokens"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, size=(batch, s)).astype(np.int32)).to(dev)
    if cfg.pos == "mrope":
        out["position_ids"] = torch.arange(s, dtype=torch.int32, device=dev)[None, None].expand(
            3, batch, s).contiguous()
    if kind == "train":
        out["targets"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)).to(dev)
    return out
