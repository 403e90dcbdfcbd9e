"""Int8 gradient compression with error feedback: each leaf quantized to
int8 codes with one float32 scale per block of 512 values, then
dequantized, the rounding error carried into the next step's gradient.
``compress_decompress`` is the wire precision of the reference's
compressed all-reduce on one device; the ring collective itself
(``ring_allreduce_int8``, ``mean_grads_int8``) comes with sharding
(ROADMAP item 14)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..tree import flatten, unflatten

_BLOCK = 512


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., L) f32 -> int8 codes (..., n_blocks, 512) and f32 scales
    (..., n_blocks, 1), the last block zero-padded: scale = max |block| /
    127 + 1e-12, codes round(x / scale) clipped to +-127."""
    pad = (-x.shape[-1]) % _BLOCK
    blocks = F.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, _BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor, length: int) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(*q.shape[:-2], -1)
    return flat[..., :length]


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """(g + err) through int8 and back: returns (the dequantized gradient
    in g's dtype, the new error: what the codes missed, f32)."""
    corrected = (g.to(torch.float32) + err).reshape(-1)
    q, s = quantize(corrected)
    deq = dequantize(q, s, corrected.numel()).reshape(g.shape)
    return deq.to(g.dtype), corrected.reshape(g.shape) - deq


def init_error_state(params):
    """A float32 zeros tree shaped like ``params``."""
    leaves, tdef = flatten(params)
    return unflatten(tdef, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                            for p in leaves])
