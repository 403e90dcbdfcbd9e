"""Int8 gradient compression with error feedback: each leaf quantized to
int8 codes with one float32 scale per block of 512 values, then
dequantized, the rounding error carried into the next step's gradient.

* ``compress_decompress``: the wire precision on one device, which the
  train step applies (as the reference's does), sharded or not.
* ``ring_allreduce_int8``: the compressed ring all-reduce over a
  ``torch.distributed`` group: a reduce-scatter phase and an all-gather
  phase of n - 1 hops each, every hop re-quantizing its chunk and moving
  the int8 codes and their f32 block scales to the next rank, with f32
  accumulation.  The reference's ``lax.ppermute`` is a paired
  ``isend`` / ``irecv`` to the next rank and from the previous one.
  gloo sends only host tensors, so on the card the codes and scales
  travel through host copies.
* ``mean_grads_int8``: the tree-wise compressed mean with error feedback
  against what the rank injected into the ring.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..dist.sharding import count_collective
from ..tree import flatten, unflatten

_BLOCK = 512


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., L) f32 -> int8 codes (..., n_blocks, 512) and f32 scales
    (..., n_blocks, 1), the last block zero-padded: scale = max |block| /
    127 + 1e-12, codes round(x / scale) clipped to +-127."""
    pad = (-x.shape[-1]) % _BLOCK
    blocks = F.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, _BLOCK)
    amax = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    # A true division on every device: CUDA divides by a Python scalar as
    # a product with its reciprocal, which rounds otherwise.
    scale = amax / amax.new_full((), 127.0) + 1e-12
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


def _exchange(q: torch.Tensor, s: torch.Tensor, group, nxt: int, prv: int):
    """Send (codes, scales) to global rank ``nxt`` and receive the same
    shapes from ``prv``, through host tensors (gloo sends no CUDA
    tensors); returns the received pair on ``q``'s device."""
    sq, ss = q.cpu(), s.cpu()
    rq, rs = torch.empty_like(sq), torch.empty_like(ss)
    reqs = [dist.isend(sq, nxt, group=group, tag=0), dist.isend(ss, nxt, group=group, tag=1),
            dist.irecv(rq, prv, group=group, tag=0), dist.irecv(rs, prv, group=group, tag=1)]
    for r in reqs:
        r.wait()
    return rq.to(q.device), rs.to(q.device)


def ring_allreduce_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """The compressed ring all-reduce (sum) of ``x`` (f32) over ``group``:
    the reference's ``ring_allreduce_int8``.  ``x`` is flattened, padded
    to n chunks of L; in hop s of the reduce-scatter rank r sends chunk
    (r - s) mod n and adds what it receives into chunk (r - s - 1) mod n,
    so after n - 1 hops it holds the whole sum of chunk (r + 1) mod n; in
    hop s of the all-gather it sends chunk (r + 1 - s) mod n and stores
    what it receives as chunk (r - s) mod n.  Every hop quantizes what it
    sends; a rank's own reduced chunk stays f32.  Each hop counts its
    codes' and scale's bytes as one "ring-int8" call into the active
    mesh context's counter, if it keeps one."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n) if group is not None else (r + 1) % n
    prv = dist.get_global_rank(group, (r - 1) % n) if group is not None else (r - 1) % n
    size = x.numel()
    L = -(-size // n)
    acc = F.pad(x.reshape(-1), (0, n * L - size)).reshape(n, L).clone()

    def hop(chunk):
        q, s = quantize(chunk)
        count_collective("ring-int8", q.numel() * q.element_size() + s.numel() * s.element_size())
        q, s = _exchange(q, s, group, nxt, prv)
        return dequantize(q, s, L)

    for step in range(n - 1):
        got = hop(acc[(r - step) % n])
        i = (r - step - 1) % n
        acc[i] = acc[i] + got
    for step in range(n - 1):
        got = hop(acc[(r + 1 - step) % n])
        acc[(r - step) % n] = got
    return acc.reshape(-1)[:size].reshape(x.shape)


def mean_grads_int8(grads, errors, group=None):
    """The reference's ``mean_grads_int8``: per leaf, corrected = g + err
    (f32), the mean through ``ring_allreduce_int8`` in g's dtype, and the
    new error corrected - dequant(quant(corrected)), what this rank's own
    codes missed.  Returns (mean tree, error tree)."""
    n = dist.get_world_size(group)
    flat_g, tdef = flatten(grads)
    flat_e, _ = flatten(errors)
    means, errs = [], []
    for g, e in zip(flat_g, flat_e):
        corrected = g.to(torch.float32) + e
        means.append((ring_allreduce_int8(corrected, group) / n).to(g.dtype))
        q, s = quantize(corrected.reshape(-1))
        errs.append(corrected - dequantize(q, s, corrected.numel()).reshape(g.shape))
    return unflatten(tdef, means), unflatten(tdef, errs)


def init_error_state(params):
    """A float32 zeros tree shaped like ``params``."""
    leaves, tdef = flatten(params)
    return unflatten(tdef, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                            for p in leaves])
