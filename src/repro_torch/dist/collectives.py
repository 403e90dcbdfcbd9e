"""The collectives that stand in for GSPMD's, on a caller's
``torch.distributed`` process group, whatever its backend: at the
exact-serving gather points (``sharding.repl_act``) and in training's
FSDP step (``dist.fsdp``).

* :func:`all_gather` along a dim is exact data movement on every
  backend: one ``broadcast`` a rank into that rank's slice of the
  output, the one form that every backend takes on CUDA tensors.  It
  does not sum: an ``all_reduce`` of zero-padded slices would turn a
  ``-0.0`` into ``+0.0``.
* :func:`group_max` is an ``all_reduce`` with ``MAX``: exact, since the
  maximum does not round.
* :func:`all_reduce_sum` is an ``all_reduce`` with ``SUM``: training's
  gradient and loss reductions.  gloo takes CUDA tensors only for
  ``broadcast`` and ``all_reduce``, so a reduce-scatter is this, then
  the rank's slice.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along ``dim`` in the
    group's rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    buf = x.new_empty((n, *x.shape))
    buf[dist.get_rank(group)].copy_(x)
    for r in range(n):
        dist.broadcast(buf[r], src=dist.get_global_rank(group, r), group=group)
    return torch.cat(buf.unbind(0), dim=dim)


def group_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group``."""
    if dist.get_world_size(group) == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group`` in place (and returned): an
    ``all_reduce``, which gloo also takes on CUDA tensors."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x
