"""FSDP execution of the training layout (``sharding.state_sharding_tree``)
on a caller's ``torch.distributed`` process group, one process a rank.

Each rank keeps only its blocks of every parameter and optimizer leaf,
as plain tensors.  Inside the step a :class:`TrainContext` is the active
mesh context, and the model code asks for whole weights where it uses
them (:func:`gather_params`): ``models.lm`` gathers one layer group's
weights inside the group loop (again in remat's recompute), and the
embedding, final norm, head and MTP head where the loss reads them.  A
gather is an autograd function (:class:`_GatherBlock`) whose backward
keeps the rank's block of the gradient:

* summed over the data axes first (every leaf: the data ranks saw
  different rows); a reduce-scatter where the leaf is split over the
  data axes, an all-reduce where it is replicated over them;
* not summed over the model axis: in this execution the model axis
  splits storage, not compute.  The ranks of one data block compute the
  same rows with the same whole weights, so their gradients are equal
  and each keeps its own block.

The loss is the global program's: ``common.softmax_xent_chunked`` sums
the rank's masked losses and mask count and then :func:`data_sum` adds
them over the data ranks before the division; the MoE's aux loss takes
its means over every rank's tokens, and its dispatch groups are the
global program's (:func:`batch_split`, :func:`gather_rows`).  A data
sum's backward is the identity: every rank computes the same global loss
from the summed values, so the gradient reaching a rank's own term is
the loss's.

Collectives go through ``MeshContext`` (``gather_block``, ``sum_over``),
so a context built from ``{axis: size}`` with a ``counter`` counts one
rank's step on fake tensors (the dry-run).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from .sharding import (
    MeshContext,
    SpecEntry,
    _entry_axes,
    batch_sharding_tree,
    current,
    map_tree,
    param_sharding_tree,
    tree_paths,
)


class TrainContext(MeshContext):
    """The mesh context of a sharded train step: training's rules, the
    parameters' specs by path (from ``params``, a tree of the whole
    leaves or their meta tensors), and, during a step, how the batch's
    rows are cut: into ``batch_split`` blocks over the spec entry
    ``batch_axes``, of which this rank holds ``batch_block``."""

    def __init__(self, mesh, params, counter: Optional[Dict[str, Dict[str, float]]] = None):
        super().__init__(mesh, counter=counter)
        self.param_specs = {p: ls.spec for p, ls in
                            tree_paths(param_sharding_tree(params, self))}
        self.batch_split, self.batch_block, self.batch_axes = 1, 0, None

    def n_data(self) -> int:
        """Ranks along the data axes."""
        n = 1
        for a in self.data_axes():
            n *= self.size(a)
        return n

    def counts_once(self, spec: Sequence[SpecEntry]) -> bool:
        """Whether this rank is the first of the ranks that hold the same
        block under ``spec`` (coordinate 0 on every axis it replicates
        over): a global norm counts each element once."""
        used = {a for e in spec for a in _entry_axes(e)}
        return all(self.coords[a] == 0 for a in self.axis_names if a not in used)


def current_train() -> Optional[TrainContext]:
    """The active context if it is a :class:`TrainContext`, else None."""
    ctx = current()
    return ctx if isinstance(ctx, TrainContext) else None


class _GatherBlock(torch.autograd.Function):
    """A rank's block -> the whole tensor; the gradient back to the block,
    summed over the data axes (see the module docstring)."""

    @staticmethod
    def forward(fctx, x, ctx: TrainContext, spec):
        fctx.ctx, fctx.spec = ctx, spec
        out = ctx.gather_block(x, spec)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(fctx, g):
        ctx, spec = fctx.ctx, fctx.spec
        data = ctx.data_axes()
        split = any(a in data and ctx.size(a) > 1 for e in spec for a in _entry_axes(e))
        g = ctx.sum_over(g, data, "reduce-scatter" if split else "all-reduce")
        blk = ctx.block(g, spec)
        return (g if blk is g else blk.clone()), None, None


def gather_params(tree, prefix: str):
    """``tree`` (the parameters at ``prefix``, or one layer group's views
    of the stacked leaves there) with every leaf whole, under the active
    :class:`TrainContext`; ``tree`` itself outside one."""
    ctx = current_train()
    if ctx is None:
        return tree

    def one(path, t):
        spec = ctx.param_specs.get(path)
        if spec is None:
            raise KeyError(f"no training layout for parameter {path!r}")
        if t.dim() == len(spec) - 1:      # one group's view of a stacked leaf
            spec = spec[1:]
        return _GatherBlock.apply(t, ctx, spec)

    return map_tree(one, tree, f"{prefix}/" if prefix else "")


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx: TrainContext):
        return ctx.sum_over(x, ctx.data_axes())

    @staticmethod
    def backward(fctx, g):
        return g, None


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data ranks of the active :class:`TrainContext`
    (``x`` itself outside one); the backward is the identity."""
    ctx = current_train()
    if ctx is None or ctx.n_data() == 1:
        return x
    return _DataSum.apply(x, ctx)


def data_ranks() -> int:
    """The data ranks a data sum adds over (1 outside a train context)."""
    ctx = current_train()
    return 1 if ctx is None else ctx.n_data()


def batch_split() -> int:
    """How many blocks the global batch's rows are cut into (1 outside a
    train context): a rank's tokens are the global program's
    ``1 / batch_split`` in row order."""
    ctx = current_train()
    return 1 if ctx is None else ctx.batch_split


def batch_block() -> int:
    """Which of the ``batch_split`` row blocks this rank holds (0 outside
    a train context)."""
    ctx = current_train()
    return 0 if ctx is None else ctx.batch_block


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """``t``, whose leading dim runs over this rank's tokens, with every
    row block's, in the global batch's order (``t`` itself outside a
    train context)."""
    ctx = current_train()
    if ctx is None or ctx.batch_split == 1:
        return t
    return ctx.gather_block(t, (ctx.batch_axes,) + (None,) * (t.dim() - 1))


def _data_only(ctx: MeshContext, spec) -> tuple:
    """``spec`` without its model-axis entries: the model axis splits a
    batch's storage in the reference's layout (``seq_sp``), not the rows
    a rank computes here."""
    data = set(ctx.data_axes())
    out = []
    for e in spec:
        axes = tuple(a for a in _entry_axes(e) if a in data)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def local_batch(batch: Dict[str, Any], ctx: TrainContext) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch of tensors: each leaf's block
    under its batch spec over the data axes (the whole leaf where the
    rows do not divide); sets ``ctx``'s ``batch_*`` fields."""
    shardings = batch_sharding_tree(batch, ctx)
    out = {}
    for k, t in batch.items():
        spec = _data_only(ctx, shardings[k].spec)
        out[k] = ctx.block(t, spec)
        if k == "targets":
            ctx.batch_axes = spec[0]
            ctx.batch_split, ctx.batch_block = ctx._split(spec[0])
    if "targets" not in batch:
        raise KeyError("a training batch needs 'targets'")
    return out
