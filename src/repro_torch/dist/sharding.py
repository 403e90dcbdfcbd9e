"""Logical-axis sharding: the resolution layer between model code and
meshes of ranks.

Parameters are matched by path against :data:`PARAM_RULES` (training)
or :data:`SERVE_PARAM_RULES` (exact serving)::

    serve_logical_for_path("blocks/0/mixer/wq/w", 3)  ->  (None, None, "heads")

and a :class:`MeshContext` resolves logical names to mesh axes through
a rule table (``logical -> tuple of mesh axes``), with the reference's
two fallbacks, so that the same model code runs on any mesh:

* **divisibility**: a dim that the resolved axes' size does not divide
  replicates; for a multi-axis rule the longest divisible *prefix* wins
  (``batch -> ("pod", "data")`` degrades to ``("pod",)``, then to
  replicated);
* **each mesh axis used at most once per spec**: a later dim whose rule
  names an axis already taken replicates on it.

A resolved spec is a tuple with one entry a dim: ``None`` (replicated),
an axis name, or a tuple of names (the dim split over several axes, the
first outermost), the entries of the reference's ``PartitionSpec``.  Its
``torch.distributed.tensor`` form is one placement a mesh axis,
``Shard(d)`` or ``Replicate()`` (:meth:`MeshContext.placements`).

The port runs SPMD: one process a rank, each holding its shards as plain
tensors (``shard_tree``), with explicit collectives on the mesh's
process groups where the reference's single program lets GSPMD insert
them.  Exact serving shards only non-contracting output dims, so every
product is the full-length dot product of the single-device program,
and the model code gathers an activation back to full width
(:func:`repl_act`) before every contraction over a dim that may be
sharded: the only collective is an all-gather, pure data movement.  The
hot path never goes through DTensor dispatch: the hand kernels take raw
pointers, and a decode step is host-bound already.  Training lays its
state out by :func:`state_sharding_tree` and its batch by
:func:`batch_sharding_tree`, and ``dist.fsdp`` executes that layout:
each rank keeps its blocks and gathers a layer group's weights where
the model uses them.

A context is built from a ``DeviceMesh`` or from plain ``{axis name:
size}``.  The latter resolves the rules with no process group (the
tests, and the dry-run, which counts one rank's step on fake tensors
with a ``counter`` in place of the collectives).  With no installed
context (``use_mesh`` not entered) every gather point is the identity,
so all model code runs unsharded by default.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading
import weakref
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from . import collectives

Axes = Tuple[str, ...]
LogicalDims = Sequence[Optional[str]]
SpecEntry = Optional[Any]          # None, an axis name, or a tuple of axis names

# Mesh axes that carry data parallelism, in nesting order (outermost
# first).  A 3-axis production mesh is ("pod", "data", "model"); a
# single pod drops "pod".
_DATA_AXES = ("pod", "data")
_MODEL_AXES = ("model",)

# Logical names that resolve to the tensor-parallel ("model") axis.
_MODEL_LOGICAL = (
    "tp", "heads", "kv_heads", "ff", "d_inner", "experts", "vocab", "seq_sp",
)


def _mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a plain mapping, in
    the mesh's axis order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh for sharding needs mesh_dim_names")
    return dict(zip(names, (int(s) for s in mesh.mesh.shape)))


def default_rules(mesh) -> Dict[str, Axes]:
    """Default logical->mesh-axis rules from the mesh's axis names:
    ``batch`` and ``fsdp`` map to every data-like axis present, in mesh
    order; the model-parallel names to ``model``."""
    names = tuple(_mesh_shape(mesh))
    data = tuple(a for a in _DATA_AXES if a in names)
    model = tuple(a for a in _MODEL_AXES if a in names)
    rules: Dict[str, Axes] = {"batch": data, "fsdp": data}
    for logical in _MODEL_LOGICAL:
        rules[logical] = model
    return rules


@dataclasses.dataclass(frozen=True)
class LeafSharding:
    """One leaf's layout: its per-dim ``spec`` and the placements, one a
    mesh axis, that say the same in ``torch.distributed.tensor``'s terms;
    ``ctx`` is the :class:`MeshContext` that resolved it (which rank's
    block, over which process groups), left out of comparisons."""
    spec: Tuple[SpecEntry, ...]
    placements: Tuple[Any, ...]
    ctx: Any = dataclasses.field(default=None, compare=False, repr=False)


class MeshContext:
    """Resolves logical axis names against one mesh.

    ``mesh`` is a ``DeviceMesh`` (its process groups carry the
    collectives) or a plain ``{axis name: size}`` mapping (no process
    group; ``coords`` names the rank whose shards ``local_shard`` cuts,
    by default the first).  ``exact=True`` marks a *serving* context:
    :func:`repl_act` gathers activations back to full width before every
    contraction over a sharded dim.  ``counter``, a dict, counts every
    collective's kind and bytes (the dry-run's, and a training rank's
    bytes a step), with the largest call's bytes (``max``) and each
    call's (``calls``, which the contract lint reads); it also turns a
    group-less context with more than one rank into a counting one, whose
    collectives return uninitialised tensors of the right shape."""

    def __init__(self, mesh, rules: Optional[Dict[str, Axes]] = None, exact: bool = False,
                 coords: Optional[Mapping[str, int]] = None,
                 counter: Optional[Dict[str, Dict[str, float]]] = None):
        self.shape = _mesh_shape(mesh)
        self.mesh = None if isinstance(mesh, Mapping) else mesh
        self.axis_names = tuple(self.shape)
        self.rules = dict(rules) if rules is not None else default_rules(self.shape)
        self.exact = bool(exact)
        self.counter = counter
        # The blocks ``local_shard`` cut, by id (a weak reference guards
        # against a reused id): ``holds_shard`` tells a weight's block
        # from a replicated weight.
        self._shards: Dict[int, "weakref.ref[torch.Tensor]"] = {}
        if self.mesh is not None:
            coord = self.mesh.get_coordinate()
            if coord is None:
                raise ValueError("this rank is not in the mesh")
            self.coords = dict(zip(self.axis_names, (int(c) for c in coord)))
        else:
            self.coords = {a: int((coords or {}).get(a, 0)) for a in self.axis_names}

    # -- resolution -----------------------------------------------------------
    def size(self, axis: str) -> int:
        """The axis' size (1 for an axis the mesh does not have)."""
        return self.shape.get(axis, 1)

    def _divisible_prefix(self, axes: Axes, dim: int) -> Axes:
        """Longest prefix of ``axes`` whose total size divides ``dim``."""
        for end in range(len(axes), 0, -1):
            size = 1
            for a in axes[:end]:
                size *= self.shape[a]
            if dim % size == 0:
                return axes[:end]
        return ()

    def axes_for(self, logical: str, dim: int) -> Optional[Axes]:
        """Mesh axes for one logical dim, or ``None`` -> replicate: the
        name has no rule, its axes are absent from this mesh, or their
        size does not divide ``dim`` (longest divisible prefix)."""
        axes = self.rules.get(logical)
        if not axes:
            return None
        axes = tuple(a for a in axes if a in self.axis_names)
        return self._divisible_prefix(axes, dim) or None

    def spec(self, logical_dims: LogicalDims, shape: Sequence[int]) -> Tuple[SpecEntry, ...]:
        """Per-dim logical names resolved into spec entries.  Raises
        ``ValueError`` on rank mismatch.  Each mesh axis is used at most
        once; a dim whose axes were already taken replicates."""
        if len(logical_dims) != len(shape):
            raise ValueError(
                f"rank mismatch: {len(logical_dims)} logical dims "
                f"{tuple(logical_dims)} for shape {tuple(shape)}"
            )
        used: set = set()
        entries: List[SpecEntry] = []
        for logical, dim in zip(logical_dims, shape):
            axes = None if logical is None else self.axes_for(logical, int(dim))
            if axes:
                axes = tuple(a for a in axes if a not in used)
                if axes:
                    axes = self._divisible_prefix(axes, int(dim))
            if not axes:
                entries.append(None)
                continue
            used.update(axes)
            entries.append(axes[0] if len(axes) == 1 else axes)
        return tuple(entries)

    def placements(self, spec: Sequence[SpecEntry]) -> Tuple[Any, ...]:
        """One ``Shard(d)`` or ``Replicate()`` a mesh axis, in the mesh's
        axis order."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for a in self.axis_names:
            dims = [d for d, e in enumerate(spec) if a in _entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def sharding(self, logical_dims: LogicalDims, shape: Sequence[int]) -> LeafSharding:
        spec = self.spec(logical_dims, shape)
        return LeafSharding(spec, self.placements(spec), self)

    # -- this rank's shards ------------------------------------------------------
    def _split(self, entry: SpecEntry) -> Tuple[int, int]:
        """(number of shards, this rank's shard index) of a dim whose
        spec entry is ``entry``; the first axis is the outermost."""
        n, idx = 1, 0
        for a in _entry_axes(entry):
            n *= self.shape[a]
            idx = idx * self.shape[a] + self.coords[a]
        return n, idx

    def local_shape(self, spec: Sequence[SpecEntry], shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(int(d) // self._split(e)[0] for e, d in zip(spec, shape))

    def block_index(self, spec: Sequence[SpecEntry], shape: Sequence[int]) -> Tuple[slice, ...]:
        """The slices of a leaf of ``shape`` that are this rank's block."""
        out = []
        for e, dim in zip(spec, shape):
            n, idx = self._split(e)
            size = int(dim) // n
            out.append(slice(idx * size, (idx + 1) * size))
        return tuple(out)

    def block(self, t, spec: Sequence[SpecEntry]):
        """This rank's block of ``t`` (a tensor or an array) under
        ``spec``, as a view (``t`` itself where the spec replicates it)."""
        if all(self._split(e)[0] == 1 for e in spec):
            return t
        return t[self.block_index(spec, t.shape)]

    def local_shard(self, t: torch.Tensor, spec: Sequence[SpecEntry]) -> torch.Tensor:
        """This rank's block of ``t`` under ``spec``: ``t`` itself where
        the spec replicates it, else a contiguous copy of the block, so
        that the full tensor can be freed."""
        out = self.block(t, spec)
        if out is t:
            return t
        out = out.clone(memory_format=torch.contiguous_format)
        self._shards[id(out)] = weakref.ref(out)
        return out

    def holds_shard(self, t: torch.Tensor) -> bool:
        """Whether ``t`` (or the tensor it is a view of, as a layer's
        slice of a stacked leaf) is a block that ``local_shard`` cut."""
        base = t if t._base is None else t._base
        ref = self._shards.get(id(base))
        return ref is not None and ref() is base

    # -- collectives ----------------------------------------------------------------
    def group(self, axis: str = "model"):
        """The process group of ``axis`` (None for a group-less context)."""
        return None if self.mesh is None else self.mesh.get_group(axis)

    def _count(self, kind: str, nbytes: int) -> None:
        rec = self.counter.setdefault(kind, {"count": 0, "bytes": 0.0, "max": 0.0, "calls": []})
        rec["count"] += 1
        rec["bytes"] += float(nbytes)
        rec["max"] = max(rec["max"], float(nbytes))
        rec["calls"].append(float(nbytes))

    def all_gather(self, x: torch.Tensor, dim: int, axis: str = "model") -> torch.Tensor:
        """``x`` gathered along ``dim`` over ``axis``, ranks in order."""
        dim %= x.dim()
        return self.gather_block(x, tuple(axis if d == dim else None for d in range(x.dim())))

    def gather_block(self, x: torch.Tensor, spec: Sequence[SpecEntry]) -> torch.Tensor:
        """The whole tensor whose block under ``spec`` is this rank's ``x``:
        each sharded dim gathered over its axes, innermost first.  One
        "all-gather" of the whole tensor's bytes in the counter."""
        split = [(d, _entry_axes(e)) for d, e in enumerate(spec) if self._split(e)[0] > 1]
        if not split:
            return x
        shape = list(x.shape)
        for d, axes in split:
            shape[d] *= self._split(spec[d])[0]
        if self.counter is not None:
            self._count("all-gather", math.prod(shape) * x.element_size())
        if self.mesh is None:
            if self.counter is None:
                raise RuntimeError("a mesh context given as sizes has no process group "
                                   "to gather over")
            return x.new_empty(shape)
        for d, axes in split:
            for a in reversed(axes):
                x = collectives.all_gather(x, d, self.group(a))
        return x

    def sum_over(self, x: torch.Tensor, axes: Sequence[str], kind: str = "all-reduce"):
        """The elementwise sum of ``x`` over the ranks of ``axes`` (a new
        tensor; ``x`` where those axes hold one rank).  One ``kind`` of
        ``x``'s bytes in the counter."""
        axes = [a for a in axes if self.size(a) > 1]
        if not axes:
            return x
        if self.counter is not None:
            self._count(kind, x.numel() * x.element_size())
        if self.mesh is None:
            if self.counter is None:
                raise RuntimeError("a mesh context given as sizes has no process group "
                                   "to reduce over")
            return x.clone()
        out = x.clone()
        for a in axes:
            collectives.all_reduce_sum(out, self.group(a))
        return out

    def data_axes(self) -> Axes:
        """This mesh's data-parallel axes, outermost first."""
        return tuple(a for a in _DATA_AXES if a in self.shape)

    def group_max(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """The elementwise maximum of ``x`` over ``axis`` (exact)."""
        if self.size(axis) == 1:
            return x
        if self.counter is not None:
            self._count("all-reduce", x.numel() * x.element_size())
        if self.mesh is None:
            if self.counter is None:
                raise RuntimeError("a mesh context given as sizes has no process group "
                                   "to reduce over")
            return x
        return collectives.group_max(x, self.group(axis))


def _entry_axes(entry: SpecEntry) -> Axes:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# ------------------------------ active context --------------------------------
class _ContextStack(threading.local):
    def __init__(self):
        self.stack: List[MeshContext] = []


_ACTIVE = _ContextStack()


def current() -> Optional[MeshContext]:
    """The innermost active :class:`MeshContext` of this thread, or ``None``."""
    return _ACTIVE.stack[-1] if _ACTIVE.stack else None


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, Axes]] = None):
    """Install ``mesh`` (a ``DeviceMesh``, a ``{axis: size}`` mapping or
    a ``MeshContext``) as this thread's active context."""
    ctx = mesh if isinstance(mesh, MeshContext) else MeshContext(mesh, rules)
    _ACTIVE.stack.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.stack.pop()


def counter_totals(counter) -> Dict[str, Dict[str, float]]:
    """A context counter's totals by kind (``count``, ``bytes``, ``max``),
    without its per-call list: the form records and comparisons keep."""
    return {k: {f: v for f, v in rec.items() if f != "calls"} for k, rec in counter.items()}


def count_collective(kind: str, nbytes: int) -> None:
    """Count one collective call of ``nbytes`` into the active context's
    counter, if it keeps one (for collectives made outside the context's
    own methods, such as ``optim.ring_allreduce_int8``'s hops)."""
    ctx = current()
    if ctx is not None and ctx.counter is not None:
        ctx._count(kind, nbytes)


def repl_act(x: torch.Tensor, dim: int, full: int) -> torch.Tensor:
    """``x`` with its ``dim`` at full width ``full``: the identity where
    it is already (replicated, or no mesh), else gathered over the active
    exact context's ``model`` axis.

    Exact tensor parallelism never lets a contracted dim stay sharded: a
    sharded contraction would end in an all-reduce whose partial sums
    associate otherwise than the single-device product.  Model code calls
    this before every contraction over a dim that may be sharded (the
    attention output projection, the FFN down projection, the MoE
    combine, the logits sampling reads)."""
    if x.shape[dim] == full:
        return x
    ctx = current()
    if ctx is None or not ctx.exact:
        raise RuntimeError(f"a dim of width {x.shape[dim]} of {full} outside an exact "
                           f"serving context")
    out = ctx.all_gather(x, dim)
    if out.shape[dim] != full:
        raise RuntimeError(f"gathered width {out.shape[dim]}, expected {full}")
    return out


def shard_offset(local: int, full: int) -> int:
    """Where this rank's block of ``local`` of ``full`` columns starts on
    the active context's ``model`` axis (0 where nothing is sharded)."""
    if local == full:
        return 0
    ctx = current()
    if ctx is None or full != local * ctx.size("model"):
        raise RuntimeError(f"{local} of {full} columns is no shard of the active mesh")
    return ctx.coords["model"] * local


def is_shard(w: torch.Tensor) -> bool:
    """Whether ``w`` is this rank's block of a weight under the active
    exact context (a replicated weight is whole)."""
    ctx = current()
    return ctx is not None and ctx.exact and ctx.holds_shard(w)


def group_amax(x: torch.Tensor) -> torch.Tensor:
    """``max |x|`` of the tensor ``x`` is a block of, over the active
    exact context's ``model`` axis: a weight's per-tensor scale is the
    whole weight's, whichever block of it this rank holds."""
    amax = torch.max(torch.abs(x))
    ctx = current()
    if ctx is None or not ctx.exact:
        raise RuntimeError("a block's maximum outside an exact serving context")
    return ctx.group_max(amax.reshape(1)).reshape(())


# ------------------------------ parameter trees --------------------------------
def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """("a/b/0/c" path, leaf) for every leaf of a tree of dicts, lists and
    tuples, in jax's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in tree_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def map_tree(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def leaf_at(tree, path: str):
    for k in path.split("/") if path else ():
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def shard_tree(tree, shardings, ctx: MeshContext):
    """This rank's shards of every leaf of ``tree`` (``shardings`` its
    ``*_sharding_tree``)."""
    return map_tree(lambda path, t: ctx.local_shard(t, leaf_at(shardings, path).spec), tree)


def local_pool(make: Callable[[Any], Any], device, ctx: Optional[MeshContext]):
    """``make(device)``'s cache tree or, under an exact context, this
    rank's shards of it (``serve_pool_sharding_tree``): zeros allocated at
    their local shapes."""
    if ctx is None or not ctx.exact:
        return make(device)
    shapes = make("meta")
    shardings = serve_pool_sharding_tree(shapes, ctx)
    return map_tree(lambda p, t: torch.zeros(ctx.local_shape(leaf_at(shardings, p).spec, t.shape),
                                             dtype=t.dtype, device=device), shapes)


def _as_context(mesh, rules=None) -> MeshContext:
    return mesh if isinstance(mesh, MeshContext) else MeshContext(mesh, rules)


# Ordered (pattern, base logical axes), first match wins.  ``base`` is
# the logical layout at the parameter's natural rank; a leaf stacked over
# layer groups (rank + 1) gets a leading ``None``.
PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # attention projections (GQA + MLA low-rank factors)
    (r"(?:^|/)(?:wq|wk|wv|q_a|q_b|kv_a|kv_b)/w$", ("fsdp", "tp")),
    (r"(?:^|/)wo/w$", ("tp", "fsdp")),
    # dense FFN (leaf dicts with /w), MoE shared experts included
    (r"(?:^|/)(?:w_up|w_gate)/w$", ("fsdp", "ff")),
    (r"(?:^|/)w_down/w$", ("ff", "fsdp")),
    # MoE expert banks (E, d_model, d_ff) / (E, d_ff, d_model): E on the
    # model axis, d_ff on the data axes
    (r"(?:^|/)(?:w_gate|w_up)$", ("experts", None, "fsdp")),
    (r"(?:^|/)w_down$", ("experts", "fsdp", None)),
    (r"(?:^|/)router/w$", ("fsdp", None)),
    # embedding / unembedding
    (r"(?:^|/)embed/w$", ("vocab", "fsdp")),
    (r"(?:^|/)head/w$", ("fsdp", "vocab")),
    # mamba mixer
    (r"(?:^|/)in_proj/w$", ("fsdp", "tp")),
    (r"(?:^|/)x_proj/w$", ("tp", None)),
    (r"(?:^|/)dt_proj/w$", (None, "tp")),
    (r"(?:^|/)out_proj/w$", ("tp", "fsdp")),
    (r"(?:^|/)conv_w$", ("tp", None)),
    (r"(?:^|/)A_log$", ("tp", None)),
    # MTP combiner
    (r"(?:^|/)proj/w$", ("fsdp", None)),
)
_PARAM_RULES = tuple((re.compile(pat), base) for pat, base in PARAM_RULES)


def _match(rules, path: str, ndim: int) -> Tuple[Optional[str], ...]:
    for pat, base in rules:
        if pat.search(path):
            if ndim == len(base):
                return tuple(base)
            if ndim == len(base) + 1:      # stacked over layer groups
                return (None,) + tuple(base)
            break
    return (None,) * ndim


def logical_for_path(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Training logical axes for a parameter path at a given rank.
    Unmatched paths (norms, biases) and a matched rule at a rank it
    cannot take replicate."""
    return _match(_PARAM_RULES, path, ndim)


def param_sharding_tree(tree, mesh, rules: Optional[Dict[str, Axes]] = None):
    """:func:`logical_for_path` over a parameter tree: a
    :class:`LeafSharding` a leaf (the training layout, which
    ``dist.fsdp`` executes)."""
    ctx = _as_context(mesh, rules)
    return map_tree(lambda p, t: ctx.sharding(logical_for_path(p, len(t.shape)), t.shape),
                    tree)


# ------------------------------ training state and batch ------------------------
# Optimizer leaves by suffix (the reference's ``launch.dryrun.state_shardings``):
# a moment (AdamW's m / v, Adafactor's unfactored v, the int8 compression's
# error) takes its parameter's logical axes; Adafactor's row means ``vr``
# drop the parameter's last dim and its column means ``vc`` the one before;
# 8-bit AdamW's codes and scales, blocks of 256 over the whole flattened
# leaf, replicate.
_MOMENT_SUFFIX = re.compile(r"/(m|v|err)$")
_FACTORED_ROW = re.compile(r"/vr$")
_FACTORED_COL = re.compile(r"/vc$")
_QUANT = re.compile(r"/(m_q|m_s|v_q|v_s)$")


def state_logical_for_path(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes of a TrainState leaf ("params/...", "opt/mu/.../m",
    "err/...", the 0-d steps) at a given rank."""
    if _QUANT.search(path):
        return (None,) * ndim
    base, transform = path, None
    if _FACTORED_ROW.search(path):
        base, transform = _FACTORED_ROW.sub("", path), "row"
    elif _FACTORED_COL.search(path):
        base, transform = _FACTORED_COL.sub("", path), "col"
    elif _MOMENT_SUFFIX.search(path):
        base = _MOMENT_SUFFIX.sub("", path)
    base = base.replace("/mu/", "/params/")
    logical = logical_for_path(base, ndim if transform is None else ndim + 1)
    if transform == "row":
        logical = logical[:-1]
    elif transform == "col":
        logical = logical[:-2] + logical[-1:]
    return logical if len(logical) == ndim else (None,) * ndim


def state_sharding_tree(state, mesh, rules: Optional[Dict[str, Axes]] = None):
    """A :class:`LeafSharding` a leaf of a TrainState (any leaves with a
    ``shape``: tensors, meta tensors, numpy arrays) on ``mesh``: the
    training layout FSDP executes (``dist.fsdp``)."""
    ctx = _as_context(mesh, rules)
    return map_tree(lambda p, t: ctx.sharding(state_logical_for_path(p, len(t.shape)), t.shape),
                    state)


# A batch's leaves by key: rows over the data axes (``batch``); the
# reference also lays external embeddings' positions over the model axis
# (``seq_sp``).
BATCH_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    "tokens": ("batch", None),
    "targets": ("batch", None),
    "loss_mask": ("batch", None),
    "embeds": ("batch", "seq_sp", None),
    "position_ids": (None, "batch", None),
}


def batch_sharding_tree(batch, mesh, rules: Optional[Dict[str, Axes]] = None):
    """A :class:`LeafSharding` a batch leaf, by its key (unknown keys
    replicate); a batch that the data axes do not divide replicates."""
    ctx = _as_context(mesh, rules)

    def one(path, t):
        logical = BATCH_LOGICAL.get(path.split("/")[-1], (None,) * len(t.shape))
        if len(logical) != len(t.shape):
            logical = (None,) * len(t.shape)
        return ctx.sharding(logical, t.shape)

    return map_tree(one, batch)


# ------------------------------ exact serving rules ----------------------------
# Logical names a serving mesh resolves: only non-contracting output
# dims.  ``tp``, ``d_inner``, ``batch``, ``seq_sp`` and ``fsdp`` are
# deliberately absent.
_SERVE_MODEL_LOGICAL = ("heads", "kv_heads", "ff", "experts", "vocab")


def serve_rules(mesh) -> Dict[str, Axes]:
    """Logical->mesh-axis rules of an exact tensor/expert-parallel
    serving mesh (axis name ``"model"``)."""
    names = tuple(_mesh_shape(mesh.shape if isinstance(mesh, MeshContext) else mesh))
    model = tuple(a for a in _MODEL_AXES if a in names)
    return {logical: model for logical in _SERVE_MODEL_LOGICAL}


def serving_context(mesh, counter: Optional[Dict[str, Dict[str, float]]] = None) -> MeshContext:
    """The exact-serving :class:`MeshContext` of ``mesh``."""
    return MeshContext(mesh, rules=serve_rules(mesh), exact=True, counter=counter)


# Serving parameter layout (ordered, first match wins; unmatched ->
# replicate).  Only *output* dims shard, so every product contracts a
# replicated dim.  Replicated on purpose: ``wo`` and every ``w_down``
# (their output is d_model), ``embed`` (token gather and tied heads),
# the MLA factors (the absorbed attend contracts kv_lora_rank) and every
# mamba parameter (x_proj and out_proj contract d_inner).  Biases match
# no rule and replicate; ``models.common.dense`` adds this rank's
# columns of a bias wider than its output.
SERVE_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"(?:^|/)wq/w$", (None, "heads")),
    (r"(?:^|/)(?:wk|wv)/w$", (None, "kv_heads")),
    (r"(?:^|/)(?:w_up|w_gate)/w$", (None, "ff")),
    (r"(?:^|/)(?:w_gate|w_up)$", ("experts", None, "ff")),
    (r"(?:^|/)w_down$", ("experts", None, None)),
    (r"(?:^|/)head/w$", (None, "vocab")),
)
_SERVE_PARAM_RULES = tuple((re.compile(pat), base) for pat, base in SERVE_PARAM_RULES)


def serve_logical_for_path(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Serving logical axes for a parameter path (rank + 1 leaves are
    stacked over layer groups, as in :func:`logical_for_path`)."""
    return _match(_SERVE_PARAM_RULES, path, ndim)


def serve_param_sharding_tree(tree, mesh):
    """A :class:`LeafSharding` a parameter for exact serving on ``mesh``."""
    ctx = serving_context(mesh.shape if isinstance(mesh, MeshContext) else mesh)
    return map_tree(
        lambda p, t: ctx.sharding(serve_logical_for_path(p, len(t.shape)), t.shape), tree)


# Cache leaves by key.  GQA K/V pages (groups, n_pages, page, n_kv, hd)
# shard over kv heads: the one large serving buffer that shrinks per
# rank.  MLA latent pages and SSM states replicate.
_SERVE_POOL_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    "k": (None, None, None, "kv_heads", None),
    "v": (None, None, None, "kv_heads", None),
}


def _pool_logical(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """A cache leaf's logical axes by its last dict key."""
    key = next((k for k in reversed(path.split("/")) if not k.isdigit()), "")
    logical = _SERVE_POOL_LOGICAL.get(key, (None,) * ndim)
    return logical if len(logical) == ndim else (None,) * ndim


def serve_pool_sharding_tree(tree, mesh):
    """A :class:`LeafSharding` a cache leaf (paged pool or monolithic
    cache) for exact serving on ``mesh``."""
    ctx = serving_context(mesh.shape if isinstance(mesh, MeshContext) else mesh)
    return map_tree(lambda p, t: ctx.sharding(_pool_logical(p, len(t.shape)), t.shape), tree)
