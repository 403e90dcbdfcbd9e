"""Recorded op traces: what the port's checks read, where the reference
reads jaxprs (``repro.analysis.jaxpr_tools``).

``make_fx`` cannot trace the port's programs: it refuses any read of a
tensor's value on the host (``aten._local_scalar_dense``), and the hot
loops read the host by design (the scheduler's sampled tokens, the
Pareto peel's checks every 8 fronts).  So :func:`record` runs a program
eagerly under a ``TorchDispatchMode`` and keeps one :class:`OpRecord` an
aten op, forward and backward, on the CPU and on the card alike: its
dtypes, shapes and devices, its scalar arguments, whether it writes in
place or returns a view, the precision islands and named calls around it
(``analysis.scopes``; a backward op takes those of the forward op that
made its autograd node), the kernel launches since the op before it, the
matmul precision flags in force, and the records that produced its
inputs (provenance).

It also counts the host **syncs** of the run: on any device the ops
whose result the host must wait for (``_local_scalar_dense``, the
ops whose output size depends on the data), and on the card every
device-to-host copy, plus the warnings of
``torch.cuda.set_sync_debug_mode("warn")``.

The module also holds the call-signature and tensor-inventory helpers
the contracts use: :func:`canonical_signature`, :func:`strip_py`,
:func:`donated_leaves` and :func:`pool_leaf_specs`.
"""
from __future__ import annotations

import dataclasses
import re
import time
import warnings
import weakref
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from . import scopes

# Ops whose result the host must wait for: a value read on the host, or
# an output whose size depends on the data.
SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "is_nonzero", "equal", "nonzero", "masked_select",
    "_unique", "_unique2", "unique_dim", "unique_consecutive", "unique_dim_consecutive",
    "bincount", "argwhere",
})
_INDEX_OPS = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})
COPY_OPS = frozenset({"_to_copy", "copy_", "_copy_from", "_copy_from_and_resize", "copy"})
DOT_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "_int_mm", "mv", "addmv",
                     "dot", "vdot"})


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def matmul_flags(device_type: str) -> Tuple[bool, bool, bool]:
    """(tf32 allowed, bf16 reduced-precision reduction allowed, f16
    reduced-precision reduction allowed) for products on ``device_type``.
    On the card these are cuBLAS's flags.  The CPU's bf16 and f16
    products accumulate in f32 unless its own f16 flag says otherwise,
    and it runs f32 products in TF32 only where oneDNN is told to."""
    if device_type == "cuda":
        m = torch.backends.cuda.matmul
        return (bool(m.allow_tf32), bool(m.allow_bf16_reduced_precision_reduction),
                bool(m.allow_fp16_reduced_precision_reduction))
    mk = getattr(torch.backends.mkldnn, "matmul", None)
    tf32 = getattr(mk, "fp32_precision", "none") not in ("none", "ieee")
    fp16 = getattr(torch._C, "_get_cpu_allow_fp16_reduced_precision_reduction", lambda: False)
    return (bool(tf32), False, bool(fp16()))


@dataclasses.dataclass
class OpRecord:
    """One recorded aten op."""
    idx: int
    name: str                           # the op's packet name: "mm", "add_", ...
    target: str                         # "aten.mm.default"
    in_dtypes: Tuple[str, ...]
    in_shapes: Tuple[Tuple[int, ...], ...]
    in_devices: Tuple[str, ...]
    in_storages: Tuple[int, ...]
    out_dtypes: Tuple[str, ...]
    out_shapes: Tuple[Tuple[int, ...], ...]
    out_devices: Tuple[str, ...]
    scalars: Tuple[float, ...]          # number arguments, in order
    inplace: bool
    view: bool
    islands: FrozenSet[str]
    calls: Tuple[str, ...]              # enclosing named calls, outermost first
    launches: Dict[str, int]            # kernel launches since the previous op
    flags: Tuple[bool, bool, bool]      # matmul_flags of its device
    device: str
    deps: Tuple[int, ...]               # idx of the records that produced its inputs
    backward: bool = False
    sync: Optional[str] = None          # why the host waits here, if it does
    implicit_h2d: bool = False          # a CPU 0-dim operand of an op on another device

    @property
    def site(self) -> str:
        return f"op{self.idx}:{self.name}" + ("(bw)" if self.backward else "")


@dataclasses.dataclass
class CallEntry:
    """One entry into a :func:`scopes.named_call`."""
    name: str
    islands: FrozenSet[str]
    calls: Tuple[str, ...]              # the stack with it, outermost first
    at_op: int                          # records made before it


@dataclasses.dataclass
class OpTrace:
    """Everything :func:`record` saw in one run."""
    records: List[OpRecord] = dataclasses.field(default_factory=list)
    calls: List[CallEntry] = dataclasses.field(default_factory=list)
    reads: Set[int] = dataclasses.field(default_factory=set)   # storages any op read
    sync_warnings: int = 0              # set_sync_debug_mode warnings (card only)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    result: Any = None

    @property
    def syncs(self) -> List[OpRecord]:
        return [r for r in self.records if r.sync is not None]

    def sync_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.syncs:
            out[r.sync] = out.get(r.sync, 0) + 1
        return out

    @property
    def implicit(self) -> List[OpRecord]:
        return [r for r in self.records if r.implicit_h2d]

    def transfers(self) -> Dict[str, int]:
        """Explicit copies between the host and a device, by direction."""
        out = {"h2d": 0, "d2h": 0}
        for r in self.records:
            if r.name in COPY_OPS and len(set(r.in_devices + r.out_devices)) > 1:
                src, dst = _copy_ends(r)
                if src == "cpu" and dst != "cpu":
                    out["h2d"] += 1
                elif src != "cpu" and dst == "cpu":
                    out["d2h"] += 1
        return out


def _copy_ends(r: OpRecord) -> Tuple[str, str]:
    """(source device, destination device) of a copy op's record."""
    if r.name == "copy_":                           # dst.copy_(src)
        return r.in_devices[1], r.in_devices[0]
    if r.name in ("_copy_from", "_copy_from_and_resize"):   # (src, dst)
        return r.in_devices[0], r.in_devices[1]
    if r.name == "copy":                            # copy(like, src) -> new
        return r.in_devices[1], r.out_devices[0]
    return r.in_devices[0], r.out_devices[0]        # _to_copy(src) -> new


def _storage(t: torch.Tensor) -> int:
    try:
        return int(t.untyped_storage().data_ptr())
    except (RuntimeError, NotImplementedError):
        return 0


class _Tagger(TorchFunctionMode):
    """Stamps the islands and named calls in force on the autograd node of
    every output that has one, so that the backward ops that node runs
    are attributed to them."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (scopes.ISLANDS or scopes.CALLS) and torch.is_grad_enabled():
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.grad_fn is not None:
                    md = t.grad_fn.metadata
                    if "islands" not in md:
                        md["islands"] = frozenset(scopes.ISLANDS)
                        md["calls"] = tuple(scopes.CALLS)
        return out


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: OpTrace, launches: Optional[Dict[str, int]]):
        super().__init__()
        self.trace = trace
        self.launch_src = launches
        self.last = dict(launches) if launches is not None else {}
        # id(tensor) -> (weak reference, idx of the record that made it)
        self.producer: Dict[int, Tuple[Any, int]] = {}

    def _made_by(self, t: torch.Tensor) -> Optional[int]:
        ent = self.producer.get(id(t))
        if ent is not None and ent[0]() is t:
            return ent[1]
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._add(func, args, kwargs, out)
        return out

    def _add(self, func, args, kwargs, out) -> None:
        trace = self.trace
        flat_in = tree_flatten((args, kwargs))[0]
        ins = [a for a in flat_in if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        scalars = tuple(float(a) for a in flat_in
                        if isinstance(a, (int, float)) and not isinstance(a, bool))
        name = func.overloadpacket.__name__
        schema = func._schema
        inplace = any(a.alias_info is not None and a.alias_info.is_write
                      for a in schema.arguments)
        view = bool(getattr(func, "is_view", False))
        node = torch._C._current_autograd_node()
        backward = node is not None
        islands, calls = frozenset(scopes.ISLANDS), tuple(scopes.CALLS)
        if backward:
            md = node.metadata
            islands = islands | md.get("islands", frozenset())
            calls = md.get("calls", ()) + calls
        devs = tuple(t.device.type for t in ins)
        odevs = tuple(t.device.type for t in outs)
        big = [t.device.type for t in ins + outs if t.dim() > 0]
        device = big[0] if big else (devs[0] if devs else (odevs[0] if odevs else "cpu"))
        deps = tuple(sorted({d for d in (self._made_by(t) for t in ins) if d is not None}))
        storages = tuple(_storage(t) for t in ins)
        launched: Dict[str, int] = {}
        if self.launch_src is not None:
            for k, v in self.launch_src.items():
                if v != self.last.get(k, 0):
                    launched[k] = v - self.last.get(k, 0)
            if launched:
                self.last = dict(self.launch_src)
        rec = OpRecord(
            idx=len(trace.records), name=name, target=str(func),
            in_dtypes=tuple(dtype_name(t.dtype) for t in ins),
            in_shapes=tuple(tuple(t.shape) for t in ins), in_devices=devs,
            in_storages=storages,
            out_dtypes=tuple(dtype_name(t.dtype) for t in outs),
            out_shapes=tuple(tuple(t.shape) for t in outs), out_devices=odevs,
            scalars=scalars, inplace=inplace, view=view, islands=islands, calls=calls,
            launches=launched, flags=matmul_flags(device), device=device, deps=deps,
            backward=backward,
        )
        rec.sync = _sync_kind(rec, args, kwargs)
        if name not in COPY_OPS and device != "cpu":
            rec.implicit_h2d = any(t.device.type == "cpu" and t.dim() == 0 for t in ins)
        trace.records.append(rec)
        trace.reads.update(s for s in storages if s)
        for t in outs:
            self.producer[id(t)] = (weakref.ref(t), rec.idx)


def _sync_kind(rec: OpRecord, args, kwargs) -> Optional[str]:
    if rec.name in SYNC_OPS:
        return rec.name
    if rec.name == "repeat_interleave" and kwargs.get("output_size") is None \
            and args and isinstance(args[0], torch.Tensor) and len(args) < 3:
        return rec.name
    if rec.name in _INDEX_OPS and len(args) > 1:
        idx = args[1]
        if any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
               for i in (idx if isinstance(idx, (list, tuple)) else [idx])):
            return "bool-index"
    if rec.name in COPY_OPS and len(set(rec.in_devices + rec.out_devices)) > 1:
        src, dst = _copy_ends(rec)
        if src != "cpu" and dst == "cpu":
            return "d2h"
    return None


def record(fn: Callable, *args, sync_debug: bool = False, **kwargs) -> OpTrace:
    """Run ``fn(*args, **kwargs)`` once under the recorder and return its
    :class:`OpTrace` (``result`` holds what ``fn`` returned).  While it
    runs, the islands and named calls of ``analysis.scopes`` are live.
    With ``sync_debug`` and a card present, the card's sync debug mode
    warns meanwhile; the warnings raised on this thread are counted in
    ``sync_warnings`` (those of other threads — autograd's device
    thread, a gloo worker — go to stderr uncounted)."""
    from ..kernels import cuda_lib

    trace = OpTrace()
    launches0 = dict(cuda_lib.launches)
    prev = scopes.RECORDING
    scopes.RECORDING = True
    entered = _CallLog(trace)
    scopes.CALL_HOOK = entered
    on_card = sync_debug and torch.cuda.is_available()
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:
                mode0 = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with _Tagger(), _Recorder(trace, cuda_lib.launches):
                    trace.result = fn(*args, **kwargs)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(mode0)
        trace.sync_warnings = sum("synchroniz" in str(w.message) for w in caught)
        for w in caught:
            if "synchroniz" not in str(w.message):
                warnings.showwarning(w.message, w.category, w.filename, w.lineno)
    finally:
        scopes.RECORDING = prev
        scopes.CALL_HOOK = None
        scopes.ISLANDS.clear()
        scopes.CALLS.clear()
    trace.seconds = time.perf_counter() - t0
    trace.launches = {k: v - launches0.get(k, 0) for k, v in cuda_lib.launches.items()
                      if v != launches0.get(k, 0)}
    return trace


class _CallLog:
    """Notes every named-call entry while :func:`record` runs."""

    def __init__(self, trace: OpTrace):
        self.trace = trace

    def __call__(self, name: str) -> None:
        self.trace.calls.append(CallEntry(
            name, frozenset(scopes.ISLANDS), tuple(scopes.CALLS), len(self.trace.records)))


# ----------------------------- signatures --------------------------------
def _leaf_sig(x) -> Optional[str]:
    if isinstance(x, torch.Tensor):
        return f"{dtype_name(x.dtype)}[{','.join(map(str, x.shape))}]|{x.device}"
    if isinstance(x, (np.ndarray, np.generic)):
        return f"{x.dtype}[{','.join(map(str, np.shape(x)))}]|numpy"
    if isinstance(x, bool):
        return "bool[]|py"
    if isinstance(x, int):
        return "int64[]|py"
    if isinstance(x, float):
        return f"{dtype_name(torch.get_default_dtype())}[]|py"
    return None


def canonical_signature(tree: Any) -> str:
    """Canonical call signature of an argument tree (dicts, lists,
    tuples and dataclasses of tensors, arrays and Python scalars): dtype,
    shape and device per tensor; a numpy array is marked ``|numpy`` and a
    Python scalar ``|py`` (as the tensor torch would make of it).  Two
    calls with equal signatures run the same program shapes; any drift is
    a new one."""
    leaf = _leaf_sig(tree)
    if leaf is not None:
        return leaf
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{canonical_signature(v)}" for k, v in tree.items()) + "}"
    if isinstance(tree, tuple):
        return "(" + ",".join(canonical_signature(v) for v in tree) + ")"
    if isinstance(tree, list):
        return "[" + ",".join(canonical_signature(v) for v in tree) + "]"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree).__name__ + canonical_signature(
            {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)})
    if tree is None or isinstance(tree, str):
        return repr(tree)
    return f"<{type(tree).__name__}>"


_MARK = re.compile(r"\|[^,)\]}]*")


def strip_py(sig: str) -> str:
    """``sig`` with every leaf's placement mark erased (``|py``,
    ``|numpy``, the device): if two signatures collide after stripping,
    they differ only in where a leaf lived (a Python scalar or a host
    array where another call passed a tensor, at the same argument)."""
    return _MARK.sub("|?", sig)


# --------------------------- tensor inventories ---------------------------
def _leaves(tree: Any, prefix: str = ""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))


def donated_leaves(tree: Any) -> List[Dict[str, Any]]:
    """Every tensor leaf of ``tree``: path, shape, dtype, nbytes and
    storage pointer."""
    return [{"path": p, "shape": tuple(t.shape), "dtype": dtype_name(t.dtype),
             "nbytes": t.numel() * t.element_size(), "ptr": _storage(t)}
            for p, t in _leaves(tree)]


def pool_leaf_specs(tree: Any) -> List[Tuple[str, str, Tuple[int, ...], int]]:
    """(path, dtype, shape, storage pointer) for every leaf of a pool:
    the form :class:`~.registry.ExactnessGate` takes."""
    return [(d["path"], d["dtype"], d["shape"], d["ptr"]) for d in donated_leaves(tree)]
