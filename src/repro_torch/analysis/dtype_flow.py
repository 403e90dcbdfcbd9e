"""Dtype-provenance dataflow over a recorded op trace: the counterpart of
``repro.analysis.dtype_flow``, which walks a jaxpr.

:func:`analyze` reads the :class:`~.op_trace.OpRecord` s of one
:func:`~.op_trace.record` run and builds the sites the ``precision``
check consumes:

* :class:`CastSite` — every float dtype change: an explicit copy into
  another dtype (``_to_copy``, ``copy_``), and an op whose float output
  is of another dtype than a float input (the promotion jax would spell
  as a ``convert_element_type``); tagged widening by the reference's
  :func:`is_widening_cast`;
* :class:`DotSite` — every matmul (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``_int_mm`` and the vector forms) with its operand and
  output dtypes and the precision flags it ran under;
* :class:`CallSite` — every entry into a ``named_call``, so structural
  facts like "this dense routes through ``dcim_mvm``" are readable;
* :class:`ClipSite` — ``clamp`` with both bounds scalars: the quantizer's
  clip constants, from which ``B_x``/``B_w`` are recovered;
* :class:`ConstSite` — scalar ``mul``/``add``/``sub`` operands inside
  ``fp_prealign`` or ``dcim_fp_matmul`` (the mantissa scale
  ``1 << B_M`` and the exponent-bias offset).

Provenance runs from each op to the records that made its inputs, so it
is a DAG by construction (a record only depends on earlier ones).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .op_trace import COPY_OPS, DOT_OPS, OpTrace

# named calls whose scalar operands the FP bit recovery needs
_FP_DCIM_FNS = ("fp_prealign", "dcim_fp_matmul")
_CONST_OPS = frozenset({"mul", "mul_", "add", "add_", "sub", "sub_", "rsub"})
_CLIP_OPS = frozenset({"clamp", "clamp_", "clip", "clip_"})
# ops that take a tensor for its shape or device only
_SHAPE_ONLY = ("empty", "full", "zeros", "ones", "new_", "rand", "scalar_tensor")


@dataclasses.dataclass(frozen=True)
class CastSite:
    path: str
    src_dtype: str
    dst_dtype: str
    widening: bool
    islands: FrozenSet[str]
    fns: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class DotSite:
    path: str
    lhs_dtype: str
    rhs_dtype: str
    out_dtype: str
    flags: Tuple[bool, bool, bool]      # (tf32, bf16 reduced, f16 reduced) allowed
    device: str
    islands: FrozenSet[str]
    fns: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class CallSite:
    path: str
    name: str
    islands: FrozenSet[str]
    fns: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ClipSite:
    path: str
    lo: float
    hi: float
    islands: FrozenSet[str]
    fns: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ConstSite:
    path: str
    primitive: str                  # mul | add | sub
    value: float
    islands: FrozenSet[str]
    fns: Tuple[str, ...]


@dataclasses.dataclass
class Flow:
    """Result of one :func:`analyze` walk."""
    casts: List[CastSite] = dataclasses.field(default_factory=list)
    dots: List[DotSite] = dataclasses.field(default_factory=list)
    calls: List[CallSite] = dataclasses.field(default_factory=list)
    clips: List[ClipSite] = dataclasses.field(default_factory=list)
    consts: List[ConstSite] = dataclasses.field(default_factory=list)
    # every distinct dtype observed anywhere -> the first site it was seen at
    dtypes: Dict[str, str] = dataclasses.field(default_factory=dict)
    # storage pointers some op read, for the exactness-gate cross-check
    reads: Set[int] = dataclasses.field(default_factory=set)
    graph: Dict[str, Tuple[str, ...]] = dataclasses.field(default_factory=dict)
    n_ops: int = 0

    def provenance_graph(self) -> Dict[str, Tuple[str, ...]]:
        """site -> the sites that made its inputs, for acyclicity checks."""
        return self.graph


_ITEMSIZE = {
    "bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
    "int32": 4, "uint32": 4, "int64": 8, "uint64": 8,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "bfloat16": 2, "float16": 2,
    "float32": 4, "float64": 8, "complex64": 8, "complex128": 16,
}


def itemsize(dtype: str) -> int:
    return _ITEMSIZE.get(dtype, 4)


def is_float(dtype: str) -> bool:
    return dtype.startswith(("float", "bfloat"))


def is_widening_cast(src: str, dst: str) -> bool:
    """A silent precision promotion: a non-bool value converted into a
    strictly wider *float*.  Narrowings are always fine (they can only
    drop precision the program already had), int->same-width-float is
    a value conversion, bool->float is predicate arithmetic."""
    if src == "bool" or not is_float(dst):
        return False
    return itemsize(dst) > itemsize(src)


def _cast_pairs(rec) -> List[Tuple[str, str]]:
    """(src, dst) dtype pairs that ``rec`` converts between."""
    if rec.name in COPY_OPS:
        if rec.name == "copy_":
            src, dst = rec.in_dtypes[1], rec.in_dtypes[0]
        elif rec.name in ("_copy_from", "_copy_from_and_resize"):
            src, dst = rec.in_dtypes[0], rec.in_dtypes[1]
        elif rec.name == "copy":
            src, dst = rec.in_dtypes[1], rec.out_dtypes[0]
        else:
            src, dst = rec.in_dtypes[0], rec.out_dtypes[0]
        return [(src, dst)] if src != dst else []
    if not rec.out_dtypes or not is_float(rec.out_dtypes[0]) or rec.name in DOT_OPS \
            or "like" in rec.name or rec.name.startswith(_SHAPE_ONLY):
        return []
    dst = rec.out_dtypes[0]
    return [(src, dst) for src in sorted(set(rec.in_dtypes)) if is_float(src) and src != dst]


def _dot_operands(rec) -> Optional[Tuple[str, str]]:
    if rec.name in ("addmm", "baddbmm", "addbmm", "addmv"):
        return (rec.in_dtypes[1], rec.in_dtypes[2]) if len(rec.in_dtypes) >= 3 else None
    return (rec.in_dtypes[0], rec.in_dtypes[1]) if len(rec.in_dtypes) >= 2 else None


def analyze(trace: OpTrace) -> Flow:
    """Classify every site of a recorded trace."""
    flow = Flow(reads=set(trace.reads), n_ops=len(trace.records))
    sites = [r.site for r in trace.records]
    for rec in trace.records:
        site = sites[rec.idx]
        flow.graph[site] = tuple(sites[d] for d in rec.deps)
        for d in rec.in_dtypes + rec.out_dtypes:
            flow.dtypes.setdefault(d, site)
        for src, dst in _cast_pairs(rec):
            flow.casts.append(CastSite(site, src, dst, is_widening_cast(src, dst),
                                       rec.islands, rec.calls))
        if rec.name in DOT_OPS:
            ops = _dot_operands(rec)
            if ops is not None:
                flow.dots.append(DotSite(site, ops[0], ops[1], rec.out_dtypes[0], rec.flags,
                                         rec.device, rec.islands, rec.calls))
        if rec.name in _CONST_OPS and any(f in rec.calls for f in _FP_DCIM_FNS):
            prim = rec.name.rstrip("_").replace("rsub", "sub")
            for val in rec.scalars:
                flow.consts.append(ConstSite(site, prim, val, rec.islands, rec.calls))
        if rec.name in _CLIP_OPS and len(rec.scalars) == 2 and len(rec.in_dtypes) == 1:
            lo, hi = rec.scalars
            flow.clips.append(ClipSite(site, lo, hi, rec.islands, rec.calls))
    for i, entry in enumerate(trace.calls):
        flow.calls.append(CallSite(f"call{i}:{entry.name}@op{entry.at_op}", entry.name,
                                   entry.islands, entry.calls))
    return flow
