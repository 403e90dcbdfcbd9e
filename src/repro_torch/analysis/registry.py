"""Pluggable registries for lint checks and program contracts.

A **contract** is declared next to the code it describes (the
scheduler, ``lm.prefill_paged``, the train step, ``nsga2.run_batched``,
the kernels, the DCIM numerics): a build function that constructs the
program at a miniature configuration on a device and returns the
artifacts the checks need — calls that run it once against the tensors
it must update in place, a hot callable to replay under the recorder,
recorded call signatures, recorded op traces, collective records and
kernel launches.  Checks never import the modules they verify; they see
only :class:`Built`.

A **check** is a function ``(contract_name, Built) -> [Finding]``
registered under a short name.  The lint runner intersects each
contract's declared ``checks`` with the requested set, so a contract is
only exercised by checks it opted into.

The reference's artifacts are XLA's: a ``CompiledUnit`` (HLO text with
its aliasing table) and a ``PallasTrace`` (a kernel's jaxpr).  An eager
PyTorch program has neither, so the port's are a :class:`DonationUnit`
(a call and the tensors it must keep, checked by storage identity) and a
:class:`KernelTrace` (a kernel's call, its launch key and its plain
version on inputs at ragged shapes, checked by running both).

This module is deliberately import-light (stdlib only): hot modules
import it at module scope to declare their contracts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .findings import Finding


class ContractSkip(Exception):
    """Raised by a contract build to opt out at runtime (a multi-rank
    contract without a process group of at least two ranks).  Reported
    as an ``info`` finding, never a failure."""


@dataclasses.dataclass
class DonationUnit:
    """One call that must update the tensors it is handed in place.

    ``run()`` runs the program once; ``tree()`` returns the donated tree
    as it stands (before the call, and after it, where the caller may
    have rebound it).  Every leaf of at least ``donate_min_bytes`` must
    keep its storage across the call, and no op of the call may produce
    a fresh copy of one (a tensor of its shape and dtype made from it by
    an op that is neither in place nor a view)."""
    label: str
    run: Callable[[], Any]
    tree: Callable[[], Any]
    donate_min_bytes: int = 0


@dataclasses.dataclass
class Replay:
    """Call signatures recorded while replaying a host loop against the
    real programs (see the serve contract)."""
    # (program label, canonical signature) per recorded call
    signatures: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    # per-label budget of DISTINCT signatures; a label absent here is
    # unbudgeted (reported, not enforced)
    max_programs: Dict[str, int] = dataclasses.field(default_factory=dict)
    # live program counts vs budget (e.g. Scheduler.compile_counts())
    live_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    live_budget: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class KernelTrace:
    """One hand-written kernel for the kernels check: ``call(*inputs)``
    through its public wrapper, whose launch must move
    ``cuda_lib.launches[key]`` on CUDA inputs; ``plain(*inputs)`` its
    plain version; ``inputs`` at ragged shapes; ``bar`` 0.0 for bitwise,
    else atol = rtol = bar."""
    label: str
    key: str
    call: Callable[..., Any]
    plain: Callable[..., Any]
    inputs: Tuple[Any, ...]
    bar: float = 0.0


@dataclasses.dataclass
class CollectiveUnit:
    """The collectives one program made on this rank: ``calls`` holds one
    {"op": kind, "bytes": n} a call (``dist.sharding.MeshContext``'s
    counter keeps them), ``budget`` the most bytes one call of a kind may
    move, 0 forbidding the kind; a kind absent from it is unbudgeted."""
    label: str
    calls: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    budget: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ExactnessGate:
    """One lossless-context gate claim, re-verified from the trace.

    The scheduler enables prefix reuse / preemption / chunked prefill
    only when ``cache_dtype == compute_dtype``.  Instead of trusting that
    config comparison, the precision check re-derives the condition from
    the page-pool leaves the traced ``program`` actually read:
    ``pool_leaves`` holds (path, dtype, shape, storage pointer) for every
    pool leaf (``op_trace.pool_leaf_specs``); each must be read by some
    op of the trace and be at compute precision whenever ``enabled``
    claims the gate is on."""
    name: str                       # e.g. "prefix_reuse"
    enabled: bool                   # what the scheduler/config claims
    program: str                    # label in Built.programs to verify against
    pool_leaves: List[Tuple[str, str, Tuple[int, ...], int]] = dataclasses.field(
        default_factory=list
    )


# Islands every policy allows by default: the deliberate f32 regions of
# the model stack (norm/rope/attention-softmax/logits/cross-entropy),
# the declared-f32-accumulation dense block, the optimizer's f32 moment
# arithmetic, and the DCIM quantize->MVM->dequantize pipeline.
DEFAULT_ISLANDS: Tuple[str, ...] = (
    "norm", "rope", "attn", "logits", "xent", "dense", "optimizer", "dcim",
)


@dataclasses.dataclass
class PrecisionPolicy:
    """Per-contract precision contract for the ``precision`` check.

    ``compute_dtype`` is the working dtype of the hot programs;
    ``accum_dtype`` the declared accumulation of a low-precision product
    (its output, or a product run with reduced-precision reduction off).
    Widening casts are only legal inside a declared island
    (``models.common.precision_island``) listed in ``islands``.
    ``dcim_programs`` maps a ``programs`` label to the ``core.precision``
    format name whose DCIM numerics must provably serve every dense MVM
    of that program."""
    compute_dtype: str                              # e.g. "bfloat16"
    accum_dtype: str = "float32"
    islands: Tuple[str, ...] = DEFAULT_ISLANDS
    forbid_dtypes: Tuple[str, ...] = ("float64", "complex128")
    audit_widening: bool = True     # kernels opt out: register upcasts are idiomatic
    audit_dots: bool = True
    dcim_programs: Dict[str, str] = dataclasses.field(default_factory=dict)
    gates: List[ExactnessGate] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Built:
    """Everything a contract hands to the checks."""
    donation: List[DonationUnit] = dataclasses.field(default_factory=list)
    hot: Optional[Callable[[], Any]] = None         # transfers target
    hot_label: str = "hot path"
    # how many hot calls the last hot() made (None: one)
    hot_calls: Optional[Callable[[], int]] = None
    # most host syncs one hot call may make (None: unbudgeted)
    sync_budget: Optional[int] = None
    # (label, op_trace.OpTrace) recorded hot programs
    programs: List[Tuple[str, Any]] = dataclasses.field(default_factory=list)
    replay: Optional[Replay] = None
    kernels: List[KernelTrace] = dataclasses.field(default_factory=list)
    collectives: List[CollectiveUnit] = dataclasses.field(default_factory=list)
    precision: Optional[PrecisionPolicy] = None


@dataclasses.dataclass
class Contract:
    name: str
    build: Callable[[Any], Built]           # build(device) -> Built
    checks: Tuple[str, ...]
    description: str = ""
    ranks: int = 1                          # process-group size it needs


CheckFn = Callable[[str, Built], List[Finding]]

CHECKS: Dict[str, CheckFn] = {}
CONTRACTS: Dict[str, Contract] = {}


def register_check(name: str) -> Callable[[CheckFn], CheckFn]:
    def deco(fn: CheckFn) -> CheckFn:
        if name in CHECKS and CHECKS[name] is not fn:
            raise ValueError(f"check {name!r} already registered")
        CHECKS[name] = fn
        return fn
    return deco


def register_contract(
    name: str, checks: Sequence[str], description: str = "", ranks: int = 1,
) -> Callable[[Callable[[Any], Built]], Callable[[Any], Built]]:
    """Decorator declaring a program contract at its site; ``build``
    takes the device to build on.  ``ranks`` > 1 marks a contract that
    runs in every rank of a process group of that size."""
    def deco(build: Callable[[Any], Built]) -> Callable[[Any], Built]:
        if name in CONTRACTS and CONTRACTS[name].build is not build:
            raise ValueError(f"contract {name!r} already registered")
        CONTRACTS[name] = Contract(
            name=name, build=build, checks=tuple(checks),
            description=description, ranks=int(ranks),
        )
        return build
    return deco
