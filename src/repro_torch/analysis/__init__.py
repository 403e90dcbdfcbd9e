"""Program-contract lint over recorded op traces: the port of
``repro.analysis``.

Hot programs declare :class:`~.registry.Contract` objects at their sites
(``serve.scheduler``, ``models.lm``, ``train.train_step``,
``core.nsga2``, ``kernels.ops``, ``sim.functional``; the data-parallel
train step in ``analysis.contracts``); pluggable checks (donation,
transfers, recompile, collectives, kernels, precision) verify them from
what a run of the program records: an op trace from a
``TorchDispatchMode`` (``op_trace``), its dtype provenance
(``dtype_flow``), the collective counter of ``dist.sharding``, the
kernels' launch counts.  ``python -m repro_torch.analysis.lint --help``.

Not ported: the reference's ``hlo.py`` and ``remat.py``, which parse
XLA's HLO text and its stderr.  PyTorch produces neither.  Their roles
go to the donation check's storage identity (an in-place update keeps
its buffer) and to ``MeshContext``'s counter, which keeps every
collective call's bytes.  The reference's ``check_pallas`` becomes
``check_kernels``: a hand-written kernel has no BlockSpec to read, so
the launch and the output's coverage are checked by running it.

This package root stays import-light (stdlib only): contract
*declaration* must be free for the hot modules, so the check and
contract modules load only on demand (:func:`load_builtin_checks`,
``contracts.load_contracts``).
"""
from .findings import Finding, Report  # noqa: F401
from .registry import (  # noqa: F401
    CHECKS,
    CONTRACTS,
    DEFAULT_ISLANDS,
    Built,
    CollectiveUnit,
    Contract,
    ContractSkip,
    DonationUnit,
    ExactnessGate,
    KernelTrace,
    PrecisionPolicy,
    Replay,
    register_check,
    register_contract,
)

_CHECK_MODULES = (
    "check_donation",
    "check_transfers",
    "check_recompile",
    "check_collectives",
    "check_kernels",
    "check_precision",
)


def load_builtin_checks() -> None:
    """Import every built-in check module (registration is a decorator
    side effect)."""
    import importlib

    for mod in _CHECK_MODULES:
        importlib.import_module(f"{__name__}.{mod}")
