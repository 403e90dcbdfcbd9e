"""Transfer/host-sync lint: the hot path must not transfer implicitly,
and must not wait on the device more often than it promised.

The contract's ``hot`` callable (a miniature ``ServeSession``
submit + drain, a train step call, a DSE run) runs once under the
recorder (``op_trace.record``).  Two detectors, each an ``error``:

* **implicit transfers** — an op on the card fed a CPU 0-dim tensor:
  torch copies it to the device silently, on every call (the analogue of
  the reference's ``jax.transfer_guard("disallow")``; explicit copies —
  ``torch.as_tensor(..., device=)``, ``.to(device)`` — pass: the point
  is not "no transfers" but "every transfer a visible call site");
* **host syncs over budget** — the ops whose result the host waits for
  (``.item()``, ``nonzero``, a device-to-host copy on the card) against
  the contract's ``sync_budget`` per hot call.

The counts — syncs by kind, explicit copies by direction, and on the
card the ``set_sync_debug_mode("warn")`` warnings — are in every
finding's data.
"""
from __future__ import annotations

from typing import List

from .findings import Finding, error, info
from .op_trace import record
from .registry import Built, register_check

CHECK = "transfers"


@register_check(CHECK)
def run(contract: str, built: Built) -> List[Finding]:
    if built.hot is None:
        return []
    findings: List[Finding] = []
    trace = record(built.hot, sync_debug=True)
    calls = max(1, int(built.hot_calls())) if built.hot_calls is not None else 1
    n_syncs = len(trace.syncs)
    data = dict(
        hot=built.hot_label, hot_calls=calls, syncs=n_syncs, syncs_by_kind=trace.sync_counts(),
        sync_warnings=trace.sync_warnings, transfers=trace.transfers(),
        sync_budget=built.sync_budget,
    )
    implicit = trace.implicit
    if implicit:
        findings.append(error(
            CHECK, contract,
            f"{built.hot_label}: {len(implicit)} implicit host-to-device transfer(s) — a CPU "
            f"0-dim tensor fed to an op on the card (first at {implicit[0].site}); move it "
            f"to the device at its call site instead",
            sites=[r.site for r in implicit[:8]], **data,
        ))
    if built.sync_budget is not None and n_syncs > built.sync_budget * calls:
        findings.append(error(
            CHECK, contract,
            f"{built.hot_label}: {n_syncs} host syncs over {calls} hot call(s), budget "
            f"{built.sync_budget} a call — the hot path waits on the device more often "
            f"than it promised",
            sites=[f"{r.site}:{r.sync}" for r in trace.syncs[:16]], **data,
        ))
    if not findings:
        findings.append(info(
            CHECK, contract,
            f"{built.hot_label}: {n_syncs} host syncs over {calls} hot call(s) "
            f"({trace.sync_warnings} sync-debug warnings), no implicit transfer",
            **data,
        ))
    return findings
