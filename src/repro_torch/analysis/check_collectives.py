"""Collective lint: no collective call over its byte budget.

The reference reads XLA's post-partition HLO for the signature of an
involuntary rematerialization: an all-gather of a whole replicated
operand, orders of magnitude over the halo-sized collectives a correct
partition needs.  The port makes its collectives explicitly, each
through ``dist.sharding.MeshContext`` (and ``optim.ring_allreduce_int8``
through the active context), whose ``counter`` keeps every call's bytes.
Each :class:`~.registry.CollectiveUnit` declares per-kind budgets (the
most bytes one call a rank may move; 0 forbids the kind), and every call
over its budget is an ``error`` carrying its bytes.
"""
from __future__ import annotations

from typing import List

from .findings import Finding, error, info
from .registry import Built, register_check

CHECK = "collectives"


@register_check(CHECK)
def run(contract: str, built: Built) -> List[Finding]:
    findings: List[Finding] = []
    for unit in built.collectives:
        flagged = 0
        for i, call in enumerate(unit.calls):
            budget = unit.budget.get(call["op"])
            if budget is None or call["bytes"] <= budget:
                continue
            flagged += 1
            verb = "forbidden collective" if budget == 0 else "oversized collective"
            findings.append(error(
                CHECK, contract,
                f"{unit.label}: {verb} {call['op']} ({call['bytes']:.0f} bytes/rank > budget "
                f"{budget}) at call {i} — likely a whole replicated operand moved",
                unit=unit.label, site={"collective": call["op"], "bytes": call["bytes"],
                                       "budget": budget, "call": i},
            ))
        if not flagged:
            kinds = sorted({c["op"] for c in unit.calls})
            findings.append(info(
                CHECK, contract,
                f"{unit.label}: all {len(unit.calls)} collective calls within budget "
                f"({kinds or 'none'})",
                unit=unit.label, n_calls=len(unit.calls),
            ))
    return findings
