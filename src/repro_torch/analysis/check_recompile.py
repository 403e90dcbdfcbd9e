"""Recompile-hazard lint: a replayed host loop must stay within the
program shapes it promised.

The port runs no jit, but its promise is the reference's: the
scheduler's one decode program and one prefill program per (bucket,
width) key (``Scheduler.compile_counts()``), one DSE program for tables
of one shape.  A new call signature is a new program shape — a retrace
under a compiler, a new CUDA graph to capture under (j) 2.  The
contract replays a realistic trace while recording the canonical
signature of every call (``op_trace.canonical_signature``: dtype, shape
and device per tensor, ``|py`` for a Python scalar).  Three detectors,
each an ``error``:

* **signature budget** — more DISTINCT signatures for a program label
  than its declared ``max_programs``;
* **placement drift** — two signatures equal once the placement marks
  are erased (``strip_py``): some call passed a Python scalar or a host
  array where another passed a tensor, the reference's weak-type drift;
* **live counts** — counts the code keeps itself (``compile_counts()``)
  against the declared budget.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from .findings import Finding, error
from .op_trace import strip_py
from .registry import Built, register_check

CHECK = "recompile"


@register_check(CHECK)
def run(contract: str, built: Built) -> List[Finding]:
    findings: List[Finding] = []
    replay = built.replay
    if replay is None:
        return findings

    by_label: Dict[str, List[str]] = defaultdict(list)
    for label, sig in replay.signatures:
        by_label[label].append(sig)

    for label, sigs in sorted(by_label.items()):
        distinct = list(dict.fromkeys(sigs))

        # placement drift: report before the budget so the root cause
        # leads even when both fire
        buckets: Dict[str, List[str]] = defaultdict(list)
        for sig in distinct:
            buckets[strip_py(sig)].append(sig)
        drifted = {k: v for k, v in buckets.items() if len(v) > 1}
        if drifted:
            findings.append(error(
                CHECK, contract,
                f"{label}: placement drift — {len(drifted)} signature group(s) differ only "
                f"in where a leaf lives (a Python scalar or host array vs a tensor at the "
                f"same argument)",
                program=label,
                groups={k: v for k, v in list(drifted.items())[:4]},
            ))

        budget = replay.max_programs.get(label)
        if budget is not None and len(distinct) > budget:
            findings.append(error(
                CHECK, contract,
                f"{label}: {len(distinct)} distinct call signatures over the replayed "
                f"trace, budget {budget} — the host loop makes new program shapes where it "
                f"promised the old ones",
                program=label, budget=budget,
                signatures=distinct[:8],
            ))

    for key, budget in sorted(replay.live_budget.items()):
        live = replay.live_counts.get(key)
        if live is not None and live > budget:
            findings.append(error(
                CHECK, contract,
                f"program count {key!r} holds {live} program shapes, budget {budget}",
                cache=key, live=live, budget=budget,
            ))
    return findings
