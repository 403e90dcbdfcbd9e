"""Donation lint: every tensor a contract hands a program for an in-place
update must keep its storage, and the program must not copy it.

The reference reads XLA's ``input_output_alias`` table: an unusable
donation is dropped silently and the program copies the buffer (the
serve pool, the train state) every step.  An eager PyTorch program has
no aliasing table; it keeps a buffer by writing into it.  So the port
runs each :class:`~.registry.DonationUnit` once under the recorder and
errors where either:

* a donated leaf's storage is not the same after the call (the caller
  rebound it to a new tensor), or
* an op that copies data read a donated leaf and produced a new tensor
  of its shape and dtype (:data:`COPYING_OPS`: a ``clone`` or dtype
  copy, or a functional update — ``where``, ``index_put``, ``scatter``,
  ``masked_fill`` — returning a new buffer where an in-place one would
  have written the old),

each for leaves of at least ``donate_min_bytes``.  Both mean a full copy
of the buffer on every call.
"""
from __future__ import annotations

from typing import List

from .findings import Finding, error, info
from .op_trace import donated_leaves, record
from .registry import Built, register_check

CHECK = "donation"

# Ops whose output is a copy of an input's data (whole, or updated).
COPYING_OPS = frozenset({
    "clone", "_to_copy", "copy", "lift_fresh_copy", "where", "index_put", "_index_put_impl",
    "_unsafe_index_put", "index_copy", "index_add", "index_fill", "scatter", "scatter_add",
    "scatter_reduce", "masked_fill", "masked_scatter", "slice_scatter", "select_scatter",
    "diagonal_scatter", "as_strided_scatter",
})


@register_check(CHECK)
def run(contract: str, built: Built) -> List[Finding]:
    findings: List[Finding] = []
    for unit in built.donation:
        before = [d for d in donated_leaves(unit.tree()) if d["nbytes"] >= unit.donate_min_bytes]
        trace = record(unit.run)
        after = {d["path"]: d for d in donated_leaves(unit.tree())}
        rebound = [d for d in before
                   if d["path"] not in after or after[d["path"]]["ptr"] != d["ptr"]]
        by_ptr = {d["ptr"]: d for d in before if d["ptr"]}
        copies = []
        for rec in trace.records:
            if rec.name not in COPYING_OPS:
                continue
            for ptr in set(rec.in_storages):
                d = by_ptr.get(ptr)
                if d is None:
                    continue
                if any(s == d["shape"] and t == d["dtype"]
                       for s, t in zip(rec.out_shapes, rec.out_dtypes)):
                    copies.append({"path": d["path"], "nbytes": d["nbytes"], "site": rec.site})
        if rebound:
            rebound.sort(key=lambda d: -d["nbytes"])
            findings.append(error(
                CHECK, contract,
                f"{unit.label}: {len(rebound)} donated buffer(s) were replaced instead of "
                f"updated in place (largest: {rebound[0]['path']}, {rebound[0]['nbytes']} "
                f"bytes) — the hot loop copies them every call",
                unit=unit.label,
                dropped=[{k: v for k, v in d.items() if k != "ptr"} for d in rebound],
            ))
        if copies:
            findings.append(error(
                CHECK, contract,
                f"{unit.label}: {len(copies)} op(s) copy a donated buffer whole (first: "
                f"{copies[0]['site']} copies {copies[0]['path']}, {copies[0]['nbytes']} "
                f"bytes) — the hot loop copies it every call",
                unit=unit.label, copies=copies[:8],
            ))
        if not rebound and not copies:
            findings.append(info(
                CHECK, contract,
                f"{unit.label}: all {len(before)} donated leaves updated in place",
                unit=unit.label, n_leaves=len(before),
            ))
    return findings
