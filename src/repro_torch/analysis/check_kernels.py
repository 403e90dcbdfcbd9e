"""Kernel lint: every hand-written kernel took its kernel and wrote its
whole output — the counterpart of the reference's ``check_pallas``.

The reference checks BlockSpec tiling and grid coverage statically from
the traced ``pallas_call``.  A hand-written CUDA kernel has no BlockSpec
to read, so the port checks the same promises by running it, for each
:class:`~.registry.KernelTrace` at ragged shapes:

* **took the kernel** — on CUDA inputs the wrapper must move its launch
  key in ``cuda_lib.launches``; a wrapper that raises or launches nothing
  is an ``error`` (never the plain version).  On the CPU the wrappers
  run the plain versions by design: an ``info`` ("plain versions off the
  card"), as the reference reports interpret mode off the TPU;
* **covers the output** — before the call, a block of each output's
  size is filled with a poison (NaN, or ``0x7f`` bytes for an integer
  output) and freed, so that the caching allocator hands the same block
  to the kernel; the output must then equal the plain version under the
  kernel's bar (bitwise, or atol = rtol = bar).  A grid that stops short
  leaves poison behind.

:func:`check_coverage` takes any callable in the kernel's place, so a
stand-in that writes only a prefix can be checked on the CPU.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import torch

from .findings import Finding, error, info
from .registry import Built, KernelTrace, register_check

CHECK = "kernels"


def _tensors(out: Any) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def poison_like(outs: Sequence[torch.Tensor]) -> None:
    """Fill and free one block of each of ``outs``' sizes: NaN for a float
    output, ``0x7f`` bytes for any other."""
    blocks = []
    for o in outs:
        p = torch.empty_like(o, memory_format=torch.contiguous_format)
        if p.is_floating_point():
            p.fill_(float("nan"))
        elif p.numel():
            p.reshape(-1).view(torch.uint8).fill_(0x7F)
        blocks.append(p)
    del blocks


def _mismatch(got: torch.Tensor, want: torch.Tensor, bar: float) -> Any:
    """None where ``got`` meets the bar against ``want``, else a dict of
    what missed."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return {"shape": list(got.shape), "want_shape": list(want.shape),
                "dtype": str(got.dtype), "want_dtype": str(want.dtype)}
    if bar == 0.0:
        bad = got != want
        if got.is_floating_point():
            bad = bad & ~(torch.isnan(got) & torch.isnan(want))
    else:
        g, w = got.double(), want.double()
        bad = ~torch.isfinite(g) | ((g - w).abs() > bar + bar * w.abs())
    n_bad = int(bad.sum())
    if not n_bad:
        return None
    first = int(bad.reshape(-1).nonzero()[0])
    return {"wrong": n_bad, "of": got.numel(), "first_flat_index": first}


def check_coverage(contract: str, trace: KernelTrace, call=None) -> List[Finding]:
    """Run ``call`` (default ``trace.call``) on poisoned blocks and hold
    its output to ``trace.plain``'s under ``trace.bar``."""
    call = trace.call if call is None else call
    want = _tensors(trace.plain(*trace.inputs))
    poison_like(want)
    got = _tensors(call(*trace.inputs))
    out: List[Finding] = []
    for i, (g, w) in enumerate(zip(got, want)):
        miss = _mismatch(g, w, trace.bar)
        if miss is not None:
            out.append(error(
                CHECK, contract,
                f"{trace.label}: output {i} misses its plain version "
                f"({'bitwise' if trace.bar == 0.0 else f'atol = rtol = {trace.bar}'}) at "
                f"{miss.get('wrong', '?')} of {miss.get('of', '?')} elements — part of the "
                f"output is never written, or written wrong",
                kernel=trace.label, output=i, shape=list(w.shape), **miss,
            ))
    if len(got) != len(want):
        out.append(error(CHECK, contract,
                         f"{trace.label}: {len(got)} outputs, the plain version has "
                         f"{len(want)}", kernel=trace.label))
    return out


@register_check(CHECK)
def run(contract: str, built: Built) -> List[Finding]:
    from ..kernels import cuda_lib

    findings: List[Finding] = []
    for trace in built.kernels:
        on_card = any(isinstance(t, torch.Tensor) and t.is_cuda for t in trace.inputs)
        before = cuda_lib.launches.get(trace.key, 0)
        try:
            found = check_coverage(contract, trace)
        except Exception as e:
            findings.append(error(
                CHECK, contract,
                f"{trace.label}: the wrapper raised: {type(e).__name__}: {e}"[:500],
                kernel=trace.label,
            ))
            continue
        if on_card:
            torch.cuda.synchronize()
        moved = cuda_lib.launches.get(trace.key, 0) - before
        if on_card and moved <= 0:
            found.append(error(
                CHECK, contract,
                f"{trace.label}: the call on CUDA inputs never launched {trace.key!r}",
                kernel=trace.label, key=trace.key,
            ))
        if not on_card:
            found.append(info(
                CHECK, contract,
                f"{trace.label}: plain versions off the card (CPU inputs)",
                kernel=trace.label,
            ))
        elif not found:
            found.append(info(
                CHECK, contract,
                f"{trace.label}: took {trace.key!r} ({moved} launch(es)), output covered",
                kernel=trace.label, key=trace.key, launches=moved,
            ))
        findings.extend(found)
    return findings
