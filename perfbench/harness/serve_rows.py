"""Which prefill rows and decode tokens a serving window (or its traced
stretch) holds, for the metric readers.

The session lists the context length of every real row of each paged
prefill program (``ServeStats.prefill_ctx``), program by program in the
order it ran them; a request's first token is sampled by the program
that prefilled it and delivered in that tick, rows in order.  So the
i-th prefill row of the window is the i-th request by first-token order,
and its tail is its prompt less that context.
"""
from __future__ import annotations

import sys
from typing import List, Tuple


def _by_order(run):
    return sorted((r for r in run.records if r.order is not None), key=lambda r: r.order)


def _untraced(run, seq, stretch_len: int, before_len: int) -> list:
    """The entries of a window list outside the traced stretch (the
    profiler slows the host inside it); all of them in an untraced run."""
    if run.trace is None:
        return list(seq)
    return list(seq[:before_len]) + list(seq[before_len + stretch_len:])


def untraced_programs(run) -> List[Tuple[List[Tuple[int, int]], float]]:
    """(rows of (tail, context), host seconds) of each prefill program of
    the window outside the traced stretch."""
    reqs = _by_order(run)
    progs, i = [], 0
    for ctx, (_, _, s) in zip(run.prefill_ctx, run.prefill_s):
        progs.append(([(reqs[i + j].prompt_len - c, c) for j, c in enumerate(ctx)], s))
        i += len(ctx)
    if run.trace is None:
        return progs
    return _untraced(run, progs, len(run.stretch_prefill_ctx), len(run.prefill_ctx_before_on))


def untraced_decode_steps(run) -> List[float]:
    """Host seconds of each decode step of the window outside the stretch."""
    if run.trace is None:
        return list(run.decode_step_s)
    return _untraced(run, run.decode_step_s, run.stretch_decode_steps,
                     run.decode_steps_before_on)


def stretch_programs(run) -> List[List[Tuple[int, int]]]:
    """(tail, context) of each row, program by program, of the prefill
    programs that ran inside the traced stretch."""
    reqs = _by_order(run)
    i = sum(len(prog) for prog in run.prefill_ctx_before_on)
    out = []
    for prog in run.stretch_prefill_ctx:
        rows = []
        for c in prog:
            rows.append((reqs[i].prompt_len - c, c))
            i += 1
        out.append(rows)
    return out


def stretch_decode_contexts(run) -> List[int]:
    """For every decode token delivered inside the traced stretch, the keys
    its step attended: the prompt and every token before it."""
    out = []
    for r in run.records:
        for j, t in enumerate(r.times[1:], start=1):
            if run.t_on <= t <= run.t_off:
                out.append(r.prompt_len + j)
    return out


def launches_match(run, name: str, programs: int) -> bool:
    """Whether the stretch's launches of kernel ``name`` are one a layer
    for each prefill program it holds.  A roofline share rests on the
    i-th prefill row being the i-th request by first-token order; where
    the count disagrees that match is not shown, so its reader reports
    nothing, and this says why on standard error."""
    got = run.trace.kernel_count(name)
    want = programs * run.widths["layers"]
    if got != want:
        print(f"perfbench: {got} {name} launches in the traced stretch, {want} expected "
              f"({programs} prefill programs x {run.widths['layers']} layers): "
              f"no {name} roofline", file=sys.stderr)
    return got == want
