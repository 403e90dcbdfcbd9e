"""The program's serving spans in a traced stretch, for the metric readers.

The port opens profiler ranges at its scheduler's layers (``serve.tick``
around a tick, ``serve.prefill.launch`` / ``serve.decode.launch`` around
the host's issue of one program's operators); the trace holds them as
host intervals on the device's clock.  The device's idle time over the
stretch (its seconds less the union of device intervals, as
``idle_share.serve`` takes it) splits by interval arithmetic into idle
time while a launch span is open, inside a tick but outside every launch,
and outside every tick.

A reader reads the spans only where the stretch holds a tick and its
launch spans count the programs the session listed for it; otherwise it
reports nothing and says why on standard error.  A program without the
spans reports nothing.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

from . import trace as tr

TICK = "serve.tick"
DECODE = "serve.decode.launch"
PREFILL = "serve.prefill.launch"

Intervals = List[Tuple[float, float]]


def intervals(run, name: str) -> Intervals:
    """(start_us, end_us) of every host span ``name`` in the stretch."""
    return sorted((a, b) for n, a, b in run.trace.host if n == name)


def readable(run, metric: str) -> bool:
    """Whether ``run``'s stretch holds the spans ``metric`` reads, with one
    launch span a program; says why not on standard error."""
    if run.trace is None or run.kind != "serve":
        return False
    why = None
    if not intervals(run, TICK):
        why = f"no {TICK} span in the traced stretch"
    else:
        got = (len(intervals(run, DECODE)), len(intervals(run, PREFILL)))
        want = (run.stretch_decode_steps, len(run.stretch_prefill_ctx))
        if got != want:
            why = (f"{got[0]} {DECODE} and {got[1]} {PREFILL} spans in the traced stretch, "
                   f"{want[0]} decode steps and {want[1]} prefill programs listed")
    if why:
        print(f"perfbench: {why}: no {metric}", file=sys.stderr)
    return why is None


def merge(iv: Intervals) -> Intervals:
    """The union of intervals as sorted disjoint intervals."""
    out: Intervals = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def intersect(x: Intervals, y: Intervals) -> Intervals:
    """The intersection of two sorted disjoint interval lists."""
    out: Intervals = []
    i = j = 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(iv: Intervals) -> float:
    return sum(b - a for a, b in iv)


def idle_split(run, metric: str) -> Optional[Dict[str, float]]:
    """The stretch's device idle seconds: ``launch`` (a launch span open),
    ``scheduler`` (inside a tick, no launch open) and ``between`` (the
    rest: outside every tick), summing to its seconds less its busy
    seconds.  None where ``metric`` cannot be read."""
    if not readable(run, metric):
        return None
    t = run.trace
    events = [(a, b) for _, a, b in t.device + t.host]
    lo, hi = min(a for a, _ in events), max(b for _, b in events)
    gaps = tr.gaps_us([(a, b) for _, a, b in t.device], lo, hi)
    ticks = merge(intervals(run, TICK))
    launch = merge(intervals(run, DECODE) + intervals(run, PREFILL))
    in_launch = length(intersect(gaps, launch))
    in_tick = length(intersect(gaps, ticks)) - length(intersect(intersect(gaps, ticks), launch))
    idle = t.span_s - t.busy_s
    return {"launch": in_launch * 1e-6, "scheduler": in_tick * 1e-6,
            "between": idle - (in_launch + in_tick) * 1e-6}
