"""Whole-window arithmetic: the tails and rates of the end-to-end metrics.

Each is taken over everything the window holds, never over chunks of it,
so a stall anywhere in the window moves it:

* ``ttft_samples``: every request due in the window gives one sample,
  from its due time (open loop) to its first token on the host; one
  with no first token when the window closes gives its age then.
* ``itl_samples``: every gap between consecutive tokens of a request
  that ends inside the window, and for each request still producing at
  the close, the open gap from its last token to the close.
"""
from __future__ import annotations

import statistics
from typing import List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), over all ``values``."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def ttft_samples(due: Sequence[float], first: Sequence[float], end: float) -> List[float]:
    """Seconds to first token of each request due in [.., end): ``first``
    holds its first token's time, or None.  Times on one clock."""
    out = []
    for d, f in zip(due, first):
        if d >= end:
            continue
        out.append((f if f is not None and f <= end else end) - d)
    return out


def itl_samples(token_times: Sequence[Sequence[float]], done: Sequence[bool],
                end: float) -> List[float]:
    """Gaps between consecutive tokens of each request, up to ``end``;
    ``done[i]`` says request i produced its last token by then."""
    out = []
    for times, fin in zip(token_times, done):
        ts = [t for t in times if t <= end]
        out += [b - a for a, b in zip(ts, ts[1:])]
        if ts and not fin:
            out.append(end - ts[-1])
    return out


def rate(work: float, seconds: float) -> float:
    return work / seconds


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
