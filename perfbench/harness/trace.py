"""Reading a ``torch.profiler`` trace of a bounded stretch of the window.

The profiler records the device (CUPTI: every kernel, copy and set) and
the host's operators on every thread (the serving pump is a thread of
its own).  From it: each device operation's interval, their union (the
seconds the device was busy), device time inside a named host range, the
operations that took most device time, and the idle gaps labelled by the
innermost host operator running at the gap's middle.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple


def profiler():
    """A profiler of host (all threads) and device activity, not started."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


@dataclasses.dataclass
class Trace:
    span_s: float                              # the stretch, host clock
    device: List[Tuple[str, float, float]]     # (name, start_us, end_us), sorted
    host: List[Tuple[str, float, float]]       # host operators and ranges
    ranges: Dict[str, float]                   # device seconds inside named host ranges

    @property
    def busy_s(self) -> float:
        return union_us([(a, b) for _, a, b in self.device]) * 1e-6

    def kernel_s(self, *needles: str) -> float:
        """Device seconds of the operations whose name holds a needle."""
        return sum(b - a for n, a, b in self.device
                   if any(x in n.lower() for x in needles)) * 1e-6

    def kernel_count(self, *needles: str) -> int:
        return sum(1 for n, _, _ in self.device if any(x in n.lower() for x in needles))


def read(prof, span_s: float, range_names=()) -> Trace:
    from torch.autograd import DeviceType

    events = prof.events()
    device, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # A host range mirrored on the device timeline spans kernels
            # counted on their own.
            if not getattr(e, "is_user_annotation", False):
                device.append((e.name, float(a), float(b)))
        else:
            host.append((e.name, float(a), float(b)))
    device.sort(key=lambda x: x[1])
    ranges = {name: _range_kernel_us(events, name) * 1e-6 for name in range_names}
    return Trace(span_s, device, host, ranges)


def _range_kernel_us(events, name: str) -> float:
    """Device microseconds of every kernel launched inside a host range
    ``name``, through the profiler's links from host operators to kernels."""
    from torch.autograd import DeviceType

    total = 0.0
    stack = [e for e in events if e.name == name and e.device_type != DeviceType.CUDA]
    seen = set()
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        total += sum(k.duration for k in e.kernels)
        stack.extend(e.cpu_children)
    return total


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [a, b) intervals."""
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def gaps_us(intervals: List[Tuple[float, float]], lo: float, hi: float
            ) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi) outside every interval."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def breakdown(tr: Trace, top: int = 10) -> Dict[str, List[List]]:
    """The device operations that took most time, and the idle gaps by what
    the host was doing (the innermost host operator at each gap's middle;
    "no host operator" where none ran), each summed by name, seconds."""
    by_op: Dict[str, float] = {}
    for n, a, b in tr.device:
        by_op[n] = by_op.get(n, 0.0) + (b - a) * 1e-6
    if tr.device:
        lo = min(a for _, a, _ in tr.device + tr.host)
        hi = max(b for _, _, b in tr.device + tr.host)
    else:
        lo = hi = 0.0
    host = sorted(tr.host, key=lambda x: x[1])
    starts = [a for _, a, _ in host]
    by_host: Dict[str, float] = {}
    for a, b in gaps_us([(a, b) for _, a, b in tr.device], lo, hi):
        mid = 0.5 * (a + b)
        name = _innermost(host, starts, mid) or "no host operator"
        by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6
    # Kernel names are whole template signatures: their first 120 letters
    # name them.
    rank = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def _innermost(host: List[Tuple[str, float, float]], starts: List[float], t: float,
               look: int = 256) -> Optional[str]:
    """The latest-starting host operator that still runs at ``t``: on one
    thread, the innermost of those nested around it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        if host[j][2] >= t:
            return host[j][0]
    return None
