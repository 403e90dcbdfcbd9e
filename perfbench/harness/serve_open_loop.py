"""Serving cells: an open loop of independent users against the port's
``Scheduler``, driven through ``ServeSession.submit`` and the session's
pump thread, as a server's front end drives it.

Set-up draws the weights on the card, builds the Scheduler and serves the
mix's warm bursts (every prefill bucket the mix's prompts fall in, and
the decode step).  The window then submits each planned request at its
due time and stamps every token on the host as the session delivers it
(``on_token``).  The window closes at ``seconds``: nothing waits for a
drain.  In a traced run the profiler covers a bounded stretch in the
window's middle, started and stopped between two ticks (under the
session's lock), so the stretch holds whole programs.

After the window: the pump stops, the peak memory is read, the program's
state is freed, and the plain reference teacher-forces a sample of the
finished requests (drawn from the seed, the longest among them) and
judges each served token by the gap between the reference's best logit
and the served token's.
"""
from __future__ import annotations

import dataclasses
import gc
import random
import threading
import time
from typing import Dict, List, Optional

import torch

from . import spec, traffic, weights
from . import trace as tr


@dataclasses.dataclass
class Record:
    rid: int
    due: float                      # host clock (perf_counter)
    prompt_len: int
    n_tokens: int
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    order: Optional[int] = None     # position of its first token among all first tokens
    failed: Optional[str] = None

    @property
    def first(self) -> Optional[float]:
        return self.times[0] if self.times else None

    def done_by(self, t: float) -> bool:
        return len(self.times) == self.n_tokens and self.times[-1] <= t


class _Lists:
    """A session's per-trace lists (``decode_step_s``, ``prefill_s``,
    ``prefill_ctx``) followed across the traces that begin whenever the
    session falls idle and takes a request again: each new trace gives
    them new list objects, and every object seen is kept."""

    NAMES = ("decode_step_s", "prefill_s", "prefill_ctx")

    def __init__(self, session):
        self.session = session
        self.seen = {n: [] for n in self.NAMES}
        self.poll()

    def poll(self) -> None:
        for n in self.NAMES:
            cur = getattr(self.session, n)
            if not self.seen[n] or self.seen[n][-1] is not cur:
                self.seen[n].append(cur)

    def mark(self) -> Dict[str, tuple]:
        """A point in every list: (how many objects seen, length of the last)."""
        self.poll()
        return {n: (len(v), len(v[-1])) for n, v in self.seen.items()}

    def between(self, name: str, a: dict, b: dict) -> list:
        """The entries of list ``name`` from mark ``a`` to mark ``b``."""
        objs, a, b = self.seen[name], a[name], b[name]
        out = []
        for i in range(a[0] - 1, b[0]):
            lo = a[1] if i == a[0] - 1 else 0
            hi = b[1] if i == b[0] - 1 else len(objs[i])
            out += list(objs[i][lo:hi])
        return out


class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    def __init__(self, cell, w, seconds):
        self.cell, self.widths, self.seconds = cell, w, seconds
        self.kind = "serve"


def run(cell, seed: int, seconds: float, trace: bool, device, t_process: float,
        judge: bool = True) -> Run:
    """One run; ``judge=False`` (the knee sweep's) leaves out the reference."""
    cfg = spec.program_config(cell.config)
    w = spec.widths(cell.config)
    mix, data = cell.traffic, cell.data
    sch = mix["scheduler"]
    from repro_torch.serve import Request, Scheduler

    params = weights.draw(cfg, seed, device)
    sched = Scheduler(cfg, params, max_slots=sch["max_slots"], max_len=sch["max_len"],
                      page_size=sch["page_size"], seed=int(seed) % (2 ** 31))
    session = sched.session()
    for burst in traffic.warm_plan(mix, seed, w["vocab"]):
        session.serve([Request(prompt=p, n_tokens=2, temperature=mix["temperature"])
                       for p in burst])
    _sync(device)
    plan = traffic.serve_plan(mix, data["rate_per_s"], seconds, seed, w["vocab"])
    lists = _Lists(session)
    firsts = [0]
    lock = threading.Lock()

    def on_token(rec: Record):
        def cb(handle, tok):
            t = time.perf_counter()
            rec.times.append(t)
            rec.tokens.append(int(tok))
            if rec.order is None:
                with lock:
                    rec.order = firsts[0]
                    firsts[0] += 1
        return cb

    stretch_s = min(4.0, 0.4 * seconds)
    prof = None
    if trace:
        prof = tr.profiler()
        prof.start()                    # the first start loads the tracer: in set-up
        prof.stop()
        prof = tr.profiler()
    marks: Dict[str, object] = {}
    session.start()
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    recs: List[Record] = []
    m0 = lists.mark()
    events = [(p.due_s, 0, p) for p in plan]
    if trace:
        events.append((0.4 * seconds, 1, "trace_on"))
    events.sort(key=lambda e: e[:2])
    i = 0
    while i < len(events):
        due, _, p = events[i]
        i += 1
        delay = t0 + due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        if isinstance(p, traffic.Planned):
            rec = Record(p.rid, t0 + p.due_s, int(p.prompt.size), p.n_tokens)
            recs.append(rec)
            try:
                session.submit(Request(prompt=p.prompt, n_tokens=p.n_tokens,
                                       temperature=mix["temperature"], rid=p.rid),
                               on_token=on_token(rec))
            except ValueError as e:              # shed or refused
                rec.failed = str(e)
        else:
            with session._cv:                   # between two ticks
                if p == "trace_on":
                    prof.start()
                    marks["t_on"] = time.perf_counter()
                    marks["on"] = lists.mark()
                    off = (marks["t_on"] - t0 + stretch_s, 1, "trace_off")
                    j = i
                    while j < len(events) and events[j][:2] <= off[:2]:
                        j += 1
                    events.insert(j, off)
                else:
                    marks["off"] = lists.mark()
                    marks["t_off"] = time.perf_counter()
                    prof.stop()
        lists.poll()
    end = t0 + seconds
    delay = end - time.perf_counter()
    if delay > 0:
        time.sleep(delay)
    m1 = lists.mark()
    session.stop()
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    r = Run(cell, w, seconds)
    r.records, r.t0, r.end, r.setup_s = recs, t0, end, setup_s
    r.decode_step_s = lists.between("decode_step_s", m0, m1)
    r.prefill_s = lists.between("prefill_s", m0, m1)
    r.prefill_ctx = lists.between("prefill_ctx", m0, m1)
    r.attempted = len(recs)
    r.failed = sum(rec.failed is not None for rec in recs)
    r.trace = None
    if trace:
        r.t_on, r.t_off = marks["t_on"], marks["t_off"]
        r.trace = tr.read(prof, marks["t_off"] - marks["t_on"])
        r.prefill_ctx_before_on = lists.between("prefill_ctx", m0, marks["on"])
        r.decode_steps_before_on = len(lists.between("decode_step_s", m0, marks["on"]))
        r.stretch_prefill_ctx = lists.between("prefill_ctx", marks["on"], marks["off"])
        r.stretch_decode_steps = len(lists.between("decode_step_s", marks["on"], marks["off"]))
        del prof

    finished = [rec for rec in recs if rec.done_by(end)]
    sample = _sample(finished, seed, mix["check"])
    del sched, session, lists
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    r.checks = _check(cell, params, w, sample, device, plan) if judge else {}
    r.sample = sample
    r.prompts = {p.rid: p.prompt for p in plan if any(rec.rid == p.rid for rec in sample)}
    r.peak_bytes = int(peak)
    return r


def _sample(finished: List[Record], seed: int, check: dict) -> List[Record]:
    """The requests the reference judges: the longest finished one, then
    others drawn from the seed until ``min_tokens`` served tokens or
    ``max_requests`` requests."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (r.prompt_len + r.n_tokens, -r.rid))
    rest = [r for r in finished if r is not longest]
    random.Random(int(seed)).shuffle(rest)
    out, n = [longest], longest.n_tokens
    for r in rest:
        if n >= check["min_tokens"] or len(out) >= check["max_requests"]:
            break
        out.append(r)
        n += r.n_tokens
    return out


def _check(cell, params, w, sample: List[Record], device, plan) -> Dict[str, dict]:
    """The widest gap by which a served token's logit lies below the
    reference's best, over every token of the sample."""
    ref = spec.reference(cell.config)
    P = weights.by_path(params)
    prompts = {p.rid: p.prompt for p in plan}
    worst = 0.0
    n = 0
    with _exact():
        for rec in sample:
            prompt = torch.as_tensor(prompts[rec.rid], device=device)
            served = torch.as_tensor(rec.tokens, device=device)
            seq = torch.cat([prompt.to(torch.int64), served.to(torch.int64)])[:-1]
            rows = range(rec.prompt_len - 1, seq.numel())
            z = ref.logits_at(P, w, seq, rows)
            gap = z.max(-1).values - z.gather(1, served.long()[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            n += served.numel()
            del z
    limits = cell.data["limits"]
    # Nothing judged is nothing proven: a run must judge some tokens.
    return {"worst_gap": {"value": worst, "limit": limits["worst_gap"]},
            "judged_tokens": {"value": n, "limit": limits["judged_tokens"], "least": True}}


class _exact:
    """float32 products without TF32 for the reference, restored after."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
