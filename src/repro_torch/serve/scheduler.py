"""Continuous-batching serving over a paged KV-cache pool.

The bucketed ``Engine`` holds every request of a batch until the whole
batch finishes.  The ``Scheduler`` instead owns ``max_slots`` decode
slots and runs one decode program per step over all of them, admitting
new requests into slots as others retire.

Attention K/V lives in shared fixed-size pages (``lm.init_paged_pool``);
each slot holds a block table of page ids, and the programs read and
write the pool through it (``lm.decode_step_paged``, K4 on the card;
``lm.prefill_paged``, K5).  SSM state stays per slot (K7 fills it at
prefill, ``mamba_step`` advances it at decode).  On top of paging:

  * **shared-prefix reuse**: prompts are hashed at page granularity
    (``serve.paging.PagePool``); a request whose prefix pages are
    resident refcounts them and prefills only its tail, attending the
    reused pages as context.  Retired requests' prefix pages stay cached
    until allocation pressure evicts them.  Reuse is on only where it is
    token-exact: no SSM layer (a recurrent state is not held in pages)
    and a cache dtype equal to the compute dtype (reused pages would
    otherwise hand the tail rounded context).
  * **burst prefill**: the requests admitted at one step prefill
    together in one padded ``(width, bucket)`` program, the width a
    power of two and the bucket one of ``prefill_buckets``.  A member
    whose prefix pages are still pending fill by an earlier member of
    the same burst flushes the burst first (its context gather must see
    them filled).

All serve-loop state lives in a :class:`ServeSession` (the device pool,
the ``PagePool`` prefix index, the slot allocator, the per-slot host
arrays), built once and kept across ``submit()`` / ``step()`` /
``serve()`` calls, so a prefix filled by one trace is a hit in the next.
Admission is FIFO in (arrival, submission) order.

Scheduling never changes numerics: greedy tokens equal ``Engine``'s run
per request (``tests/test_torch_serve.py``).  This is the paged core of
``repro.serve.scheduler``; ROADMAP §1 item 12 lists what waits for a
later slice (the pump thread, priorities, preemption, queue shedding,
chunked prefill, the monolithic ``paged=False`` path, meshes).
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import List, Optional, Sequence, Set, Union

import numpy as np
import torch

from ..models import lm
from ..models.config import LMConfig
from .engine import (
    check_capacity,
    check_unique_rids,
    derive_request_keys,
    numerics_ctx,
    sample_tokens,
)
from .paging import PagePool, check_page_capacity, pages_needed


@dataclasses.dataclass
class Request:
    """One generation request for the continuous-batching scheduler."""
    prompt: np.ndarray                 # (P,) int32 token ids
    n_tokens: int = 32
    temperature: float = 0.0
    rid: Optional[int] = None          # defaults to submission index
    arrival: int = 0                   # earliest scheduler step it may join
                                       # (relative to the current trace)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray                 # (P + generated,) prompt included
    prompt_len: int
    arrival: int
    admitted_step: int
    finished_step: int
    finished_wall_s: float             # seconds since the trace started
    prefix_hit_tokens: int = 0         # prompt tokens served from cached pages

    @property
    def generated(self) -> np.ndarray:
        return self.tokens[self.prompt_len:]


@dataclasses.dataclass
class ServeStats:
    steps: int                         # scheduler ticks, idle ones included
    decode_steps: int
    prefills: int                      # requests prefilled
    max_slots: int
    generated_tokens: int
    wall_s: float
    occupancy: float                   # mean fraction of slots active per decode step
    prefill_batches: int = 0           # prefill programs run
    prefix_reuse_active: bool = False
    paging: Optional[dict] = None      # per-trace PageStats delta
    trace_index: int = 0               # which trace of the session this was
    pool_bytes: int = 0                # device cache-pool footprint
    # Host seconds of each program call, ending on its sampled tokens
    # reaching the host (so on the card they include the device time):
    decode_step_s: List[float] = dataclasses.field(default_factory=list)
    prefill_s: List[tuple] = dataclasses.field(default_factory=list)  # (width, bucket, s)


class SlotAllocator:
    """Fixed pool of decode slot ids with LIFO reuse."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.n_slots = n_slots
        self._free: List[int] = list(reversed(range(n_slots)))
        self._busy: set = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def busy(self) -> frozenset:
        return frozenset(self._busy)

    def acquire(self) -> int:
        if not self._free:
            raise RuntimeError("no free slot")
        slot = self._free.pop()
        self._busy.add(slot)
        return slot

    def release(self, slot: int) -> None:
        if slot not in self._busy:
            raise ValueError(f"slot {slot} is not in use")
        self._busy.discard(slot)
        self._free.append(slot)


def default_prefill_buckets(max_len: int) -> List[int]:
    """Powers of two up to max_len (max_len always included)."""
    buckets = []
    b = 2
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return buckets


def _decode_paged_fn(params, pool, cur, pos, active, block_tables, keys, steps, temps,
                     *, cfg: LMConfig):
    """One decode step over ALL slots through the block tables.  Inactive
    slots sit at position 0 with an all-garbage block table row, so their
    discarded writes land in the garbage page; their token is -1."""
    pos_eff = torch.where(active, pos, 0)
    logits, pool = lm.decode_step_paged(params, {"tokens": cur[:, None]}, pos_eff, pool,
                                        block_tables, cfg)
    nxt = sample_tokens(logits[:, -1], keys, steps, temps)
    return pool, torch.where(active, nxt, -1)


def _burst_prefill_fn(params, pool, tokens, block_tables, slots, ctx_len, tail_valid,
                      keys, temps, *, cfg: LMConfig, page_size: int, use_context: bool):
    """Prefill a whole admission burst into the paged pool and sample each
    member's first token at per-request step 0.  Padding rows carry
    tail_valid 0 and an all-garbage block table; their token is junk the
    host ignores."""
    pool, logits = lm.prefill_paged(params, {"tokens": tokens}, cfg, pool, block_tables,
                                    slots, ctx_len, tail_valid, page_size, use_context)
    toks = sample_tokens(logits[:, -1], keys, np.zeros(tokens.shape[0], np.int64), temps)
    return pool, toks


class StreamHandle:
    """One submitted request.  Its tokens land on the handle as the
    session produces them (the first at admission, one per decode step):
    ``generated`` reads them so far, ``result`` is the final
    :class:`RequestResult` (None until the request retires)."""

    def __init__(self, request: Request, key: int):
        self.request = request
        self.rid = request.rid
        self.key = key
        self.result: Optional[RequestResult] = None
        self._tokens: List[int] = []
        self._seq = -1                   # session submission order

    @property
    def done(self) -> bool:
        return self.result is not None

    @property
    def generated(self) -> np.ndarray:
        return np.asarray(self._tokens, np.int32)


class ServeSession:
    """Long-lived serving state over one :class:`Scheduler`.

    A *trace* is one busy period: it begins when a request is submitted
    to an idle session and ends when the last live request retires.  Step
    numbers (``arrival``, ``admitted_step``, ``finished_step``) are
    relative to the current trace; the pool and the prefix index persist
    across traces.  ``submit()`` enqueues one request, ``step()`` runs one
    tick (admissions, then one decode step over all slots), ``drain()``
    steps until idle, ``serve()`` is submit-all + drain."""

    def __init__(self, sched: "Scheduler"):
        self.s = sched
        S = sched.max_slots
        self.pool = lm.init_paged_pool(sched.cfg, S, sched.n_pages, sched.page_size,
                                       sched.device)
        self.ppool = PagePool(sched.n_pages, sched.page_size)
        self.btables = np.zeros((S, sched.pages_per_slot), np.int32)
        self.pool_bytes = lm.pool_nbytes(self.pool)
        self.alloc = SlotAllocator(S)
        self.pos = np.zeros(S, np.int32)
        self.active = np.zeros(S, bool)
        self.cur = np.zeros(S, np.int32)
        self.keys = np.zeros(S, np.int64)
        self.steps = np.zeros(S, np.int64)     # tokens sampled per occupant
        self.temps = np.zeros(S, np.float32)
        self.occupant: List[Optional[dict]] = [None] * S
        # Pending admissions, sorted by (arrival, submission seq).
        self.queue: List[StreamHandle] = []
        self._seq = 0
        self._live_rids: Set[int] = set()
        self._next_rid = 0
        self.trace_index = -1
        self._in_trace = False
        self.last_stats: Optional[ServeStats] = None
        self._reset_trace_counters()

    # --------------------------- trace lifecycle -----------------------------
    def _reset_trace_counters(self) -> None:
        self.step_idx = 0
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_batches = 0
        self.active_slot_steps = 0
        self.gen_tokens = 0
        self.decode_step_s: List[float] = []
        self.prefill_s: List[tuple] = []
        self._t0 = time.perf_counter()
        self._pg0 = self.ppool.stats.snapshot()

    def _ensure_trace(self) -> None:
        if self._in_trace:
            return
        self.trace_index += 1
        self._in_trace = True
        self.ppool.begin_trace()
        self._reset_trace_counters()

    def _finalize_trace(self) -> None:
        self._in_trace = False
        stats = ServeStats(
            steps=self.step_idx,
            decode_steps=self.decode_steps,
            prefills=self.prefills,
            max_slots=self.s.max_slots,
            generated_tokens=self.gen_tokens,
            wall_s=time.perf_counter() - self._t0,
            occupancy=(self.active_slot_steps / (self.decode_steps * self.s.max_slots)
                       if self.decode_steps else 0.0),
            prefill_batches=self.prefill_batches,
            prefix_reuse_active=self.s.prefix_reuse_active,
            paging=self.ppool.stats.delta(self._pg0),
            trace_index=self.trace_index,
            pool_bytes=self.pool_bytes,
            decode_step_s=list(self.decode_step_s),
            prefill_s=list(self.prefill_s),
        )
        self.last_stats = stats
        self.s.last_stats = stats

    @property
    def idle(self) -> bool:
        """No queued and no decoding requests."""
        return not self.queue and not self.active.any()

    # ----------------------------- submission --------------------------------
    def _validate(self, req: Request) -> None:
        if req.n_tokens < 1:
            raise ValueError(f"request {req.rid}: n_tokens must be >= 1")
        if req.prompt.size < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        check_capacity(req.prompt.size, req.n_tokens, self.s.max_len)
        check_page_capacity(req.prompt.size, req.n_tokens, self.s.page_size,
                            self.s.n_pages - 1)
        if req.rid in self._live_rids:
            raise ValueError(
                f"duplicate request id {req.rid}: a request with this id "
                f"is still queued or decoding in this session")

    @staticmethod
    def _qkey(handle: StreamHandle):
        return (handle.request.arrival, handle._seq)

    def _enqueue(self, req: Request, seed: Optional[int]) -> StreamHandle:
        seed = self.s.seed if seed is None else seed
        key = int(derive_request_keys(seed, [req.rid])[0])
        self._ensure_trace()
        handle = StreamHandle(req, key)
        handle._seq = self._seq
        self._seq += 1
        self._live_rids.add(req.rid)
        keys = [self._qkey(h) for h in self.queue]
        self.queue.insert(bisect.bisect_right(keys, self._qkey(handle)), handle)
        return handle

    def submit(self, request: Union[Request, np.ndarray, list],
               seed: Optional[int] = None) -> StreamHandle:
        """Enqueue one request, validated now and admitted by a later
        ``step()``.  A failed validation leaves the session untouched."""
        req = request if isinstance(request, Request) else Request(prompt=request)
        if req.rid is None:
            while self._next_rid in self._live_rids:
                self._next_rid += 1
            req = dataclasses.replace(req, rid=self._next_rid)
            self._next_rid += 1
        self._validate(req)
        return self._enqueue(req, seed)

    def serve(self, requests: Sequence[Union[Request, np.ndarray, list]],
              seed: Optional[int] = None) -> List[RequestResult]:
        """Submit a whole arrival trace and drain it; results come back in
        submission order and the trace's ``ServeStats`` lands on
        ``last_stats``.  The whole batch is validated before any request
        is enqueued.  Default rids count up from 0, skipping live ones."""
        reqs: List[Request] = []
        taken = set(self._live_rids)
        for i, r in enumerate(requests):
            if not isinstance(r, Request):
                r = Request(prompt=r)
            if r.rid is None:
                rid = i
                while rid in taken:
                    rid += 1
                r = dataclasses.replace(r, rid=rid)
                taken.add(rid)
            reqs.append(r)
        check_unique_rids([r.rid for r in reqs])
        for r in reqs:
            self._validate(r)
        if not reqs:
            if self.idle:
                self._ensure_trace()
                self._finalize_trace()
            return []
        handles = [self._enqueue(r, seed) for r in reqs]
        self.drain()
        return [h.result for h in handles]

    # ------------------------------ stepping ---------------------------------
    def drain(self) -> None:
        while not self.idle:
            self.step()

    def step(self) -> int:
        """One scheduler tick: admit every eligible queued request that
        fits (FIFO, in burst groups), then one decode step over the
        active slots.  Returns the tokens produced this tick (admission
        first-tokens included); 0 on an idle session."""
        if self.idle:
            return 0
        before = self.gen_tokens
        with torch.no_grad(), self.s._numerics():
            self._admit_all()
            if not self.active.any():
                if self.queue and self.queue[0].request.arrival <= self.step_idx:
                    # Nothing runs, so no live request holds pages: an
                    # eligible request that passed check_page_capacity
                    # must fit.
                    raise RuntimeError(
                        "admission stalled with an idle pool: page accounting bug")
                if self.queue:
                    # Nothing running: jump to the next arrival.
                    self.step_idx = max(self.step_idx + 1, self.queue[0].request.arrival)
                else:
                    self._finalize_trace()
                return self.gen_tokens - before
            self._decode_once()
        if self.idle:
            self._finalize_trace()
        return self.gen_tokens - before

    def _decode_once(self) -> None:
        dev = self.s.device
        t0 = time.perf_counter()
        self.pool, nxt = _decode_paged_fn(
            self.s.params, self.pool, torch.as_tensor(self.cur, device=dev),
            torch.as_tensor(self.pos, device=dev), torch.as_tensor(self.active, device=dev),
            torch.as_tensor(self.btables, device=dev), self.keys, self.steps, self.temps,
            cfg=self.s.cfg)
        nxt = nxt.cpu().numpy()
        self.decode_step_s.append(time.perf_counter() - t0)
        self.decode_steps += 1
        self.active_slot_steps += int(self.active.sum())
        self.step_idx += 1
        self.pos[self.active] += 1
        self.steps[self.active] += 1
        for slot in np.flatnonzero(self.active):
            tok = int(nxt[slot])
            st = self.occupant[slot]
            self._record_token(st["handle"], tok)
            st["remaining"] -= 1
            self.cur[slot] = tok
            if st["remaining"] == 0 or tok == self.s.eos_id:
                self._finish(slot)

    def _record_token(self, handle: StreamHandle, tok: int) -> None:
        handle._tokens.append(int(tok))
        self.gen_tokens += 1

    # --------------------------- slot bookkeeping ----------------------------
    def _finish(self, slot: int) -> None:
        st = self.occupant[slot]
        handle: StreamHandle = st["handle"]
        req = handle.request
        handle.result = RequestResult(
            rid=req.rid,
            tokens=np.concatenate([req.prompt, np.asarray(handle._tokens, np.int32)]),
            prompt_len=req.prompt.size,
            arrival=req.arrival,
            admitted_step=st["admitted"],
            finished_step=self.step_idx,
            finished_wall_s=time.perf_counter() - self._t0,
            prefix_hit_tokens=st["prefix_hit_tokens"],
        )
        self._live_rids.discard(req.rid)
        self.ppool.release(st["pages"])
        # An inactive slot's clamped decode write must land in the
        # garbage page, never in a (possibly reallocated) page of the
        # retired occupant.
        self.btables[slot, :] = 0
        self.occupant[slot] = None
        self.active[slot] = False
        self.alloc.release(slot)

    def _seat(self, slot: int, handle: StreamHandle, tok0: int, pages: List[int],
              hit_tokens: int) -> None:
        """Post-prefill bookkeeping: the slot decodes from position P with
        the first sampled token as its input."""
        req = handle.request
        self.occupant[slot] = {
            "handle": handle, "remaining": req.n_tokens - 1, "admitted": self.step_idx,
            "pages": pages, "prefix_hit_tokens": min(hit_tokens, req.prompt.size),
        }
        self.pos[slot] = req.prompt.size
        self.active[slot] = True
        self.cur[slot] = tok0
        self.keys[slot] = handle.key
        self.steps[slot] = 1
        self.temps[slot] = req.temperature
        self._record_token(handle, tok0)
        if self.occupant[slot]["remaining"] == 0 or tok0 == self.s.eos_id:
            self._finish(slot)

    # ------------------------------ admission --------------------------------
    def _candidate(self) -> Optional[StreamHandle]:
        """The FIFO head, if its arrival step has come."""
        if self.queue and self.queue[0].request.arrival <= self.step_idx:
            return self.queue[0]
        return None

    def _try_admit(self, handle: StreamHandle, pending: Set[int]):
        """Reserve a slot and pages for ``handle``'s request.  Returns an
        admission dict, None (no slot, or not enough pages now), or
        "conflict" (its prefix pages are pending fill in the current
        burst: flush the burst first)."""
        if not self.alloc.free_count:
            return None
        req = handle.request
        ppool = self.ppool
        need = pages_needed(req.prompt.size, req.n_tokens, self.s.page_size)
        if self.s.prefix_reuse_active:
            matched, hashes = ppool.match_prefix(req.prompt)
        else:
            matched, hashes = [], []
        if pending.intersection(matched):
            return "conflict"
        ppool.ref(matched)          # pin before allocation can evict
        fresh_needed = need - len(matched)
        if fresh_needed > ppool.available():
            ppool.unref(matched)    # roll back the pin (and its stats)
            return None
        fresh = ppool.allocate(fresh_needed)
        pages = matched + fresh
        if self.s.prefix_reuse_active and len(hashes) > len(matched):
            # The whole tail fills this step, so every covered page can
            # be indexed now.
            ppool.register_prefix(
                hashes[len(matched):], pages[len(matched):len(hashes)],
                parent=hashes[len(matched) - 1] if matched else None)
        slot = self.alloc.acquire()
        self.btables[slot, :need] = pages
        self.btables[slot, need:] = 0
        ctx = len(matched) * self.s.page_size
        return {"handle": handle, "slot": slot, "pages": pages, "ctx_len": ctx,
                "tail": req.prompt[ctx:], "fresh": fresh}

    def _run_group(self, group: List[dict]) -> None:
        """One burst-prefill program over the group, padded to a
        power-of-two width and the tail bucket."""
        S = self.s.max_slots
        Bg = len(group)
        Bpad = 1 << (Bg - 1).bit_length()
        bucket = self.s._bucket_for(max(len(g["tail"]) for g in group))
        tokens = np.zeros((Bpad, bucket), np.int32)
        bt = np.zeros((Bpad, self.s.pages_per_slot), np.int32)
        slots = np.full(Bpad, S, np.int32)      # the garbage slot for padding rows
        ctx = np.zeros(Bpad, np.int32)
        tv = np.zeros(Bpad, np.int32)
        temps = np.zeros(Bpad, np.float32)
        keys = np.zeros(Bpad, np.int64)
        for i, g in enumerate(group):
            T = len(g["tail"])
            tokens[i, :T] = g["tail"]
            bt[i] = self.btables[g["slot"]]
            slots[i] = g["slot"]
            ctx[i] = g["ctx_len"]
            tv[i] = T
            temps[i] = g["handle"].request.temperature
            keys[i] = g["handle"].key
        dev = self.s.device
        t0 = time.perf_counter()
        self.pool, toks = _burst_prefill_fn(
            self.s.params, self.pool, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(bt, device=dev), torch.as_tensor(slots, device=dev),
            torch.as_tensor(ctx, device=dev), torch.as_tensor(tv, device=dev), keys, temps,
            cfg=self.s.cfg, page_size=self.s.page_size, use_context=self.s._use_context)
        toks = toks.cpu().numpy()
        self.prefill_s.append((Bpad, bucket, time.perf_counter() - t0))
        self.prefills += Bg
        self.prefill_batches += 1
        for i, g in enumerate(group):
            self._seat(g["slot"], g["handle"], int(toks[i]), g["pages"], g["ctx_len"])

    def _admit_round(self) -> bool:
        """Build and run one burst group in FIFO order.  Returns True when
        anything was admitted or a conflict flushed the group: another
        round may then make progress."""
        group: List[dict] = []
        pending: Set[int] = set()
        conflict = False
        while True:
            handle = self._candidate()
            if handle is None:
                break
            adm = self._try_admit(handle, pending)
            if adm == "conflict":
                conflict = True
                break
            if adm is None:
                break
            self.queue.pop(0)
            group.append(adm)
            pending.update(adm["fresh"])
            if not self.s.burst_prefill:
                break
        if group:
            self._run_group(group)
        return bool(group) or conflict

    def _admit_all(self) -> None:
        while self._admit_round():
            pass


class Scheduler:
    """Continuous-batching server over a paged KV-cache pool on the
    device of ``params``.  All serve-loop state lives in a persistent
    :class:`ServeSession` (``session()``), shared by every ``serve()`` /
    ``submit()`` / ``step()`` call."""

    def __init__(self, cfg: LMConfig, params, max_slots: int = 4, max_len: int = 512,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, seed: int = 0, dcim_sim=None,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefix_reuse: bool = True, burst_prefill: bool = True):
        lm.check_supported(cfg)
        if max_slots < 1:
            raise ValueError(f"need at least one slot, got {max_slots}")
        self.cfg = cfg
        self.params = params
        self.device = params["ln_f"]["scale"].device
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.seed = seed
        self.dcim_sim = dcim_sim
        if prefill_buckets is None:
            prefill_buckets = default_prefill_buckets(self.max_len)
        buckets = sorted(set(int(b) for b in prefill_buckets))
        if not buckets or buckets[0] < 1 or buckets[-1] > self.max_len:
            raise ValueError(f"bad prefill buckets {buckets} for max_len {self.max_len}")
        if buckets[-1] != self.max_len:
            buckets.append(self.max_len)   # every admissible prompt fits somewhere
        self.prefill_buckets = buckets
        self.page_size = int(page_size)
        self.burst_prefill = bool(burst_prefill)
        if self.max_len % self.page_size:
            raise ValueError(f"max_len {self.max_len} must be a multiple of "
                             f"page_size {self.page_size}")
        self.pages_per_slot = self.max_len // self.page_size
        if n_pages is None:
            # Every slot can hold a full max_len sequence with zero
            # sharing, plus the garbage page.
            n_pages = self.max_slots * self.pages_per_slot + 1
        self.n_pages = int(n_pages)
        if self.n_pages < 2:
            raise ValueError(f"need >= 2 pages, got {self.n_pages}")
        # Prefix reuse must be token-exact against a full prefill:
        #  * an SSM layer carries recurrent state, which no page holds:
        #    a tail prefilled over reused pages would start from a zero
        #    state instead of the prefix's;
        #  * a lossy cache dtype would hand the tail prefill rounded
        #    context where the full prefill attends compute-dtype values.
        period = cfg.scan_period()
        has_ssm = any(cfg.mixer_kind(i) == "mamba" for i in range(period))
        self._ctx_exact = not has_ssm and cfg.cache_dtype == cfg.compute_dtype
        self.prefix_reuse = bool(prefix_reuse)
        self.prefix_reuse_active = self.prefix_reuse and self._ctx_exact
        # The prefill's context gather runs only when some admission can
        # carry ctx_len > 0.
        self._use_context = self.prefix_reuse_active
        self.last_stats: Optional[ServeStats] = None
        self._session: Optional[ServeSession] = None

    def _numerics(self):
        return numerics_ctx(self.dcim_sim)

    def _bucket_for(self, prompt_len: int) -> int:
        i = bisect.bisect_left(self.prefill_buckets, prompt_len)
        if i == len(self.prefill_buckets):   # unreachable: buckets end at max_len
            raise ValueError(f"prompt length {prompt_len} exceeds every bucket")
        return self.prefill_buckets[i]

    def session(self) -> ServeSession:
        """The persistent :class:`ServeSession` (created on first use)."""
        if self._session is None:
            self._session = ServeSession(self)
        return self._session

    def submit(self, request, seed: Optional[int] = None) -> StreamHandle:
        return self.session().submit(request, seed=seed)

    def step(self) -> int:
        return self.session().step()

    def drain(self) -> None:
        self.session().drain()

    def serve(self, requests: Sequence[Union[Request, np.ndarray, list]],
              seed: Optional[int] = None) -> List[RequestResult]:
        """Serve an arrival trace to completion through the persistent
        session; results in submission order, stats on ``last_stats``."""
        return self.session().serve(requests, seed=seed)

