"""Continuous-batching serving: paged KV-cache pool, persistent
sessions, streaming delivery, concurrent multi-tenant front end.

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
    until allocation pressure evicts them.
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
``submit()`` returns a :class:`StreamHandle` whose tokens are observable
as they are produced (``on_token`` callback, ``stream()``, ``wait()``).

The multi-tenant front end:

  * **thread safety**: one re-entrant lock (a ``threading.Condition``)
    guards all session state; producers on any thread may ``submit()``,
    ``stream()`` and ``wait()`` concurrently.
  * **single pump**: ``start()`` launches one background thread that
    owns ``step()``; while it runs, ``step()`` from any other thread
    raises and blocking observers wait on the condition.  Without a
    pump the session is stepped cooperatively by its observers.
  * **priority and fairness**: ``Request.priority`` (a weight >= 1)
    selects admissions by stride scheduling: each class accumulates
    virtual time ``1/priority`` per admission and the eligible class
    with the least virtual time admits next (FIFO within a class; a lone
    class is plain FIFO).
  * **shedding**: ``max_queue`` bounds the pending queue; an overloaded
    ``submit()`` / ``serve()`` raises ``engine.check_queue_capacity``'s
    ``ValueError`` and leaves the session untouched.
  * **preemption**: under sustained slot or page pressure a strictly
    higher-priority arrival evicts the lowest-priority occupant.  Its
    pages are released (registered prefix pages stay cached) and it
    re-queues; on re-admission it re-prefills ``prompt +
    generated[:-1]``, hitting its own cached pages, and resumes decoding
    at the position it left.
  * **chunked prefill**: with ``prefill_chunk=C`` a long prompt tail
    fills C tokens per tick (one batched program over all chunking
    slots, at any context length, page-aligned or not), so co-tenant
    decode steps interleave with the fill.

``paged=False`` is the monolithic per-slot path (``lm.prefill`` +
``lm.insert_cache_slot``, ``lm.decode_step``: the plain attention, no
kernel) through the same session machinery.  Prefix reuse, preemption
and chunked prefill are on only where they are token-exact: no SSM
layer (a recurrent state is not held in pages) and a cache dtype equal
to the compute dtype (re-read pages would otherwise hand the tail
rounded context).

Scheduling never changes numerics: greedy tokens equal ``Engine``'s run
per request and the JAX reference's (``tests/test_torch_serve.py``,
``tests/test_torch_serve_tenants.py``).  On the card a re-prefill runs
K5's bf16 products and GEMMs at other batch shapes than the decode that
first wrote those positions, so a resumed stream is held to the
``Engine``'s teacher-forced logits rather than bit for bit.  The port
runs no jit: ``compile_counts()`` counts the distinct program shapes
that have run, the reference's jit-cache budget.  The burst prefill and
the decode step label their rows with the requests' ids and positions
(``moe.label_rows``) for a routing hook, and do nothing more with them.

``Scheduler(mesh=, tp=)`` serves exactly tensor/expert-parallel over a
``torch.distributed`` process group, one process a rank: each rank
keeps its shards of the params (``dist.serve_param_sharding_tree``) and
of the pool (``dist.serve_pool_sharding_tree``, built at the local kv
heads), and every step runs under the serving context, whose gathers
keep every product the single-device one.  Each rank runs the same host
Scheduler on the same calls, so admissions, pages and preemptions are
the same everywhere, and tokens are sampled from gathered logits, so
they are too.  ``compile_counts()`` does not change with the mesh.
Two ways to drive it: every rank calls ``step()`` / ``serve()`` in
lockstep, or the ranks ``start()`` their pumps and rank 0 of the model
group is the front end.  Its pump sends one tick message over the group
before each tick (the submissions and sheds accepted since the last, in
order, and the stop flag or its error); each follower's pump receives
it, applies it through the same bookkeeping and steps, so the ranks
tick alike.  Only the front end takes submissions while pumping, and
only its handles run callbacks; a follower's handles mirror its
(``ServeSession.mirrored``).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import device as _device
from ..dist import sharding as shd
from ..models import lm, moe
from ..models.config import LMConfig
from ..launch.mesh import make_local_mesh
from .engine import (
    check_capacity,
    check_queue_capacity,
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
    priority: int = 1                  # fairness weight (>= 1, higher = more
                                       # slot share; may preempt lower classes)
    tenant: str = "default"            # reporting label, carried to the result

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray                 # (P + generated,) prompt included
    prompt_len: int
    arrival: int
    admitted_step: int                 # first admission (preemptions keep it)
    finished_step: int
    finished_wall_s: float             # seconds since the trace started
    prefix_hit_tokens: int = 0         # prompt tokens served from cached pages
    priority: int = 1
    tenant: str = "default"
    preemptions: int = 0               # times this request was evicted and resumed

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
    paging: Optional[dict] = None      # per-trace PageStats delta (paged mode)
    trace_index: int = 0               # which trace of the session this was
    pool_bytes: int = 0                # device cache-pool footprint
    preemptions: int = 0               # occupants evicted for a higher class
    prefill_chunks: int = 0            # chunked-prefill rows advanced
    shed: int = 0                      # submissions rejected by max_queue
    # Host seconds of each program call, ending on its sampled tokens
    # reaching the host (so on the card they include the device time):
    decode_step_s: List[float] = dataclasses.field(default_factory=list)
    prefill_s: List[tuple] = dataclasses.field(default_factory=list)  # (width, bucket, s)
    # Per paged prefill program, the context length of each real row (a
    # chunk advance's rows start at their fill so far):
    prefill_ctx: List[tuple] = dataclasses.field(default_factory=list)


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


def _prefill_fn(params, pool, tokens, valid_len: int, slot: int, key, temp, *,
                cfg: LMConfig, max_len: int):
    """Monolithic (paged=False) prefill of one request, right-padded to
    its bucket: overwrite slot ``slot`` of the pool with its cache and
    sample its first token at per-request step 0."""
    caches, logits = lm.prefill(params, {"tokens": tokens}, cfg, max_len=max_len,
                                valid_len=valid_len)
    lm.insert_cache_slot(pool, caches, slot)
    tok0 = sample_tokens(logits[:, -1], [key], np.zeros(1, np.int64), temp)
    return pool, tok0


def _decode_fn(params, pool, cur, pos, active, keys, steps, temps, *, cfg: LMConfig):
    """Monolithic (paged=False) decode over ALL slots: ``pos`` is the
    per-slot length vector; inactive slots sit at position 0 of their own
    row (overwritten whole at the next admission) and their token is -1."""
    pos_eff = torch.where(active, pos, 0)
    logits, pool = lm.decode_step(params, {"tokens": cur[:, None]}, pos_eff, pool, cfg)
    nxt = sample_tokens(logits[:, -1], keys, steps, temps)
    return pool, torch.where(active, nxt, -1)


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
    """Prefill a whole admission burst (or one chunked-prefill advance
    over all chunking slots) into the paged pool and sample each member's
    first token at per-request step 0.  Padding rows carry tail_valid 0
    and an all-garbage block table; their token is junk the host ignores
    (as is every non-final chunk row's)."""
    pool, logits = lm.prefill_paged(params, {"tokens": tokens}, cfg, pool, block_tables,
                                    slots, ctx_len, tail_valid, page_size, use_context)
    toks = sample_tokens(logits[:, -1], keys, np.zeros(tokens.shape[0], np.int64), temps)
    return pool, toks


class StreamHandle:
    """Observable handle for one submitted request.

    Tokens land on the handle as the session produces them: the first at
    admission (sampled by the prefill program), one more per decode step
    until retirement (EOS or ``n_tokens``).  Three ways to observe them:

      * ``on_token(handle, token)``: called for every produced token,
        from inside the step, after that step's slot bookkeeping (so a
        raising callback interrupts the caller but never corrupts the
        session; the callbacks it pre-empted fire on the next step).
        With a pump thread running, delivery is pinned to it.
      * ``stream()``: an iterator over the tokens as they are produced.
        On a driven session it blocks on delivered tokens; on an undriven
        one it pumps ``step()`` under the session lock.
      * ``wait(timeout=None)``: block until the request retires and
        return its :class:`RequestResult`.

    ``result`` is the final :class:`RequestResult` (None until the
    request retires); ``generated`` is the tokens produced so far."""

    def __init__(self, session: "ServeSession", request: Request, key: int,
                 on_token: Optional[Callable[["StreamHandle", int], None]] = None):
        self.session = session
        self.request = request
        self.rid = request.rid
        self.key = key
        self.on_token = on_token
        self.result: Optional[RequestResult] = None
        self._tokens: List[int] = []
        self._seq = -1                   # session submission order
        self._admitted: Optional[int] = None   # first admission step
        self._hit_tokens0 = 0            # prefix hits at first admission
        self._preempt_count = 0
        self._blocked_at: Optional[int] = None  # step first resource-blocked

    @property
    def done(self) -> bool:
        return self.result is not None

    @property
    def n_generated(self) -> int:
        return len(self._tokens)

    @property
    def generated(self) -> np.ndarray:
        with self.session._cv:
            return np.asarray(self._tokens, np.int32)

    def wait(self, timeout: Optional[float] = None) -> RequestResult:
        """Block until this request retires; returns its result.  On a
        driven session this waits on the pump, otherwise it pumps the
        session.  Raises ``TimeoutError`` if ``timeout`` (seconds)
        elapses first, and re-raises a pump failure."""
        sess = self.session
        deadline = None if timeout is None else time.monotonic() + timeout
        with sess._cv:
            while not self.done:
                sess._raise_pump_error()
                if sess._driven_elsewhere():
                    if not sess._cv_wait(deadline):
                        raise TimeoutError(f"request {self.rid} not done after {timeout}s")
                else:
                    sess._step_locked()
            return self.result

    def stream(self) -> Iterator[int]:
        """Yield this request's generated tokens in order, never holding
        the session lock across a ``yield``.  With a pump thread running
        this blocks on delivered tokens; without one it steps the session
        itself (other requests progress too)."""
        i = 0
        sess = self.session
        while True:
            with sess._cv:
                while not self._tokens[i:] and not self.done:
                    sess._raise_pump_error()
                    if sess._driven_elsewhere():
                        sess._cv.wait()
                    else:
                        sess._step_locked()
                batch = self._tokens[i:]
                finished = self.done
            if not batch and finished:
                return
            yield from batch
            i += len(batch)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "done" if self.done else "live"
        return f"StreamHandle(rid={self.rid}, {state}, {self.n_generated} tokens)"


class ServeSession:
    """Long-lived serving state over one :class:`Scheduler`.

    The device pool (paged or monolithic), the ``PagePool`` index, the
    slot allocator and the per-slot host arrays are built once and kept
    across traces.  A *trace* is one busy period: it begins when a request
    is submitted to an idle session and ends when the last live request
    retires.  Step numbers (``arrival``, ``admitted_step``,
    ``finished_step``) are relative to the current trace.

    ``submit()`` enqueues one request and returns its
    :class:`StreamHandle`; ``step()`` runs one tick (admissions, the
    chunked-prefill advance, then one decode step over all slots);
    ``drain()`` steps (or, driven, waits) until idle; ``serve()`` is
    submit-all + drain, results in submission order.

    Threading: one re-entrant lock, the condition ``_cv``, guards all
    session state, and every public method takes it.  ``start()`` spawns
    the single pump thread, which then alone may step; ``stop()`` joins
    it.  ``on_token`` callbacks run on the stepping thread with the lock
    held, so a callback may call ``submit()`` but must not block on
    another thread's session call.  Under a model axis of more than one
    rank the pumps of the group's sessions tick together, led by rank 0
    (``start()``); one pumped session a group at a time."""

    def __init__(self, sched: "Scheduler"):
        self.s = sched
        S = sched.max_slots
        if sched.paged:
            self.pool = sched._local_pool(lambda dev: lm.init_paged_pool(
                sched.cfg, S, sched.n_pages, sched.page_size, dev))
            self.ppool: Optional[PagePool] = PagePool(sched.n_pages, sched.page_size)
            self.btables = np.zeros((S, sched.pages_per_slot), np.int32)
        else:
            self.pool = sched._local_pool(lambda dev: lm.init_cache(
                sched.cfg, S, sched.max_len, dev))
            self.ppool = None
            self.btables = None
        self.pool_bytes = lm.pool_nbytes(self.pool)
        self.alloc = SlotAllocator(S)
        self.pos = np.zeros(S, np.int32)
        self.active = np.zeros(S, bool)
        self.cur = np.zeros(S, np.int32)
        self.keys = np.zeros(S, np.int64)
        self.steps = np.zeros(S, np.int64)     # tokens sampled per occupant
        self.temps = np.zeros(S, np.float32)
        self.occupant: List[Optional[dict]] = [None] * S
        # Pending admissions, sorted by (arrival, submission seq).  A plain
        # list: fairness selection and preemption re-queueing remove and
        # insert at arbitrary positions.
        self.queue: List[StreamHandle] = []
        self._seq = 0
        # Stride scheduling: virtual time per priority class, and the
        # floor a newly active class starts from.
        self._vt: Dict[int, float] = {}
        self._vt_floor = 0.0
        # Slots whose prompt is still chunk-filling: busy in the
        # allocator, inactive for decode.
        self._chunk_slots: Set[int] = set()
        # Tokens recorded whose on_token callbacks have not fired yet:
        # callbacks run after a step's bookkeeping is complete.
        self._events: "deque[Tuple[StreamHandle, int]]" = deque()
        self._live_rids: Set[int] = set()
        self._next_rid = 0
        self.trace_index = -1
        self._in_trace = False
        self.last_stats: Optional[ServeStats] = None
        # Session-lifetime totals (the per-trace values land on ServeStats).
        self.total_preemptions = 0
        self.total_prefill_chunks = 0
        self.total_shed = 0
        self._cv = threading.Condition(threading.RLock())
        self._pump_thread: Optional[threading.Thread] = None
        self._pump_ident: Optional[int] = None
        self._stop_flag = False
        self._pump_error: Optional[BaseException] = None
        # A model axis of more than one rank: the pumps tick together over
        # its group, led by the front end, the group's rank 0.  The front
        # end records what it accepts for its next tick message; a
        # follower keeps the handles it mirrors.
        ctx = sched.mesh_ctx
        self._tp = 1 if ctx is None else ctx.size("model")
        self._group = ctx.group("model") if self._tp > 1 else None
        self._front = None if self._group is None else dist.get_global_rank(self._group, 0)
        self._follower = self._group is not None and dist.get_rank(self._group) != 0
        self._outbox: List[tuple] = []
        self.mirrored: List[StreamHandle] = []
        self._reset_trace_counters()

    # --------------------------- trace lifecycle -----------------------------
    def _reset_trace_counters(self) -> None:
        self.step_idx = 0
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_batches = 0
        self.active_slot_steps = 0
        self.gen_tokens = 0
        self.preemptions = 0
        self.prefill_chunks = 0
        self.shed = 0
        self.decode_step_s: List[float] = []
        self.prefill_s: List[tuple] = []
        self.prefill_ctx: List[tuple] = []
        self._t0 = time.perf_counter()
        self._pg0 = self.ppool.stats.snapshot() if self.ppool else None

    def _ensure_trace(self) -> None:
        if self._in_trace:
            return
        self.trace_index += 1
        self._in_trace = True
        if self.ppool is not None:
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
            paging=self.ppool.stats.delta(self._pg0) if self.ppool is not None else None,
            trace_index=self.trace_index,
            pool_bytes=self.pool_bytes,
            preemptions=self.preemptions,
            prefill_chunks=self.prefill_chunks,
            shed=self.shed,
            decode_step_s=list(self.decode_step_s),
            prefill_s=list(self.prefill_s),
            prefill_ctx=list(self.prefill_ctx),
        )
        self.last_stats = stats
        self.s.last_stats = stats

    @property
    def idle(self) -> bool:
        """No queued, no decoding and no chunk-filling requests."""
        return not self.queue and not self.active.any() and not self._chunk_slots

    # -------------------------------- pump -----------------------------------
    def _driven_elsewhere(self) -> bool:
        """A background pump owns stepping and this is not its thread."""
        return self._pump_thread is not None and threading.get_ident() != self._pump_ident

    def _raise_pump_error(self) -> None:
        """Re-raise (once) an exception that killed the pump."""
        err, self._pump_error = self._pump_error, None
        if err is not None:
            raise err

    def _cv_wait(self, deadline: Optional[float]) -> bool:
        """Wait on the condition until notified; False past the deadline."""
        if deadline is None:
            self._cv.wait()
            return True
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        self._cv.wait(remaining)
        return True

    def start(self) -> "ServeSession":
        """Launch the background pump thread, from then on the only thread
        allowed to step.  Raises if a pump is already running.

        Under a model axis of more than one rank every rank of the group
        starts its pump.  Rank 0 is the front end: only it takes
        ``submit()`` / ``serve()`` while pumping (a follower raises), and
        before each tick its pump sends the group one message with what
        it accepted since the last tick (what it queued before
        ``start()`` goes in the first), the sheds, and the stop flag.  A
        follower's pump blocks on that message without the session lock,
        applies it, and steps.  ``stop()`` on the front end sends the
        stop; on a follower it waits for it.  An error that kills the
        front end's pump goes out in the next message and is raised on
        every rank.  A model axis given as sizes has no group to follow
        and refuses."""
        if self._tp > 1 and self._group is None:
            raise RuntimeError(
                f"the pump thread under a model axis of {self._tp} ranks needs their "
                "process group, and a mesh given as sizes has none: pass a DeviceMesh, "
                "or drive the session with step() / serve() on each rank")
        with self._cv:
            if self._pump_thread is not None:
                raise RuntimeError("session already has a background pump")
            self._pump_error = None
            self._stop_flag = False
            t = threading.Thread(target=self._follow if self._follower else self._pump,
                                 name="serve-session-pump", daemon=True)
            self._pump_thread = t
            self._pump_ident = None    # set by the pump itself, under _cv
            t.start()
        return self

    def stop(self) -> None:
        """Stop and join the pump; re-raises (once) an error that killed
        it, so a ``driving()`` exit never swallows a failure.  A
        follower's pump stops at the front end's stop message."""
        with self._cv:
            t = self._pump_thread
            if not self._follower:
                self._stop_flag = True
            self._cv.notify_all()
        if t is not None:
            t.join()
        with self._cv:
            self._pump_thread = None
            self._pump_ident = None
            self._raise_pump_error()

    @contextlib.contextmanager
    def driving(self):
        """``with session.driving():`` pumps in the background for the
        block's duration (``start()`` / ``stop()``)."""
        self.start()
        try:
            yield self
        finally:
            self.stop()

    def _pump_died(self, err: BaseException) -> None:
        """Stash ``err`` for observers and retire the pump; under the lock."""
        self._pump_error = err
        self._pump_thread = None
        self._pump_ident = None
        self._cv.notify_all()

    def _pump(self) -> None:
        """The pump takes the lock for one tick at a time and yields
        between ticks, so that observers read each tick's tokens and
        producers submit mid-trace.  (The reference holds the lock for a
        whole busy period: its observers see nothing until the trace
        ends, and a producer's submission waits for it.)  On a front end
        each tick first sends its message, under the lock, so that what
        it carries is exactly what the tick's step starts from."""
        with self._cv:
            self._pump_ident = threading.get_ident()
            self._cv.notify_all()
        while True:
            with self._cv:
                while not self._stop_flag and self.idle:
                    self._cv.wait()
                try:
                    if self._group is not None:
                        self._send_tick(stop=self._stop_flag)
                    if self._stop_flag:
                        return
                    self._step_locked()
                except BaseException as e:    # stash for observers, die
                    if self._group is not None:
                        with contextlib.suppress(Exception):   # the group may be broken
                            self._send_tick(error=e)
                    self._pump_died(e)
                    return
            time.sleep(0)                     # let a thread blocked on the lock take it

    def _send_tick(self, stop: bool = False, error: Optional[BaseException] = None) -> None:
        """The front end's tick message: what it accepted since the last
        tick, in order, then the stop flag or the error that killed it."""
        msg = {"entries": self._outbox, "next_rid": self._next_rid, "stop": stop,
               "error": None if error is None else f"{type(error).__name__}: {error}"}
        self._outbox = []
        dist.broadcast_object_list([msg], src=self._front, group=self._group)

    def _follow(self) -> None:
        """A follower's pump: receive each tick message without holding
        the lock, apply it under the lock, then step."""
        with self._cv:
            self._pump_ident = threading.get_ident()
            self._cv.notify_all()
        while True:
            box = [None]
            try:
                dist.broadcast_object_list(box, src=self._front, group=self._group)
            except BaseException as e:
                with self._cv:
                    self._pump_died(e)
                return
            msg = box[0]
            with self._cv:
                try:
                    for kind, what, seed in msg["entries"]:
                        if kind == "shed":
                            self._count_shed(what)
                        elif kind == "serve":
                            self.mirrored.extend(self._enqueue_batch(what, seed))
                        else:
                            self.mirrored.append(self._enqueue(what, seed))
                    self._next_rid = msg["next_rid"]
                    if msg["error"] is not None:
                        raise RuntimeError(f"the front end, rank {self._front}, failed: "
                                           f"{msg['error']}")
                    if msg["stop"]:
                        self._cv.notify_all()
                        return
                    self._step_locked()
                except BaseException as e:
                    self._pump_died(e)
                    return

    def wait_idle(self, timeout: Optional[float] = None) -> None:
        """Block until every queued and live request has retired: on a
        driven session by waiting on the pump, otherwise by stepping
        (``drain()``).  Raises ``TimeoutError`` on expiry."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                self._raise_pump_error()
                if self._driven_elsewhere():
                    if self.idle and not self._events:
                        return
                    if not self._cv_wait(deadline):
                        raise TimeoutError(f"session not idle after {timeout}s")
                    continue
                while not self.idle:
                    self._step_locked()
                self._emit_events()
                return

    # --------------------------- token delivery ------------------------------
    def _record_token(self, handle: StreamHandle, tok: int) -> None:
        """Record a produced token; its callback is deferred to the end of
        the step, so user code runs only against consistent state."""
        handle._tokens.append(int(tok))
        self.gen_tokens += 1
        if handle.on_token is not None:
            self._events.append((handle, int(tok)))

    def _emit_events(self) -> None:
        """Deliver deferred on_token callbacks; only the stepping thread
        (the pump, when driven) calls this."""
        while self._events:
            handle, tok = self._events.popleft()
            handle.on_token(handle, tok)

    # ----------------------------- submission --------------------------------
    def _validate(self, req: Request) -> None:
        if req.n_tokens < 1:
            raise ValueError(f"request {req.rid}: n_tokens must be >= 1")
        if req.prompt.size < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.priority < 1:
            raise ValueError(f"request {req.rid}: priority must be >= 1, got {req.priority}")
        check_capacity(req.prompt.size, req.n_tokens, self.s.max_len)
        if self.s.paged:
            check_page_capacity(req.prompt.size, req.n_tokens, self.s.page_size,
                                self.s.n_pages - 1)
        if req.rid in self._live_rids:
            raise ValueError(
                f"duplicate request id {req.rid}: a request with this id "
                f"is still queued or decoding in this session")

    def _check_queue_room(self, incoming: int) -> None:
        """Shed submissions that would overflow ``max_queue``; counted per
        trace and per session.  Preemption re-queues are exempt."""
        try:
            check_queue_capacity(len(self.queue), incoming, self.s.max_queue)
        except ValueError:
            self._count_shed(incoming)
            self._note("shed", incoming, None)
            raise

    def _count_shed(self, n: int) -> None:
        self.shed += n
        self.total_shed += n

    def _note(self, kind: str, reqs, seed: Optional[int]) -> None:
        """Record an accepted submission (or a shed) for the front end's
        next tick message.  A tick that no pump sends (lockstep) drops
        the record: every rank made those calls itself."""
        if self._group is not None and not self._follower:
            self._outbox.append((kind, reqs, seed))

    def _refuse_follower(self, what: str) -> None:
        if self._follower and self._pump_thread is not None:
            raise RuntimeError(
                f"{what}() on rank {dist.get_rank()}, which follows the front end of its "
                f"model group, rank {self._front}, while pumping: submit there")

    def _auto_rid(self) -> int:
        while self._next_rid in self._live_rids:
            self._next_rid += 1
        rid = self._next_rid
        self._next_rid += 1
        return rid

    @staticmethod
    def _qkey(handle: StreamHandle) -> Tuple[int, int]:
        return (handle.request.arrival, handle._seq)

    def _insert_sorted(self, handle: StreamHandle) -> None:
        keys = [self._qkey(h) for h in self.queue]
        self.queue.insert(bisect.bisect_right(keys, self._qkey(handle)), handle)

    def _enqueue(self, req: Request, seed: Optional[int], on_token=None,
                 sorted_insert: bool = True) -> StreamHandle:
        seed = self.s.seed if seed is None else seed
        key = int(derive_request_keys(seed, [req.rid])[0])
        self._ensure_trace()
        handle = StreamHandle(self, req, key, on_token=on_token)
        handle._seq = self._seq
        self._seq += 1
        self._live_rids.add(req.rid)
        if sorted_insert:
            self._insert_sorted(handle)
        else:
            self.queue.append(handle)   # the caller sorts the batch once
        return handle

    def _enqueue_batch(self, reqs: List[Request], seed: Optional[int]) -> List[StreamHandle]:
        """Enqueue a validated ``serve()`` batch: room for all of it or
        none, then one stable sort of the queue ((arrival, seq) never
        ties)."""
        if not reqs:
            # An empty serve lands fresh zero stats on an idle session;
            # mid-trace it must not finalize the running trace.
            if self.idle:
                self._ensure_trace()
                self._finalize_trace()
            return []
        self._check_queue_room(len(reqs))
        handles = [self._enqueue(r, seed, sorted_insert=False) for r in reqs]
        self.queue.sort(key=self._qkey)
        return handles

    def submit(self, request: Union[Request, np.ndarray, list], seed: Optional[int] = None,
               on_token: Optional[Callable[[StreamHandle, int], None]] = None
               ) -> StreamHandle:
        """Enqueue one request, validated now and admitted by a later
        step.  Thread-safe, also from an ``on_token`` callback; mid-trace
        the request joins the current trace.  A failed validation leaves
        the session untouched."""
        with self._cv:
            self._refuse_follower("submit")
            req = request if isinstance(request, Request) else Request(prompt=request)
            if req.rid is None:
                req = dataclasses.replace(req, rid=self._auto_rid())
            self._validate(req)
            self._check_queue_room(1)
            handle = self._enqueue(req, seed, on_token=on_token)
            self._note("submit", req, seed)
            self._cv.notify_all()       # wake the pump and blocked observers
            return handle

    def serve(self, requests: Sequence[Union[Request, np.ndarray, list]],
              seed: Optional[int] = None) -> List[RequestResult]:
        """Submit a whole arrival trace and drain it; results come back in
        submission order and the trace's ``ServeStats`` lands on
        ``last_stats``.  The whole batch is validated before any request
        is enqueued.  On a driven session this blocks until the batch's
        handles are done.  Default rids count up from 0, skipping live
        ones."""
        with self._cv:
            self._refuse_follower("serve")
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
            handles = self._enqueue_batch(reqs, seed)
            self._note("serve", reqs, seed)
            if not reqs:
                return []
            self._cv.notify_all()
            if self._driven_elsewhere():
                while not all(h.done for h in handles):
                    self._raise_pump_error()
                    if not self._driven_elsewhere():
                        break           # the pump stopped: finish here
                    self._cv.wait()
                if not all(h.done for h in handles):
                    self.drain()
            else:
                self.drain()
            return [h.result for h in handles]

    # ------------------------------ stepping ---------------------------------
    def drain(self) -> None:
        """Until the session is idle, step it (or, driven, wait on the
        pump), then deliver any deferred callbacks."""
        with self._cv:
            while True:
                self._raise_pump_error()
                if self._driven_elsewhere():
                    if self.idle and not self._events:
                        return
                    self._cv.wait()
                    continue
                if self.idle:
                    self._emit_events()
                    return
                self._step_locked()

    def step(self) -> int:
        """One scheduler tick: admit every queued request that fits
        (fairness-ordered, preempting lower classes under pressure),
        advance chunked prefills, then one decode step over the active
        slots.  Returns the tokens delivered this tick (admission
        first-tokens included); 0 on an idle session.  While a pump runs,
        any other thread gets a ``RuntimeError``."""
        with self._cv:
            if self._driven_elsewhere():
                raise RuntimeError(
                    "a background pump owns this session (start() was called): step() "
                    "from another thread would double-pump a tick; wait on handles / "
                    "stream() instead, or stop() the pump first")
            return self._step_locked()

    def _step_locked(self) -> int:
        """Step body; the caller holds ``_cv``.  ``no_grad`` and the
        numerics hook are entered here, on the stepping thread: both are
        per-thread or per-call state, and the pump is its own thread."""
        self._outbox = []               # sent by the pump, or made on every rank
        try:
            if self.idle:
                self._emit_events()      # callbacks a raising peer pre-empted
                return 0
            before = self.gen_tokens
            with torch.no_grad(), self.s._numerics():
                if self.s.paged:
                    self._admit_all_paged()
                    self._advance_chunks()
                else:
                    self._admit_legacy()
                if not self.active.any():
                    if self._chunk_slots:
                        self.step_idx += 1   # a chunk-only tick
                    elif self.queue and self.queue[0].request.arrival <= self.step_idx:
                        # Nothing runs or fills, so no live request holds
                        # pages: an eligible request that passed
                        # check_page_capacity must fit.
                        raise RuntimeError(
                            "admission stalled with an idle pool — page accounting bug: "
                            "no live request holds pages, yet an eligible request cannot "
                            "be admitted")
                    elif self.queue:
                        # Nothing running: jump to the next arrival.
                        self.step_idx = max(self.step_idx + 1, self.queue[0].request.arrival)
                    else:
                        self._finalize_trace()
                    # Count before the callbacks: one may submit() and begin
                    # a new trace, resetting the counters.
                    produced = self.gen_tokens - before
                    self._emit_events()
                    return produced
                self._decode_once()
            if self.idle:
                self._finalize_trace()
            produced = self.gen_tokens - before
            self._emit_events()
            return produced
        finally:
            self._cv.notify_all()

    def _decode_once(self) -> None:
        dev = self.s.device
        t0 = time.perf_counter()
        args = (torch.as_tensor(self.cur, device=dev), torch.as_tensor(self.pos, device=dev),
                torch.as_tensor(self.active, device=dev))
        rids = [self.occupant[i]["handle"].request.rid if a else -1
                for i, a in enumerate(self.active)]
        with moe.label_rows(rids, np.where(self.active, self.pos, -1)[:, None]):
            if self.s.paged:
                # Chunk-filling slots are inactive for decode but hold real
                # pages: their rows go to the garbage page, so the clamped
                # write at position 0 does not land in a page mid-fill.
                bt = self.btables
                if self._chunk_slots:
                    bt = np.where(self.active[:, None], bt, 0)
                self.pool, nxt = _decode_paged_fn(
                    self.s.params, self.pool, *args, torch.as_tensor(bt, device=dev),
                    self.keys, self.steps, self.temps, cfg=self.s.cfg)
            else:
                self.pool, nxt = _decode_fn(self.s.params, self.pool, *args, self.keys,
                                            self.steps, self.temps, cfg=self.s.cfg)
        nxt = nxt.cpu().numpy()
        self.decode_step_s.append(time.perf_counter() - t0)
        self.s._decoded = True
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
            priority=req.priority,
            tenant=req.tenant,
            preemptions=handle._preempt_count,
        )
        self._live_rids.discard(req.rid)
        if self.s.paged:
            self.ppool.release(st["pages"])
            # An inactive slot's clamped decode write must land in the
            # garbage page, never in a (possibly reallocated) page of the
            # retired occupant.
            self.btables[slot, :] = 0
        self.occupant[slot] = None
        self.active[slot] = False
        self.alloc.release(slot)

    def _seat(self, slot: int, handle: StreamHandle, tok0: int, admitted: int,
              pages: List[int], hit_tokens: int) -> None:
        """Post-prefill bookkeeping for both modes.  A handle with tokens
        already delivered is a preemption resume: its re-prefill covered
        ``prompt + generated[:-1]``, its sampled ``tok0`` is dropped (the
        original was delivered) and decode continues mid-stream."""
        req = handle.request
        k = handle.n_generated
        if handle._admitted is None:
            handle._admitted = admitted
            handle._hit_tokens0 = min(hit_tokens, req.prompt.size)
        self.occupant[slot] = {
            "handle": handle, "remaining": req.n_tokens - max(k, 1),
            "admitted": handle._admitted, "pages": pages,
            "prefix_hit_tokens": handle._hit_tokens0,
        }
        self.active[slot] = True
        self.keys[slot] = handle.key
        self.temps[slot] = req.temperature
        if k:
            # k tokens were sampled before eviction and the last one was
            # not decoded yet: pos = P + k - 1 restores the decode-entry
            # invariant pos = prompt_len + steps - 1.
            self.pos[slot] = req.prompt.size + k - 1
            self.cur[slot] = handle._tokens[-1]
            self.steps[slot] = k
            return
        self.pos[slot] = req.prompt.size
        self.cur[slot] = tok0
        self.steps[slot] = 1
        self._record_token(handle, tok0)
        if self.occupant[slot]["remaining"] == 0 or tok0 == self.s.eos_id:
            self._finish(slot)

    # ----------------------------- fairness ----------------------------------
    def _effective_prompt(self, handle: StreamHandle) -> np.ndarray:
        """What admission must prefill: the prompt, plus, for a preemption
        resume, every generated token but the last (whose K/V decode has
        not written yet)."""
        if not handle.n_generated:
            return handle.request.prompt
        return np.concatenate([handle.request.prompt,
                               np.asarray(handle._tokens[:-1], np.int32)])

    def _select_candidate(self, blocked: Set[int]) -> Optional[StreamHandle]:
        """Stride scheduling over priority classes: among classes with an
        eligible (arrival reached, not ``blocked``) queued request, pick
        the least virtual time, ties to the higher priority, and return
        that class's FIFO head."""
        best: Optional[StreamHandle] = None
        best_key: Optional[Tuple[float, int]] = None
        seen: Set[int] = set()
        for h in self.queue:                  # sorted by (arrival, seq)
            if h.request.arrival > self.step_idx:
                break
            p = h.request.priority
            if p in blocked or p in seen:
                continue
            seen.add(p)
            key = (max(self._vt.get(p, self._vt_floor), self._vt_floor), -p)
            if best_key is None or key < best_key:
                best, best_key = h, key
        return best

    def _charge(self, priority: int) -> None:
        """Advance a class's virtual time by its stride (1/priority) on
        admission; the floor follows the last admitted pass, so a newly
        active class starts level with the field."""
        vt = max(self._vt.get(priority, self._vt_floor), self._vt_floor)
        self._vt_floor = vt
        self._vt[priority] = vt + 1.0 / priority

    # ---------------------------- preemption ---------------------------------
    def _preempt_one(self, for_handle: StreamHandle) -> bool:
        """Evict one occupant of strictly lower priority than
        ``for_handle`` (lowest class first, least progress within it, the
        cheapest resume); False when there is none.  Fires only under
        sustained pressure: the candidate must have been blocked since an
        earlier step, so a backlogged higher class never evicts the
        admission the stride scheduler just seated."""
        if not self.s.preempt_active:
            return False
        if for_handle._blocked_at is None or for_handle._blocked_at >= self.step_idx:
            return False
        p = for_handle.request.priority
        victims = [s for s in range(self.s.max_slots)
                   if self.occupant[s] is not None
                   and self.occupant[s]["handle"].request.priority < p]
        if not victims:
            return False

        def cost(s: int):
            h = self.occupant[s]["handle"]
            return (h.request.priority, h.n_generated, -s)

        self._preempt_slot(min(victims, key=cost))
        return True

    def _preempt_slot(self, slot: int) -> None:
        """Evict ``slot``'s occupant: release its pages (registered prefix
        pages stay cached, for its resume to hit) and re-queue it,
        bypassing validation and shedding.  Delivered tokens stay
        delivered."""
        handle: StreamHandle = self.occupant[slot]["handle"]
        self.ppool.release(self.occupant[slot]["pages"])
        self.btables[slot, :] = 0
        self._chunk_slots.discard(slot)
        self.occupant[slot] = None
        self.active[slot] = False
        self.alloc.release(slot)
        handle._preempt_count += 1
        self.preemptions += 1
        self.total_preemptions += 1
        self._insert_sorted(handle)

    # ------------------------ monolithic admission ---------------------------
    def _admit_legacy(self) -> None:
        dev = self.s.device
        while self.alloc.free_count:
            handle = self._select_candidate(set())
            if handle is None:
                return
            self.queue.remove(handle)
            self._charge(handle.request.priority)
            req = handle.request
            slot = self.alloc.acquire()
            P = req.prompt.size
            bucket = self.s._bucket_for(P)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :P] = req.prompt
            t0 = time.perf_counter()
            self.pool, tok0 = _prefill_fn(
                self.s.params, self.pool, torch.as_tensor(padded, device=dev), P, slot,
                handle.key, req.temperature, cfg=self.s.cfg, max_len=self.s.max_len)
            tok0 = int(tok0.cpu()[0])
            self.prefill_s.append((1, bucket, time.perf_counter() - t0))
            self.s._programs.add(bucket)
            self.prefills += 1
            self.prefill_batches += 1
            self._seat(slot, handle, tok0, self.step_idx, [], 0)

    # ---------------------------- paged admission ----------------------------
    def _try_admit_paged(self, handle: StreamHandle, pending: Set[int]):
        """Reserve a slot and pages for ``handle``'s request.  Returns an
        admission dict, None (no slot, or not enough pages now), or
        "conflict" (its prefix pages are pending fill in the current
        burst: flush the burst first).  A chunked admission (tail longer
        than ``prefill_chunk``) reserves its slot and all its pages but
        defers the fill to ``_advance_chunks``; pending pages are no
        conflict for it, they are filled before its first chunk runs."""
        if not self.alloc.free_count:
            return None
        req = handle.request
        ppool = self.ppool
        prompt_eff = self._effective_prompt(handle)
        need = pages_needed(req.prompt.size, req.n_tokens, self.s.page_size)
        if self.s.prefix_reuse_active:
            matched, hashes = ppool.match_prefix(prompt_eff)
        else:
            matched, hashes = [], []
        ctx = len(matched) * self.s.page_size
        tail = prompt_eff[ctx:]
        chunked = self.s.chunk_active and tail.size > self.s.prefill_chunk
        if not chunked and pending.intersection(matched):
            return "conflict"
        ppool.ref(matched)          # pin before allocation can evict
        fresh_needed = need - len(matched)
        if fresh_needed > ppool.available():
            ppool.unref(matched)    # roll back the pin (and its stats)
            return None
        fresh = ppool.allocate(fresh_needed)
        pages = matched + fresh
        registered = len(matched)
        if self.s.prefix_reuse_active and not chunked and len(hashes) > len(matched):
            # The whole tail fills this step, so every covered page can be
            # indexed now.  Chunked admissions register as chunks fill
            # (_register_chunk_pages).
            ppool.register_prefix(hashes[len(matched):], pages[len(matched):len(hashes)],
                                  parent=hashes[len(matched) - 1] if matched else None)
            registered = len(hashes)
        slot = self.alloc.acquire()
        self.btables[slot, :need] = pages
        self.btables[slot, need:] = 0
        return {"handle": handle, "slot": slot, "pages": pages, "ctx_len": ctx,
                "tail": tail, "fresh": fresh, "chunked": chunked, "hashes": hashes,
                "registered": registered, "prompt_eff": prompt_eff}

    def _run_prefill(self, rows: List[tuple]) -> np.ndarray:
        """One paged prefill program over ``rows`` of (slot, handle,
        tokens, ctx_len), padded to a power-of-two width and the bucket
        of the longest; returns each row's sampled token."""
        S = self.s.max_slots
        Bg = len(rows)
        Bpad = 1 << (Bg - 1).bit_length()
        bucket = self.s._bucket_for(max(len(t) for _, _, t, _ in rows))
        tokens = np.zeros((Bpad, bucket), np.int32)
        bt = np.zeros((Bpad, self.s.pages_per_slot), np.int32)
        slots = np.full(Bpad, S, np.int32)      # the garbage slot for padding rows
        ctx = np.zeros(Bpad, np.int32)
        tv = np.zeros(Bpad, np.int32)
        temps = np.zeros(Bpad, np.float32)
        keys = np.zeros(Bpad, np.int64)
        for i, (slot, handle, toks, ctx_len) in enumerate(rows):
            tokens[i, :len(toks)] = toks
            bt[i] = self.btables[slot]
            slots[i] = slot
            ctx[i] = ctx_len
            tv[i] = len(toks)
            temps[i] = handle.request.temperature
            keys[i] = handle.key
        dev = self.s.device
        rids = [h.request.rid for _, h, _, _ in rows] + [-1] * (Bpad - Bg)
        cols = np.arange(bucket)
        t0 = time.perf_counter()
        with moe.label_rows(rids, np.where(cols < tv[:, None], ctx[:, None] + cols, -1)):
            self.pool, out = _burst_prefill_fn(
                self.s.params, self.pool, torch.as_tensor(tokens, device=dev),
                torch.as_tensor(bt, device=dev), torch.as_tensor(slots, device=dev),
                torch.as_tensor(ctx, device=dev), torch.as_tensor(tv, device=dev), keys, temps,
                cfg=self.s.cfg, page_size=self.s.page_size, use_context=self.s._use_context)
        out = out.cpu().numpy()
        self.prefill_s.append((Bpad, bucket, time.perf_counter() - t0))
        self.prefill_ctx.append(tuple(int(c) for c in ctx[:Bg]))
        self.s._programs.add((bucket, Bpad))
        self.prefill_batches += 1
        return out

    def _run_group(self, group: List[dict]) -> None:
        toks = self._run_prefill([(g["slot"], g["handle"], g["tail"], g["ctx_len"])
                                  for g in group])
        self.prefills += len(group)
        for i, g in enumerate(group):
            self._seat(g["slot"], g["handle"], int(toks[i]), self.step_idx, g["pages"],
                       g["ctx_len"])

    def _seat_chunking(self, adm: dict) -> None:
        """Seat a chunked admission: slot and pages are reserved, the slot
        stays decode-inactive while ``_advance_chunks`` fills its tail."""
        slot, handle = adm["slot"], adm["handle"]
        if handle._admitted is None:
            handle._admitted = self.step_idx
            handle._hit_tokens0 = min(adm["ctx_len"], handle.request.prompt.size)
        self.occupant[slot] = {
            "handle": handle, "remaining": None,   # set at activation
            "admitted": handle._admitted, "pages": adm["pages"],
            "prefix_hit_tokens": handle._hit_tokens0,
            "chunk": {"prompt_eff": adm["prompt_eff"], "filled": adm["ctx_len"],
                      "hashes": adm["hashes"], "registered": adm["registered"]},
        }
        self._chunk_slots.add(slot)

    def _register_chunk_pages(self, slot: int, ck: dict) -> None:
        """Index the prefix pages a chunk fill just completed, never ahead
        of the fill (a concurrent match on an unfilled page would attend
        garbage).  Hashes another request registered first are skipped by
        ``register_prefix``: this copy stays private."""
        if not self.s.prefix_reuse_active:
            return
        hashes, reg = ck["hashes"], ck["registered"]
        cover = min(ck["filled"] // self.s.page_size, len(hashes))
        if cover > reg:
            pages = self.occupant[slot]["pages"]
            self.ppool.register_prefix(hashes[reg:cover], pages[reg:cover],
                                       parent=hashes[reg - 1] if reg else None)
            ck["registered"] = cover

    def _advance_chunks(self) -> None:
        """One chunked-prefill advance: every chunking slot fills its next
        ``prefill_chunk`` tokens in one batched prefill program (the same
        (bucket, width) key space as burst prefill).  A slot whose tail
        completes activates for decode with its first token sampled from
        the final chunk's logits."""
        if not self._chunk_slots:
            return
        C = self.s.prefill_chunk
        plan = []
        for slot in sorted(self._chunk_slots):
            ck = self.occupant[slot]["chunk"]
            take = min(C, ck["prompt_eff"].size - ck["filled"])
            plan.append((slot, ck, take))
        toks = self._run_prefill([
            (slot, self.occupant[slot]["handle"],
             ck["prompt_eff"][ck["filled"]:ck["filled"] + take], ck["filled"])
            for slot, ck, take in plan])
        for i, (slot, ck, take) in enumerate(plan):
            ck["filled"] += take
            self.prefill_chunks += 1
            self.total_prefill_chunks += 1
            self._register_chunk_pages(slot, ck)
            if ck["filled"] == ck["prompt_eff"].size:
                self._chunk_slots.discard(slot)
                st = self.occupant[slot]
                self.prefills += 1
                # Activate for decode: _seat rebuilds the occupant (the slot
                # stays acquired); a resume keeps its delivered stream.
                self.occupant[slot] = None
                self._seat(slot, st["handle"], int(toks[i]), st["admitted"], st["pages"],
                           st["prefix_hit_tokens"])

    def _admit_round_paged(self) -> bool:
        """One admission round: build and run one burst group in fairness
        order.  A candidate that cannot be admitted blocks its class for
        the round; only the round's first candidate may preempt.  True
        when anything was admitted or a conflict flushed the group."""
        group: List[dict] = []
        chunk_seats: List[dict] = []
        pending: Set[int] = set()
        blocked: Set[int] = set()
        conflict = False
        head = True
        while True:
            handle = self._select_candidate(blocked)
            if handle is None:
                break
            adm = self._try_admit_paged(handle, pending)
            if adm is None and head:
                # The round's head under sustained pressure evicts one
                # victim at a time until it fits or no lower class remains.
                while adm is None and self._preempt_one(handle):
                    adm = self._try_admit_paged(handle, pending)
                if adm is None and handle._blocked_at is None:
                    handle._blocked_at = self.step_idx
            head = False
            if adm == "conflict":
                conflict = True     # flush the group; retry next round
                break
            if adm is None:
                blocked.add(handle.request.priority)
                continue
            self.queue.remove(handle)
            handle._blocked_at = None
            if handle._admitted is None:
                # A resume was charged at its first admission already.
                self._charge(handle.request.priority)
            if adm.pop("chunked"):
                chunk_seats.append(adm)
            else:
                group.append(adm)
                pending.update(adm["fresh"])
                if not self.s.burst_prefill:
                    break
        for adm in chunk_seats:
            self._seat_chunking(adm)
        if group:
            self._run_group(group)  # may finish slots: keep admitting
        return bool(group) or bool(chunk_seats) or conflict

    def _admit_all_paged(self) -> None:
        while self._admit_round_paged():
            pass


class Scheduler:
    """Continuous-batching server on the device of ``params``.  All
    serve-loop state lives in a persistent :class:`ServeSession`
    (``session()``), shared by every ``serve()`` / ``submit()`` /
    ``step()`` call.

    Multi-tenant options: ``max_queue`` sheds overload at submission
    (``ValueError``), ``preempt`` lets strictly higher-priority arrivals
    evict lower-class occupants, ``prefill_chunk`` caps the prompt tokens
    one tick may prefill per request.  Preemption and chunked prefill
    need prefix reuse's exactness conditions and are off otherwise.

    ``mesh`` (a ``DeviceMesh`` with a ``"model"`` axis, or ``{axis:
    size}`` for one rank) or ``tp`` (the initialized world laid out by
    ``launch.mesh.make_local_mesh(tp)``; ``tp=1`` with no process group
    is a one-rank mesh) serves exact tensor/expert parallelism: each
    rank passes the same full ``params`` and keeps its shards.

    The program shapes are bounded across every trace and session: one
    decode step plus, when paged, one prefill per (tail bucket,
    power-of-two width) actually used (chunk advances draw from the same
    keys), or, with ``paged=False``, one per prompt bucket.
    ``compile_counts()`` reports them as the reference reports its jit
    caches."""

    def __init__(self, cfg: LMConfig, params, max_slots: int = 4, max_len: int = 512,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, seed: int = 0, dcim_sim=None,
                 paged: bool = True, page_size: int = 16, n_pages: Optional[int] = None,
                 prefix_reuse: bool = True, burst_prefill: bool = True,
                 max_queue: Optional[int] = None, preempt: bool = True,
                 prefill_chunk: Optional[int] = None, mesh=None, tp: Optional[int] = None):
        if tp is not None:
            if mesh is not None:
                raise ValueError("pass either mesh= or tp=, not both")
            tp = int(tp)
            if tp < 1:
                raise ValueError(f"tp must be >= 1, got {tp}")
            world = dist.get_world_size() if dist.is_initialized() else 1
            if tp > world:
                raise ValueError(f"tp={tp} exceeds the process group's world of {world}")
            mesh = make_local_mesh(tp) if dist.is_initialized() else {"model": 1}
        self.mesh = mesh
        self.mesh_ctx = None if mesh is None else shd.serving_context(mesh)
        if self.mesh_ctx is not None:
            params = shd.shard_tree(params, shd.serve_param_sharding_tree(params, self.mesh_ctx),
                                    self.mesh_ctx)
        if max_slots < 1:
            raise ValueError(f"need at least one slot, got {max_slots}")
        self.cfg = cfg
        self.params = params
        # Params moved to the card by hand still get f32 accumulation.
        self.device = _device.resolve(params["ln_f"]["scale"].device)
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

        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.burst_prefill = bool(burst_prefill) and self.paged
        if self.paged:
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
        else:
            self.pages_per_slot = 0
            self.n_pages = 0
        # Prefix reuse must be token-exact against a full prefill:
        #  * an SSM layer carries recurrent state, which no page holds:
        #    a tail prefilled over reused pages would start from a zero
        #    state instead of the prefix's;
        #  * a lossy cache dtype would hand the tail prefill rounded
        #    context where the full prefill attends compute-dtype values.
        # A preemption resume and a chunk fill re-read pages the reference
        # computed in one pass, decode-written ones included: they share
        # the gate.
        period = cfg.scan_period()
        has_ssm = any(cfg.mixer_kind(i) == "mamba" for i in range(period))
        self._ctx_exact = not has_ssm and cfg.cache_dtype == cfg.compute_dtype
        self.prefix_reuse = bool(prefix_reuse) and self.paged
        self.prefix_reuse_active = self.prefix_reuse and self._ctx_exact
        self.max_queue = None if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.preempt_active = bool(preempt) and self.paged and self._ctx_exact
        self.prefill_chunk = None if prefill_chunk is None else int(prefill_chunk)
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.chunk_active = self.prefill_chunk is not None and self.paged and self._ctx_exact
        # The prefill's context gather runs only when some admission can
        # carry ctx_len > 0.
        self._use_context = self.prefix_reuse_active or self.chunk_active
        # The program shapes that have run: prefill keys, and whether the
        # decode step has (compile_counts).
        self._programs: Set[Union[int, Tuple[int, int]]] = set()
        self._decoded = False
        self.last_stats: Optional[ServeStats] = None
        self._session: Optional[ServeSession] = None

    def _numerics(self):
        """The context every program runs under (``ServeSession._step_locked``
        enters it): the numerics hook, and the serving mesh's context."""
        if self.mesh_ctx is None:
            return numerics_ctx(self.dcim_sim)
        stack = contextlib.ExitStack()
        stack.enter_context(numerics_ctx(self.dcim_sim))
        stack.enter_context(shd.use_mesh(self.mesh_ctx))
        return stack

    def _local_pool(self, make):
        """``make(device)``'s cache pool, or under a mesh this rank's
        shards of it, allocated at their local shapes."""
        return shd.local_pool(make, self.device, self.mesh_ctx)

    def _bucket_for(self, prompt_len: int) -> int:
        i = bisect.bisect_left(self.prefill_buckets, prompt_len)
        if i == len(self.prefill_buckets):   # unreachable: buckets end at max_len
            raise ValueError(f"prompt length {prompt_len} exceeds every bucket")
        return self.prefill_buckets[i]

    def compile_counts(self) -> Dict[str, int]:
        """The program shapes run so far, shared by every session and
        trace, in the reference's jit-cache form: ``decode`` 1 once a
        decode step ran, ``prefill`` {key: 1} per (tail bucket, width)
        when paged or per prompt bucket when not, and ``total``."""
        counts = {"decode": int(self._decoded),
                  "prefill": {k: 1 for k in sorted(self._programs)}}
        counts["total"] = counts["decode"] + len(counts["prefill"])
        return counts

    def session(self, fresh: bool = False) -> ServeSession:
        """The persistent :class:`ServeSession` (created on first use).
        ``fresh=True`` builds an independent session with its own pool
        and prefix cache."""
        if fresh:
            return ServeSession(self)
        if self._session is None:
            self._session = ServeSession(self)
        return self._session

    def submit(self, request, seed: Optional[int] = None, on_token=None) -> StreamHandle:
        """Submit one request to the persistent session."""
        return self.session().submit(request, seed=seed, on_token=on_token)

    def step(self) -> int:
        return self.session().step()

    def drain(self) -> None:
        self.session().drain()

    def serve(self, requests: Sequence[Union[Request, np.ndarray, list]],
              seed: Optional[int] = None) -> List[RequestResult]:
        """Serve an arrival trace to completion through the persistent
        session; results in submission order, stats on ``last_stats``."""
        return self.session().serve(requests, seed=seed)


# ------------------------------ lint contracts -------------------------------
from ..analysis.registry import Built, DonationUnit, Replay, register_contract  # noqa: E402

# The reference's 6-request mixed trace: (prompt length, tokens, arrival
# step, priority) per request.
_LINT_TRACE = ((3, 2, 0, 1), (5, 3, 0, 2), (9, 2, 0, 1), (3, 4, 1, 3), (17, 2, 2, 1),
               (6, 3, 2, 2))
_LINT_TRACE_TP = ((3, 2, 0, 1), (9, 3, 0, 2), (17, 2, 1, 1), (6, 3, 1, 2))


def _lint_scheduler(cfg, device, **kw) -> "Scheduler":
    """The lint contracts' Scheduler: the reference's smoke settings
    (3 slots, 32 positions in pages of 8, chunks of 8, a 64-request
    queue) on params drawn from seed 0."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return Scheduler(cfg, lm.init(cfg, gen, device), max_slots=3, max_len=32, page_size=8,
                     max_queue=64, prefill_chunk=8, **kw)


def _lint_replay(sched: "Scheduler", trace, tenants: bool) -> Replay:
    """Serve ``trace`` through ``sched``'s session while recording the
    call signature of every decode and prefill program the session
    runs (the module functions it calls), then read the live counts."""
    from ..analysis.op_trace import canonical_signature

    global _decode_paged_fn, _burst_prefill_fn
    signatures: List[Tuple[str, str]] = []
    real_decode, real_prefill = _decode_paged_fn, _burst_prefill_fn

    def spy_decode(*args, **kw):
        signatures.append(("decode", canonical_signature(args)))
        return real_decode(*args, **kw)

    def spy_prefill(*args, **kw):
        signatures.append(("prefill", canonical_signature(args)))
        return real_prefill(*args, **kw)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, 64, p).astype(np.int32), n_tokens=t, rid=i,
                    arrival=a, priority=pr, **({"tenant": f"t{pr}"} if tenants else {}))
            for i, (p, t, a, pr) in enumerate(trace)]
    _decode_paged_fn, _burst_prefill_fn = spy_decode, spy_prefill
    try:
        sched.session().serve(reqs)
    finally:
        _decode_paged_fn, _burst_prefill_fn = real_decode, real_prefill
    counts = sched.compile_counts()
    n_keys = len(sched._programs)
    return Replay(
        signatures=signatures,
        # one decode signature ever; prefill signatures may differ only
        # as much as the (bucket, width) program keys actually used
        max_programs={"decode": 1, "prefill": n_keys},
        live_counts={"decode": counts["decode"], "prefill": len(counts["prefill"])},
        live_budget={"decode": 1, "prefill": n_keys},
    )


def _lint_programs(sched: "Scheduler"):
    """Calls of the decode program and of the smallest prefill program
    the replay used, on the session's pool: every slot idle (their rows
    go to the garbage page and slot), as the reference lowers them."""
    session, dev, S = sched.session(), sched.device, sched.max_slots

    def decode():
        with torch.no_grad(), sched._numerics():
            session.pool, nxt = _decode_paged_fn(
                sched.params, session.pool, torch.as_tensor(session.cur, device=dev),
                torch.as_tensor(session.pos, device=dev),
                torch.as_tensor(session.active, device=dev),
                torch.as_tensor(np.zeros_like(session.btables), device=dev), session.keys,
                session.steps, session.temps, cfg=sched.cfg)
        return nxt

    bucket, width = min(k for k in sched._programs if isinstance(k, tuple))

    def prefill():
        z = np.zeros(width, np.int32)
        with torch.no_grad(), sched._numerics():
            session.pool, toks = _burst_prefill_fn(
                sched.params, session.pool, torch.zeros((width, bucket), dtype=torch.int32,
                                                        device=dev),
                torch.zeros((width, sched.pages_per_slot), dtype=torch.int32, device=dev),
                torch.full((width,), S, dtype=torch.int32, device=dev),
                torch.as_tensor(z, device=dev), torch.as_tensor(z, device=dev),
                np.zeros(width, np.int64), np.zeros(width, np.float32), cfg=sched.cfg,
                page_size=sched.page_size, use_context=sched._use_context)
        return toks

    return decode, prefill, f"prefill[{bucket},{width}]"


@register_contract(
    "serve.scheduler",
    checks=("donation", "transfers", "recompile", "precision"),
    description="paged continuous-batching serve loop at a smoke config with the "
                "multi-tenant features on (priorities, preemption, chunked prefill, bounded "
                "queue): the pool updated in place by the decode and prefill programs, the "
                "ServeSession.step() hot path with no implicit transfer and at most one "
                "host read of tokens a program, a replayed mixed trace within one decode "
                "signature and one prefill signature per (bucket, width) key, and the "
                "recorded decode/prefill programs satisfying the precision policy — "
                "including the exactness gates re-derived from the pool leaves they read",
)
def _build_serve_contract(device) -> Built:
    from ..analysis.op_trace import pool_leaf_specs, record
    from ..analysis.registry import ExactnessGate, PrecisionPolicy
    from ..configs import get_smoke_config

    # Lossless cache (cache_dtype == compute_dtype): the exactness gates
    # — prefix reuse, preemption-resume, chunked prefill — are ON, and
    # the precision check re-derives that from the recorded pool reads.
    cfg = get_smoke_config("qwen2.5-3b")
    cfg = dataclasses.replace(cfg, cache_dtype=cfg.compute_dtype)
    sched = _lint_scheduler(cfg, device)
    replay = _lint_replay(sched, _LINT_TRACE, tenants=True)
    session = sched.session()
    decode, prefill, prefill_label = _lint_programs(sched)
    rng = np.random.default_rng(1)
    steps = {"n": 0}

    def hot():
        """One request submitted and drained through ``step()``."""
        steps["n"] = 0
        handle = session.submit(Request(prompt=rng.integers(1, 64, 7).astype(np.int32),
                                        n_tokens=3, rid=9001, priority=2))
        while not session.idle:
            session.step()
            steps["n"] += 1
        return handle.result

    pool = lambda: session.pool  # noqa: E731
    pool_leaves = pool_leaf_specs(session.pool)
    return Built(
        donation=[DonationUnit("decode", decode, pool),
                  DonationUnit(prefill_label, prefill, pool)],
        hot=hot, hot_label="ServeSession.step()", hot_calls=lambda: steps["n"],
        # a tick reads its tokens on the host once a program it runs: one
        # decode and, for an admission or a chunk, one prefill
        sync_budget=2,
        replay=replay,
        programs=[("decode", record(decode)), ("prefill", record(prefill))],
        precision=PrecisionPolicy(compute_dtype=cfg.compute_dtype, gates=[
            ExactnessGate("prefix_reuse", sched.prefix_reuse_active, "decode", pool_leaves),
            ExactnessGate("preempt", sched.preempt_active, "decode", pool_leaves),
            ExactnessGate("chunked_prefill", sched.chunk_active, "prefill", pool_leaves),
        ]),
    )


@register_contract(
    "serve.scheduler_tp",
    checks=("donation", "recompile", "collectives", "precision"),
    description="tensor-parallel paged serve loop at tp = the group's size (a gloo group "
                "of 2) at a smoke config: each rank's pool shards updated in place, a "
                "replayed trace within the single-device program budget (sharding adds no "
                "program), a decode and a prefill moving data only — all-gathers of at "
                "most 1 MiB a call a rank, all-to-all forbidden (exact serving has no "
                "partial sums to reshuffle) — and the gates re-derived as OFF from the "
                "stock lossy bf16 pool",
    ranks=2,
)
def _build_serve_tp_contract(device) -> Built:
    from ..analysis.contracts import bound_groups, counter_calls, require_group
    from ..analysis.op_trace import pool_leaf_specs, record
    from ..analysis.registry import CollectiveUnit, ExactnessGate, PrecisionPolicy
    from ..configs import get_smoke_config

    world = require_group(2)
    cfg = get_smoke_config("qwen2.5-3b")
    sched = _lint_scheduler(cfg, device, tp=world)
    bound_groups(sched.mesh_ctx)
    replay = _lint_replay(sched, _LINT_TRACE_TP, tenants=False)
    decode, prefill, prefill_label = _lint_programs(sched)
    counter: dict = {}
    sched.mesh_ctx.counter = counter
    units = []
    # Per-rank all-gather budget: the biggest gather of one decode step
    # is the logits', vocab x slots x 4 bytes; everything else (heads,
    # ff) is smaller at this config.  All-to-all at 0 is the real teeth.
    budget = {"all-gather": 1 << 20, "all-to-all": 0}
    for label, fn in (("decode_tp", decode), (f"{prefill_label}_tp", prefill)):
        counter.clear()
        fn()
        units.append(CollectiveUnit(label, counter_calls(counter), budget))
    programs = [("decode_tp", record(decode))]
    sched.mesh_ctx.counter = None
    session = sched.session()
    # The stock smoke config keeps a lossy bf16 cache under f32 compute,
    # so the exactness gates must come out DISABLED.
    return Built(
        donation=[DonationUnit("decode_tp", decode, lambda: session.pool),
                  DonationUnit(prefill_label + "_tp", prefill, lambda: session.pool)],
        replay=replay, collectives=units, programs=programs,
        precision=PrecisionPolicy(compute_dtype=cfg.compute_dtype, gates=[
            ExactnessGate("prefix_reuse", sched.prefix_reuse_active, "decode_tp",
                          pool_leaf_specs(session.pool)),
        ]),
    )
