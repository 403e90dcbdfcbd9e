"""Host-side accounting for the paged KV-cache pool: page allocation,
refcounts, and the shared-prefix hash index.  Plain numpy, carried over
whole from ``src/repro/serve/paging.py``.

The device side (``repro_torch.models.lm.init_paged_pool`` and friends) is a
dumb array of pages; every policy decision lives here, on the host:

* **allocation** — pages are a fixed pool of ids ``1 .. n_pages-1``
  (page 0 is the reserved garbage page that absorbs masked writes).
  Allocation prefers never-used/plain-freed pages and falls back to
  evicting least-recently-used *cached* prefix pages.
* **refcounts** — a page's refcount is the number of live requests whose
  block table names it.  Shared prefix pages are refcounted up on every
  hit; retirement decrements.  A prefix page whose refcount drops to 0
  is not freed — it moves to the CACHED state (content intact, still in
  the hash index) so a later request with the same prefix can still hit
  it; it is only reclaimed when allocation pressure evicts it.
* **prefix index** — prompts are hashed at page granularity with a
  rolling chain (``h_i = sha1(h_{i-1} || tokens[i*page : (i+1)*page])``)
  so a chain hash identifies the ENTIRE prefix up to that page, not just
  the page's own tokens.  ``match_prefix`` walks the chain and returns
  the longest resident run of pages.  Only pages fully covered by the
  prompt are ever indexed — a page decode will write into must stay
  private.  The match is additionally capped one token short of the full
  prompt so every admitted request prefills at least its last token
  (the logits source for its first sampled token).
* **chain cleanup** — the index remembers each hash's parent/children;
  evicting a page drops its (chain-unreachable) descendants too: cached
  orphans go straight back to the free list, live orphans lose their
  index entry and free like private pages at retirement.  Without this,
  a ``ServeSession``'s pool — which persists across traces — would
  slowly fill its LRU with unreachable pages.
* **trace accounting** — a persistent session calls ``begin_trace()``
  at each trace boundary; a prefix hit on a page filled by an EARLIER
  trace counts as a *cross-trace* hit (``PageStats.cross_trace_hits``),
  the warm-session signal surfaced through ``ServeStats``.

``check_page_capacity`` is the page-pool half of the admission contract:
like :func:`repro_torch.serve.engine.check_capacity` it raises ``ValueError``
(a real error, not an assert) for requests that could never be served
even by an empty pool.  Transient exhaustion — enough total pages, but
other requests hold them — is not an error: the scheduler keeps the
request queued until retirements free pages.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

GARBAGE_PAGE = 0


def pages_needed(prompt_len: int, n_tokens: int, page_size: int) -> int:
    """Pages a request can touch over its whole life: prompt positions
    [0, P) plus decode writes at [P, P + n_tokens - 1) (the last sampled
    token is returned but never written back)."""
    return -(-(prompt_len + max(n_tokens, 1) - 1) // page_size)


def check_page_capacity(prompt_len: int, n_tokens: int, page_size: int,
                        usable_pages: int) -> None:
    """Admission control for the paged pool: reject requests that exceed
    the pool outright (mirrors ``serve.check_capacity``'s ValueError
    contract — transient exhaustion is handled by queueing instead)."""
    need = pages_needed(prompt_len, n_tokens, page_size)
    if need > usable_pages:
        raise ValueError(
            f"request exceeds page-pool capacity: prompt length "
            f"{prompt_len} + n_tokens {n_tokens} needs {need} pages of "
            f"{page_size} tokens > {usable_pages} usable pages; shorten "
            f"the prompt, request fewer tokens, or build the Scheduler "
            f"with more pages"
        )


def prefix_page_hashes(prompt: np.ndarray, page_size: int) -> List[str]:
    """Chain hashes for every page FULLY covered by the prompt.  Entry i
    identifies tokens [0, (i+1)*page_size) — the whole prefix, so equal
    hashes imply equal prefixes (up to SHA-1 collisions)."""
    prompt = np.asarray(prompt, np.int32)
    out: List[str] = []
    h = hashlib.sha1(b"kv-prefix")
    for i in range(prompt.size // page_size):
        h = h.copy()
        h.update(prompt[i * page_size:(i + 1) * page_size].tobytes())
        out.append(h.hexdigest())
    return out


@dataclasses.dataclass
class PageStats:
    """Counters exposed through ``Scheduler.last_stats``.

    ``prefix_hits`` counts every page served from the index;
    ``cross_trace_hits`` is the subset whose page was *filled by an
    earlier trace* of the same session (see ``PagePool.begin_trace``) —
    the warm-session signal a persistent ``ServeSession`` exists to
    produce.  Counters are cumulative over the pool's lifetime; per-trace
    views are diffs of two snapshots (``PageStats.delta``)."""
    n_pages: int = 0                  # usable pages (garbage excluded)
    page_size: int = 0
    prefix_hits: int = 0              # pages reused via the prefix index
    prefix_misses: int = 0            # full prompt pages that had to be filled
    prefix_hit_tokens: int = 0        # prompt tokens whose prefill was skipped
    cross_trace_hits: int = 0         # hits on pages filled by an earlier trace
    cross_trace_hit_tokens: int = 0   # their token count
    evictions: int = 0                # cached prefix pages reclaimed
    orphaned_live: int = 0            # live pages unindexed by a parent eviction
    peak_pages_in_use: int = 0        # max live (refcount > 0) pages
    cached_pages: int = 0             # refcount-0 pages still in the index

    # Gauges keep their current value in a per-trace delta; everything
    # else is a monotonic counter and diffs.
    _GAUGES = ("n_pages", "page_size", "peak_pages_in_use", "cached_pages")

    def as_dict(self) -> dict:
        """Lifetime counters as a plain dict.  ``Scheduler.last_stats``
        carries per-trace :meth:`delta` views, not this."""
        return dataclasses.asdict(self)

    def delta(self, since: "PageStats") -> dict:
        """Per-trace view: counters since the ``since`` snapshot, gauges
        at their current value."""
        out = {}
        for f in dataclasses.fields(self):
            cur = getattr(self, f.name)
            out[f.name] = (
                cur if f.name in self._GAUGES else cur - getattr(since, f.name)
            )
        return out

    def snapshot(self) -> "PageStats":
        return dataclasses.replace(self)


class PagePool:
    """Host-side page allocator + refcounts + shared-prefix index.

    Pages move between three states: FREE (unallocated, content
    meaningless), LIVE (refcount > 0, named by at least one block
    table), and CACHED (refcount 0 but content is an indexed prompt
    prefix — reusable until evicted, LRU order)."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (one is garbage), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.n_pages = n_pages
        self.usable_pages = n_pages - 1           # page 0 is garbage
        self._free: List[int] = list(range(n_pages - 1, 0, -1))  # pop() -> 1 first
        self._ref = np.zeros(n_pages, np.int32)
        # chain hash -> page id, for pages whose content is an indexed
        # prompt prefix (LIVE or CACHED).
        self._index: Dict[str, int] = {}
        self._page_hash: Dict[int, str] = {}      # inverse of _index
        # Chain structure of the index: hash -> parent hash / child
        # hashes, so evicting a parent can free its (now unreachable)
        # descendants' accounting instead of letting them squat in the
        # LRU (see _orphan_descendants).
        self._parent: Dict[str, Optional[str]] = {}
        self._children: Dict[str, List[str]] = {}
        # CACHED pages in LRU order (oldest first).
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # Trace accounting for persistent sessions: begin_trace() bumps
        # the id; a hit on a page filled under an older id is a
        # cross-trace hit.  A pool that never sees begin_trace() stays
        # in trace 0 and counts everything as intra-trace.
        self.trace_id = 0
        self._page_trace: Dict[int, int] = {}
        self.stats = PageStats(n_pages=self.usable_pages, page_size=page_size)

    def begin_trace(self) -> None:
        """Mark a trace boundary: pages indexed before this call count
        as cross-trace when hit afterwards."""
        self.trace_id += 1

    # ------------------------------ queries ---------------------------------
    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    @property
    def live_pages(self) -> int:
        return int((self._ref[1:] > 0).sum())

    def available(self) -> int:
        """Pages allocatable right now: free + evictable cached."""
        return len(self._free) + len(self._lru)

    def check_conservation(self) -> None:
        """Page-conservation invariant: every usable page is exactly one
        of FREE, CACHED (zero-ref, indexed, evictable) or LIVE — i.e.
        ``available() + live_pages == usable_pages`` — and no cached
        page carries a reference.  Raises ``RuntimeError`` on violation.
        Cheap enough for tests to call after every operation; the
        scheduler's preemption path (release + later re-allocate of the
        same prefix) must preserve it at every step."""
        free, cached, live = len(self._free), len(self._lru), self.live_pages
        if free + cached + live != self.usable_pages:
            raise RuntimeError(
                f"page accounting violated: {free} free + {cached} cached "
                f"+ {live} live != {self.usable_pages} usable"
            )
        for page in self._lru:
            if self._ref[page] != 0:
                raise RuntimeError(
                    f"cached page {page} holds refcount {int(self._ref[page])}"
                )

    def match_prefix(self, prompt: np.ndarray) -> Tuple[List[int], List[str]]:
        """Longest resident prefix run for ``prompt``.

        Returns ``(pages, hashes)`` where ``hashes`` covers every fully
        prompt-covered page (capped one token short of the prompt so the
        tail prefill is never empty) and ``pages[:k]`` are the resident
        pages for the first ``k`` hashes.  The walk stops at the first
        miss: a resident child behind an evicted parent is unreachable
        by construction (chain hashing)."""
        prompt = np.asarray(prompt, np.int32)
        # Cap: at least the last prompt token must be prefilled.
        max_pages = (prompt.size - 1) // self.page_size
        hashes = prefix_page_hashes(prompt, self.page_size)[:max_pages]
        pages: List[int] = []
        for h in hashes:
            page = self._index.get(h)
            if page is None:
                break
            pages.append(page)
        return pages, hashes

    # ----------------------------- transitions ------------------------------
    def _unlink_from_parent(self, h: str) -> None:
        par = self._parent.pop(h, None)
        if par is not None:
            sibs = self._children.get(par)
            if sibs is not None:
                if h in sibs:
                    sibs.remove(h)
                if not sibs:
                    del self._children[par]

    def _orphan_descendants(self, h: str) -> None:
        """Chain hashing makes every descendant of an evicted hash
        unreachable by ``match_prefix`` (the walk stops at the first
        miss), so keeping them indexed only leaks accounting: a CACHED
        orphan squats in the LRU competing with reachable pages, and a
        LIVE orphan would re-enter the LRU at release and squat forever.
        Free them instead: cached orphans go straight back to the free
        list (counted as evictions — they are reclaimed cache), live
        orphans just lose their index entry and free like private pages
        when their tenant retires.  Iterative (a worklist, not
        recursion): a long prompt's chain can be thousands of pages
        deep."""
        work = list(self._children.pop(h, []))
        while work:
            c = work.pop()
            work.extend(self._children.pop(c, []))
            page = self._index.pop(c, None)
            if page is None:                    # already dropped
                continue
            self._page_hash.pop(page, None)
            self._parent.pop(c, None)
            self._page_trace.pop(page, None)
            if self._ref[page] == 0:
                self._lru.pop(page, None)
                self._free.append(page)
                self.stats.evictions += 1
            else:
                self.stats.orphaned_live += 1

    def _evict_one(self) -> int:
        page, _ = self._lru.popitem(last=False)       # oldest cached page
        h = self._page_hash.pop(page)
        del self._index[h]
        self._unlink_from_parent(h)
        self._page_trace.pop(page, None)
        self.stats.evictions += 1
        self._orphan_descendants(h)
        return page

    def allocate(self, n: int) -> List[int]:
        """Allocate ``n`` fresh private pages (refcount 1 each), evicting
        LRU cached prefix pages under pressure.  Raises RuntimeError on
        true exhaustion — the scheduler checks ``available()`` first, so
        hitting this is a bug, not an admission-control path."""
        if n > self.available():
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {self.available()}"
            )
        out = []
        for _ in range(n):
            page = self._free.pop() if self._free else self._evict_one()
            self._ref[page] = 1
            out.append(page)
        self._track_peak()
        return out

    def _cross_trace_count(self, pages: List[int]) -> int:
        return sum(
            1 for p in pages
            if self._page_trace.get(p, self.trace_id) < self.trace_id
        )

    def ref(self, pages: List[int]) -> None:
        """Take a reference on resident prefix pages (a hit).  CACHED
        pages return to LIVE.  Hits on pages filled by an earlier trace
        (older ``trace_id``) also count as cross-trace hits."""
        for page in pages:
            if self._ref[page] == 0:
                self._lru.pop(page, None)
            self._ref[page] += 1
        cross = self._cross_trace_count(pages)
        self.stats.prefix_hits += len(pages)
        self.stats.prefix_hit_tokens += len(pages) * self.page_size
        self.stats.cross_trace_hits += cross
        self.stats.cross_trace_hit_tokens += cross * self.page_size
        self._track_peak()

    def unref(self, pages: List[int]) -> None:
        """Roll back a :meth:`ref` that did not lead to an admission
        (e.g. the page pool could not cover the request's fresh pages).
        Reverses both the refcounts and the hit counters the ref charged
        (cross-trace ones included — page fill-trace ids cannot change
        between a ref and its rollback); ``peak_pages_in_use`` stays a
        true high-water mark, transient pins included."""
        self.release(pages)
        cross = self._cross_trace_count(pages)
        self.stats.prefix_hits -= len(pages)
        self.stats.prefix_hit_tokens -= len(pages) * self.page_size
        self.stats.cross_trace_hits -= cross
        self.stats.cross_trace_hit_tokens -= cross * self.page_size

    def register_prefix(self, hashes: List[str], pages: List[int],
                        parent: Optional[str] = None) -> None:
        """Index freshly-allocated pages as prefix pages (content is
        filled by the admission's prefill program before any later
        admission can look them up).  ``hashes`` is a contiguous chain
        run: entry ``i+1`` is a child of entry ``i``; ``parent`` is the
        chain hash preceding ``hashes[0]`` (``None`` for a chain root) —
        the linkage eviction uses to free orphaned descendants."""
        for i, (h, page) in enumerate(zip(hashes, pages)):
            old = self._index.get(h)
            if old is not None:
                # Either a re-registration of the same pair (no-op) or
                # the same prefix filled twice concurrently (burst
                # split): keep the existing entry — the new page stays a
                # private unindexed page — and keep the existing chain
                # links either way.
                continue
            self._index[h] = page
            self._page_hash[page] = h
            self._page_trace[page] = self.trace_id
            par = hashes[i - 1] if i > 0 else parent
            self._parent[h] = par
            if par is not None:
                self._children.setdefault(par, []).append(h)
        self.stats.prefix_misses += len(hashes)

    def release(self, pages: List[int]) -> None:
        """Drop one reference per page.  Zero-ref indexed pages become
        CACHED (evictable, still hittable); zero-ref private pages go
        straight back to the free list.  CACHED-not-freed is what makes
        scheduler preemption cheap: an evicted request's registered
        prefix pages stay hittable, so its resume re-prefills only the
        unregistered tail unless allocation pressure evicted them."""
        for page in pages:
            if self._ref[page] < 1:
                raise ValueError(f"page {page} is not live")
            self._ref[page] -= 1
            if self._ref[page] == 0:
                if page in self._page_hash:
                    self._lru[page] = None
                    self._lru.move_to_end(page)
                else:
                    self._free.append(page)
        self.stats.cached_pages = len(self._lru)

    def _track_peak(self) -> None:
        self.stats.peak_pages_in_use = max(
            self.stats.peak_pages_in_use, self.live_pages
        )
        self.stats.cached_pages = len(self._lru)
