"""The port's persistent serving sessions against the JAX reference, on
the CPU: warm and fresh sessions (cross-trace prefix hits, the program
budget kept between traces), the monolithic ``paged=False`` session,
streaming delivery (``on_token``, ``stream()``), the session's lifecycle
edges (empty steps and serves, raising callbacks, follow-up submissions
from a callback, interleaved submissions, reuse after a ``ValueError``)
and request-id collisions.

Each case runs the same calls through ``repro.serve`` and
``repro_torch.serve`` (smoke qwen2.5-3b, float32 cache, the reference's
params) and requires equal greedy tokens, ``RequestResult`` fields,
``ServeStats`` counters and ``compile_counts()``, with the port's tokens
held to its ``Engine`` by ``test_torch_serve_tenants``'s margin rule.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")

from test_torch_serve_tenants import _assert_margins, _both, _model, _prompt, _served


@pytest.fixture(scope="module")
def model():
    return _model()


def _shared_prefix_trace(pkg, rng, system, tails, n_tokens=4, rid0=0):
    return [pkg.Request(prompt=np.concatenate([system, _prompt(rng, t)]), n_tokens=n_tokens,
                        rid=rid0 + i) for i, t in enumerate(tails)]


# --- warm and fresh sessions -----------------------------------------------------------
def test_warm_session_hits_across_traces(model):
    """A second serve() finds the first trace's system-prompt pages cached
    (every request of trace 2 a cross-trace hit) with no new program."""
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=4, max_len=64, page_size=8)
        rng = np.random.default_rng(0)
        system = _prompt(rng, 24)
        r1 = _served(sched, sched.serve(_shared_prefix_trace(pkg, rng, system,
                                                             [2, 3, 5, 2, 4, 3])))
        r2 = _served(sched, sched.serve(_shared_prefix_trace(pkg, rng, system,
                                                             [4, 2, 3, 5, 2, 4], rid0=100)))
        return {"first": r1, "second": r2, "same_session": sched.session() is sched.session()}

    out = _both(model, scenario)
    s1, s2 = out["first"]["stats"], out["second"]["stats"]
    assert (s1.trace_index, s2.trace_index) == (0, 1)
    assert s1.paging["prefix_hits"] > 0 and s1.paging["cross_trace_hits"] == 0
    assert s2.paging["prefix_misses"] == 0 and s2.paging["cross_trace_hits"] == 6 * 3
    assert all(r.prefix_hit_tokens == 24 for r in out["second"]["results"])
    assert out["first"]["counts"] == out["second"]["counts"]
    assert s1.pool_bytes == s2.pool_bytes > 0 and out["same_session"]
    _assert_margins(model, out["first"]["results"] + out["second"]["results"], 64)


def test_fresh_session_is_cold_but_shares_programs(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=64, page_size=8)
        rng = np.random.default_rng(1)
        system = _prompt(rng, 16)
        sched.serve(_shared_prefix_trace(pkg, rng, system, [2, 3]))
        before = sched.compile_counts()
        fresh = sched.session(fresh=True)
        assert isinstance(fresh, pkg.ServeSession) and fresh is not sched.session()
        res = fresh.serve(_shared_prefix_trace(pkg, rng, system, [2, 3], rid0=50))
        return {"results": res, "stats": fresh.last_stats, "before": before,
                "after": sched.compile_counts()}

    out = _both(model, scenario)
    assert out["stats"].paging["cross_trace_hits"] == 0
    assert out["stats"].paging["prefix_misses"] > 0
    assert out["before"] == out["after"]


def test_unpaged_session_persists_across_traces(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=64, paged=False)
        rng = np.random.default_rng(2)
        reqs = [pkg.Request(prompt=_prompt(rng, p), n_tokens=3, rid=i)
                for i, p in enumerate([4, 9, 6])]
        return {"first": _served(sched, sched.serve(reqs)),
                "second": _served(sched, sched.serve(reqs))}

    out = _both(model, scenario)
    st = out["second"]["stats"]
    assert st.trace_index == 1 and st.paging is None
    assert out["first"]["counts"] == out["second"]["counts"]
    for a, b in zip(out["first"]["results"], out["second"]["results"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    _assert_margins(model, out["first"]["results"], 64)


# --- streaming ---------------------------------------------------------------------------
def test_tokens_observable_as_produced(model):
    """on_token sees every token in order while the request is still
    generating, stream() yields exactly the generated tokens and never
    runs ahead of production."""
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=64, page_size=8)
        rng = np.random.default_rng(3)
        seen = []
        ha = sched.submit(pkg.Request(prompt=_prompt(rng, 9), n_tokens=6, rid=1),
                          on_token=lambda h, t: seen.append((h.n_generated, t)))
        hb = sched.submit(pkg.Request(prompt=_prompt(rng, 5), n_tokens=3, rid=2))
        assert not ha.done and ha.n_generated == 0
        streamed, progress = [], []
        for tok in ha.stream():
            streamed.append(tok)
            progress.append(ha.n_generated)
        sched.drain()
        return {**_served(sched, [ha.result, hb.result]), "seen": seen,
                "streamed": streamed, "progress": progress}

    out = _both(model, scenario)
    ns = [n for n, _ in out["seen"]]
    assert len(ns) == 6 and ns == sorted(ns) and ns[0] < 6
    assert [t for _, t in out["seen"]] == out["streamed"]
    assert out["progress"][0] >= 1 and out["progress"][-1] == 6
    assert out["stats"].generated_tokens == 9
    _assert_margins(model, out["results"], 64)


def test_eos_retires_streaming_handle(model):
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(4)
        prompt = _prompt(rng, 6)
        free = pkg.Scheduler(cfg, params, max_slots=1, max_len=64).serve(
            [pkg.Request(prompt=prompt, n_tokens=8)])[0]
        eos = int(free.generated[2])
        sched = pkg.Scheduler(cfg, params, max_slots=1, max_len=64, eos_id=eos)
        ha = sched.submit(pkg.Request(prompt=prompt, n_tokens=8, rid=0))
        hb = sched.submit(pkg.Request(prompt=prompt[:3], n_tokens=2, rid=1))
        got = list(ha.stream())
        sched.drain()
        return {**_served(sched, [ha.result, hb.result]), "free": free, "got": got, "eos": eos}

    out = _both(model, scenario)
    k = int(np.flatnonzero(out["free"].generated == out["eos"])[0])
    assert out["got"] == list(out["free"].generated[:k + 1])
    assert out["results"][1].admitted_step == out["results"][0].finished_step


def test_callbacks_interleave_across_requests(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=64, page_size=8)
        rng = np.random.default_rng(5)
        order = []
        for rid in (0, 1):
            sched.submit(pkg.Request(prompt=_prompt(rng, 4 + rid), n_tokens=4, rid=rid),
                         on_token=lambda h, t: order.append((h.rid, t)))
        sched.drain()
        return {"order": order, "stats": sched.last_stats}

    out = _both(model, scenario)
    rids = [r for r, _ in out["order"]]
    assert sorted(rids) == [0] * 4 + [1] * 4 and rids[2:] == [0, 1] * 3


# --- the session's lifecycle ------------------------------------------------------------------
def test_empty_session_step_is_noop(model):
    def scenario(pkg, cfg, params):
        sess = pkg.Scheduler(cfg, params, max_slots=2, max_len=64).session()
        assert sess.idle and sess.step() == 0 and sess.step() == 0
        assert sess.last_stats is None
        res = sess.serve([pkg.Request(prompt=_prompt(np.random.default_rng(6), 5), n_tokens=2)])
        return {"results": res, "stats": sess.last_stats}

    out = _both(model, scenario)
    assert out["results"][0].tokens.size == 7


def test_empty_serve_lands_fresh_zero_stats(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=64)
        sched.serve([pkg.Request(prompt=_prompt(np.random.default_rng(15), 5), n_tokens=3)])
        busy = sched.last_stats
        assert sched.serve([]) == []
        assert sched.last_stats is not busy
        return {"busy": busy, "empty": sched.last_stats}

    out = _both(model, scenario)
    assert out["busy"].generated_tokens == 3
    assert out["empty"].generated_tokens == 0 and out["empty"].steps == 0
    assert out["empty"].trace_index == out["busy"].trace_index + 1


def test_raising_callback_leaves_session_consistent(model):
    """A raising on_token interrupts drain() after the step's bookkeeping:
    the resumed session gives the undisturbed tokens and delivers every
    pre-empted callback."""
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(16)
        pa, pb = _prompt(rng, 6), _prompt(rng, 4)
        mk = lambda: [pkg.Request(prompt=pa, n_tokens=5, rid=0),  # noqa: E731
                      pkg.Request(prompt=pb, n_tokens=5, rid=1)]
        clean = pkg.Scheduler(cfg, params, max_slots=2, max_len=64, page_size=8).serve(mk())
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=64, page_size=8)
        sess = sched.session()
        seen = []

        def boom(h, t):
            seen.append((h.rid, t))
            if len(seen) == 3:
                raise RuntimeError("user callback exploded")

        handles = [sess.submit(r, on_token=boom) for r in mk()]
        with pytest.raises(RuntimeError, match="exploded"):
            sess.drain()
        sess.drain()
        return {"clean": clean, **_served(sched, [h.result for h in handles]), "seen": seen}

    out = _both(model, scenario)
    for c, r in zip(out["clean"], out["results"]):
        np.testing.assert_array_equal(c.tokens, r.tokens)
        assert [t for rid, t in out["seen"] if rid == r.rid] == list(r.generated)


def test_empty_serve_mid_trace_does_not_finalize(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=64, page_size=8)
        sess = sched.session()
        h = sess.submit(pkg.Request(prompt=_prompt(np.random.default_rng(17), 6), n_tokens=6))
        sess.step()
        mid = sess.step_idx
        assert sched.serve([]) == []
        assert sess.last_stats is None and not sess.idle and sess.step_idx == mid
        sess.drain()
        return {"results": [h.result], "stats": sess.last_stats}

    out = _both(model, scenario)
    assert out["stats"].trace_index == 0 and out["stats"].generated_tokens == 6


def test_callback_submitting_follow_up(model):
    """A callback that submits a follow-up when its handle retires starts
    a new trace from inside the step; step() still counts sanely."""
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=64, page_size=8)
        sess = sched.session()
        rng = np.random.default_rng(18)
        p2 = _prompt(rng, 4)
        chained = []

        def chain(h, t):
            if h.done and not chained:
                chained.append(sess.submit(pkg.Request(prompt=p2, n_tokens=2, rid=50)))

        first = sess.submit(pkg.Request(prompt=_prompt(rng, 6), n_tokens=3, rid=0),
                            on_token=chain)
        returns = []
        while not sess.idle:
            returns.append(sess.step())
        return {"returns": returns, "results": [first.result, chained[0].result],
                "stats": sess.last_stats}

    out = _both(model, scenario)
    assert all(r >= 0 for r in out["returns"]) and sum(out["returns"]) == 3 + 2
    assert out["stats"].trace_index == 1


def test_interleaved_submit_joins_the_active_trace(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=64, page_size=8)
        rng = np.random.default_rng(7)
        sess = sched.session()
        ha = sess.submit(pkg.Request(prompt=_prompt(rng, 7), n_tokens=8, rid=0))
        for _ in range(3):
            sess.step()
        mid = sess.step_idx
        hb = sess.submit(pkg.Request(prompt=_prompt(rng, 4), n_tokens=2, rid=1))
        sess.drain()
        return {**_served(sched, [ha.result, hb.result]), "mid": mid}

    out = _both(model, scenario)
    assert out["results"][1].admitted_step >= out["mid"]
    assert out["stats"].trace_index == 0
    _assert_margins(model, out["results"], 64)


def test_session_usable_after_capacity_error(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8, n_pages=4)
        sess = sched.session()
        rng = np.random.default_rng(8)
        with pytest.raises(ValueError, match="page-pool capacity"):
            sess.submit(pkg.Request(prompt=_prompt(rng, 20), n_tokens=8))
        with pytest.raises(ValueError, match="engine capacity"):
            sess.submit(pkg.Request(prompt=_prompt(rng, 30), n_tokens=8))
        assert sess.idle and not sess.queue
        first = sess.serve([pkg.Request(prompt=_prompt(rng, 10), n_tokens=3)])
        h = sess.submit(pkg.Request(prompt=_prompt(rng, 6), n_tokens=4))
        sess.step()
        with pytest.raises(ValueError):
            sess.submit(pkg.Request(prompt=_prompt(rng, 30), n_tokens=8))
        sess.drain()
        return {"first": first, "results": [h.result], "stats": sess.last_stats}

    out = _both(model, scenario)
    assert out["first"][0].tokens.size == 13 and out["results"][0].tokens.size == 10


def test_batch_serve_validates_before_enqueuing(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32)
        rng = np.random.default_rng(9)
        with pytest.raises(ValueError, match="engine capacity"):
            sched.serve([pkg.Request(prompt=_prompt(rng, 4), n_tokens=2),
                         pkg.Request(prompt=_prompt(rng, 30), n_tokens=8)])
        return {"idle": sched.session().idle, "queue": len(sched.session().queue),
                "live": sorted(sched.session()._live_rids)}

    out = _both(model, scenario)
    assert out["idle"] and out["queue"] == 0 and out["live"] == []


def test_cross_trace_counters(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=64, page_size=8)
        rng = np.random.default_rng(10)
        system = _prompt(rng, 16)
        sched.serve(_shared_prefix_trace(pkg, rng, system, [2, 3, 4]))
        s1 = sched.last_stats
        sched.serve(_shared_prefix_trace(pkg, rng, system, [5, 2], rid0=10))
        return {"s1": s1, "s2": sched.last_stats}

    out = _both(model, scenario)
    s1, s2 = out["s1"].paging, out["s2"].paging
    assert s1["prefix_hits"] == 4 and s1["cross_trace_hits"] == 0
    assert s2["prefix_hits"] == 4 and s2["cross_trace_hits"] == 4
    assert s2["cross_trace_hit_tokens"] == 32 and s2["prefix_misses"] == 0


# --- request ids -----------------------------------------------------------------------------
def test_submit_time_duplicate_live_rid(model):
    def scenario(pkg, cfg, params):
        sess = pkg.Scheduler(cfg, params, max_slots=2, max_len=64).session()
        p = _prompt(np.random.default_rng(11), 4)
        h = sess.submit(pkg.Request(prompt=p, n_tokens=2, rid=7))
        with pytest.raises(ValueError, match="duplicate request id 7"):
            sess.submit(pkg.Request(prompt=p, n_tokens=2, rid=7))
        sess.drain()
        h2 = sess.submit(pkg.Request(prompt=p, n_tokens=2, rid=7))
        sess.drain()
        return {"results": [h.result, h2.result], "stats": sess.last_stats}

    out = _both(model, scenario)
    np.testing.assert_array_equal(out["results"][0].tokens, out["results"][1].tokens)


def test_auto_rids_skip_live_collisions(model):
    def scenario(pkg, cfg, params):
        sess = pkg.Scheduler(cfg, params, max_slots=2, max_len=64).session()
        rng = np.random.default_rng(12)
        manual = sess.submit(pkg.Request(prompt=_prompt(rng, 4), n_tokens=12, rid=0))
        autos = [sess.submit(pkg.Request(prompt=_prompt(rng, 4), n_tokens=2))
                 for _ in range(3)]
        sess.drain()
        return {"results": [h.result for h in [manual] + autos], "stats": sess.last_stats}

    out = _both(model, scenario)
    rids = [r.rid for r in out["results"]]
    assert len(set(rids)) == len(rids) == 4


def test_serve_default_rids_skip_live_submits(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=64)
        rng = np.random.default_rng(14)
        h = sched.submit(pkg.Request(prompt=_prompt(rng, 5), n_tokens=20))
        batch = [pkg.Request(prompt=_prompt(rng, 4), n_tokens=2) for _ in range(2)]
        results = sched.serve(batch)
        assert h.done
        return {"results": [h.result] + results, "stats": sched.last_stats}

    out = _both(model, scenario)
    assert [r.rid for r in out["results"]] == [0, 1, 2]
    _assert_margins(model, out["results"], 64)


def test_batch_duplicate_message(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32)
        p = _prompt(np.random.default_rng(13), 4)
        with pytest.raises(ValueError) as err:
            sched.serve([pkg.Request(prompt=p, n_tokens=2, rid=1),
                         pkg.Request(prompt=p, n_tokens=2)])
        return {"message": str(err.value)}

    out = _both(model, scenario)
    assert out["message"] == "duplicate request ids [1]"


def test_session_counters_survive_traces(model):
    """The session totals (preemptions, prefill chunks, shed) add up over
    traces while each trace's ServeStats holds its own."""
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=1, max_len=64, page_size=8,
                              prefill_chunk=4, max_queue=2)
        sess = sched.session()
        rng = np.random.default_rng(24)
        stats = []
        for t in range(2):
            reqs = [pkg.Request(prompt=_prompt(rng, 9), n_tokens=6, rid=10 * t, priority=1),
                    pkg.Request(prompt=_prompt(rng, 3), n_tokens=2, rid=10 * t + 1,
                                priority=2, arrival=4)]
            with pytest.raises(ValueError, match="queue overloaded"):
                sess.serve(reqs + [dataclasses.replace(reqs[0], rid=10 * t + 2)])
            sess.serve(reqs)
            stats.append(sess.last_stats)
        return {"stats": stats, "totals": (sess.total_preemptions, sess.total_prefill_chunks,
                                           sess.total_shed)}

    out = _both(model, scenario)
    per = out["stats"]
    assert all(s.shed == 0 for s in per)   # the shed batch never began a trace
    assert out["totals"] == (sum(s.preemptions for s in per),
                             sum(s.prefill_chunks for s in per), 6)
    assert out["totals"][0] >= 2 and out["totals"][1] > 0
