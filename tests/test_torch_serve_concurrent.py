"""The port's concurrent front end against the JAX reference, on the CPU:
the single pump thread (``start`` / ``stop`` / ``driving``, ``step()``
refused from other threads, ``stream()`` and ``wait()`` blocking on
delivered tokens), callbacks pinned to the pump thread and allowed to
re-enter ``submit()``, a pump failure re-raised by ``stop()``, the pump
stepping under ``no_grad``, a deterministic two-tenant trace through the
pump with a shed from a producer thread, and producer threads on one
driven session for four families.

Where the schedule depends on thread timing only the tokens are
compared (greedy tokens never depend on the schedule); where every
request is queued before the pump starts, the ``ServeStats`` counters
and ``RequestResult`` fields are compared too.  Every wait and join is
bounded (TIMEOUT), so that a deadlock fails its test.
"""
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from test_torch_serve_tenants import (_assert_margins, _both, _model, _norm, _prompt,
                                      _served)

TIMEOUT = 120


@pytest.fixture(scope="module")
def model():
    return _model()


def _join(threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


def _tokens(results):
    return {r.rid: np.asarray(r.tokens).tolist() for r in results}


# --- the single pump -------------------------------------------------------------------
def test_two_threads_stream_two_handles(model):
    """Two consumer threads stream while the pump drives; step() from a
    third thread is refused."""
    def scenario(pkg, cfg, params):
        sess = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8).session()
        rng = np.random.default_rng(0)
        reqs = [pkg.Request(prompt=_prompt(rng, 5), n_tokens=4, rid=0),
                pkg.Request(prompt=_prompt(rng, 8), n_tokens=6, rid=1)]
        outs = {0: [], 1: []}
        with sess.driving():
            handles = [sess.submit(r) for r in reqs]
            threads = [threading.Thread(target=lambda h=h: outs[h.rid].extend(h.stream()))
                       for h in handles]
            for t in threads:
                t.start()
            with pytest.raises(RuntimeError, match="background pump"):
                sess.step()
            _join(threads)
        return {"tokens": _tokens([h.result for h in handles]), "streamed": outs,
                "results": [h.result for h in handles]}

    got = scenario(*model.side("torch"))
    want = _norm(scenario(*model.side("jax")))
    assert _norm(got["tokens"]) == want["tokens"]
    for r in got["results"]:
        assert got["streamed"][r.rid] == list(r.generated)
    _assert_margins(model, got["results"], 32)


def test_cooperative_stream_steps_without_a_pump(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=1, max_len=32, page_size=8)
        h = sched.submit(pkg.Request(prompt=_prompt(np.random.default_rng(1), 6), n_tokens=5,
                                     rid=7))
        toks = list(h.stream())
        return {**_served(sched, [h.result]), "streamed": toks}

    out = _both(model, scenario)
    assert out["streamed"] == list(out["results"][0].generated)


def test_second_pump_refused_and_stop_is_clean(model):
    def scenario(pkg, cfg, params):
        sess = pkg.Scheduler(cfg, params, max_slots=1, max_len=32, page_size=8).session()
        sess.start()
        try:
            with pytest.raises(RuntimeError, match="already has"):
                sess.start()
        finally:
            sess.stop()
        res = sess.serve([pkg.Request(prompt=_prompt(np.random.default_rng(2), 4),
                                      n_tokens=2)])
        return {"results": res, "stats": sess.last_stats}

    out = _both(model, scenario)
    assert out["results"][0].tokens.size == 6


def test_serve_on_a_driven_session_waits_for_the_pump(model):
    """serve() from the main thread on a driven session blocks until its
    batch is done while the pump steps; wait_idle() returns after."""
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8)
        sess = sched.session()
        rng = np.random.default_rng(20)
        reqs = [pkg.Request(prompt=_prompt(rng, 3 + i), n_tokens=3, rid=i) for i in range(3)]
        with sess.driving():
            res = sess.serve(reqs)
            sess.wait_idle(timeout=TIMEOUT)
            assert sess.idle
        return {"results": res, "stats": sess.last_stats, "counts": sched.compile_counts()}

    out = _both(model, scenario)
    assert out["stats"].generated_tokens == 9


# --- callbacks on the pump ----------------------------------------------------------------
def test_callbacks_run_on_the_pump_thread_only(model):
    def scenario(pkg, cfg, params):
        sess = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8).session()
        rng = np.random.default_rng(3)
        idents, waiters = [], set()

        def waiter(h):
            waiters.add(threading.get_ident())
            h.wait(timeout=TIMEOUT)

        with sess.driving():
            handles = [sess.submit(pkg.Request(prompt=_prompt(rng, 4 + i), n_tokens=3, rid=i),
                                   on_token=lambda h, t: idents.append(threading.get_ident()))
                       for i in range(3)]
            threads = [threading.Thread(target=waiter, args=(h,)) for h in handles]
            for t in threads:
                t.start()
            _join(threads)
            sess.wait_idle(timeout=TIMEOUT)
        assert len(idents) == 9 and len(set(idents)) == 1
        assert set(idents) != {threading.get_ident()} and not (set(idents) & waiters)
        return {"tokens": _tokens([h.result for h in handles])}

    _both(model, scenario)


def test_callback_resubmits_while_a_producer_submits(model):
    def scenario(pkg, cfg, params):
        sess = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8).session()
        rng = np.random.default_rng(4)
        follow_req = pkg.Request(prompt=_prompt(rng, 5), n_tokens=3, rid=50)
        side_req = pkg.Request(prompt=_prompt(rng, 7), n_tokens=2, rid=60)
        first_req = pkg.Request(prompt=_prompt(rng, 4), n_tokens=4, rid=40)
        got = {}

        def cb(handle, tok):
            if "follow" not in got:
                got["follow"] = sess.submit(follow_req)

        with sess.driving():
            first = sess.submit(first_req, on_token=cb)
            t = threading.Thread(target=lambda: got.setdefault("side", sess.submit(side_req)))
            t.start()
            _join([t])
            sess.wait_idle(timeout=TIMEOUT)
        return {"tokens": _tokens([first.result, got["follow"].result, got["side"].result])}

    _both(model, scenario)


def test_pump_error_is_reraised_by_stop(model):
    """A raising callback kills the pump; stop() (the driving() exit)
    re-raises it, and the session then resumes cooperatively with the
    tokens an undisturbed run gives."""
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8)
        sess = sched.session()
        rng = np.random.default_rng(22)
        reqs = [pkg.Request(prompt=_prompt(rng, 5 + i), n_tokens=4, rid=i) for i in range(2)]
        calls = []

        def boom(h, t):
            calls.append(t)
            if len(calls) == 2:
                raise RuntimeError("callback failed on the pump")

        handles = [sess.submit(r, on_token=boom) for r in reqs]
        with pytest.raises(RuntimeError, match="failed on the pump"):
            with sess.driving():
                deadline = time.monotonic() + TIMEOUT
                while sess._driven_elsewhere() and time.monotonic() < deadline:
                    time.sleep(0.01)
        assert not sess._driven_elsewhere()
        sess.drain()
        return {"results": [h.result for h in handles], "stats": sess.last_stats}

    _both(model, scenario)


def test_pump_steps_under_no_grad(model):
    """The pump is its own thread, and no_grad is per thread: with params
    that require grad, a driven serve must build no autograd graph (the
    pool gets no grad_fn) and give the reference's tokens."""
    pkg, cfg, params = model.side("torch")

    def req_grad(x):
        if isinstance(x, dict):
            return {k: req_grad(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(req_grad(v) for v in x)
        if torch.is_tensor(x) and x.is_floating_point():
            return x.detach().clone().requires_grad_(True)
        return x

    gparams = req_grad(params)
    rng = np.random.default_rng(25)
    reqs = [pkg.Request(prompt=_prompt(rng, 6 + i), n_tokens=3, rid=i) for i in range(2)]
    sess = pkg.Scheduler(cfg, gparams, max_slots=2, max_len=32, page_size=8).session()
    with sess.driving():
        handles = [sess.submit(r) for r in reqs]
        sess.wait_idle(timeout=TIMEOUT)
    assert not any(leaf.requires_grad for leaves in sess.pool for leaf in leaves.values())
    jpkg, jcfg, jparams = model.side("jax")
    want = jpkg.Scheduler(jcfg, jparams, max_slots=2, max_len=32, page_size=8).serve(
        [jpkg.Request(prompt=r.prompt, n_tokens=3, rid=r.rid) for r in reqs])
    assert _tokens([h.result for h in handles]) == _tokens(want)


# --- the two-tenant trace through the pump ---------------------------------------------------
def test_driven_two_tenant_trace_matches_reference(model):
    """All requests are queued before the pump starts, so the schedule is
    the reference's: a producer thread's submission sheds (the queue is
    full), a consumer thread per tenant streams and waits, a long
    interactive prompt fills in chunks off the page grid and preempts a
    batch request."""
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=48, page_size=8,
                              prefill_chunk=3, max_queue=4)
        sess = sched.session()
        rng = np.random.default_rng(26)
        system = _prompt(rng, 8)
        batch = [pkg.Request(prompt=np.concatenate([system, _prompt(rng, 2 + i)]), n_tokens=8,
                             rid=i, tenant="batch") for i in range(2)]
        inter = [pkg.Request(prompt=_prompt(rng, 10), n_tokens=3, rid=10, priority=3,
                             arrival=2, tenant="interactive"),
                 pkg.Request(prompt=_prompt(rng, 3), n_tokens=3, rid=11, priority=3,
                             arrival=4, tenant="interactive")]
        delivered = []
        handles = {r.rid: sess.submit(r, on_token=lambda h, t: delivered.append(h.rid))
                   for r in batch + inter}
        shed = []

        def producer():
            try:
                sess.submit(pkg.Request(prompt=_prompt(rng, 3), n_tokens=2, rid=99))
            except ValueError as e:
                shed.append(str(e))

        t = threading.Thread(target=producer)
        t.start()
        _join([t])
        streams = {}

        def consume(tenant):
            for h in handles.values():
                if h.request.tenant == tenant:
                    streams[h.rid] = list(h.stream())
                    h.wait(timeout=TIMEOUT)

        with sess.driving():
            threads = [threading.Thread(target=consume, args=(x,))
                       for x in ("batch", "interactive")]
            for t in threads:
                t.start()
            _join(threads)
            sess.wait_idle(timeout=TIMEOUT)
        return {**_served(sched, [h.result for h in handles.values()]), "shed": shed,
                "streams": streams, "delivered": sorted(delivered)}

    out = _both(model, scenario)
    st = out["stats"]
    assert len(out["shed"]) == 1 and st.shed == 1
    assert st.preemptions >= 1 and st.prefill_chunks >= 4
    victims = [r for r in out["results"] if r.preemptions]
    assert victims and all(r.tenant == "batch" and r.admitted_step == 0 for r in victims)
    for r in out["results"]:
        assert out["streams"][r.rid] == list(r.generated)
    _assert_margins(model, out["results"], 48)


# --- producer threads, four families ---------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b", "falcon-mamba-7b",
                                  "jamba-v0.1-52b"])
def test_producer_threads_on_one_driven_session(arch):
    """Two producer threads submit mixed-priority traffic (a chunk-length
    prompt included) to one driven session: the reference's tokens, and
    a program budget of one decode plus one prefill per (bucket, width)
    used."""
    m = _model(arch)

    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8, max_queue=32,
                              prefill_chunk=4)
        sess = sched.session()
        rng = np.random.default_rng(17)
        V = cfg.vocab_size
        traces = {0: [pkg.Request(prompt=_prompt(rng, 3, V), n_tokens=2, rid=0, tenant="batch"),
                      pkg.Request(prompt=_prompt(rng, 17, V), n_tokens=2, rid=1,
                                  tenant="batch")],
                  1: [pkg.Request(prompt=_prompt(rng, 5, V), n_tokens=3, rid=10, priority=2,
                                  tenant="web"),
                      pkg.Request(prompt=_prompt(rng, 9, V), n_tokens=2, rid=11, priority=3,
                                  tenant="interactive")]}
        handles = {}

        def producer(tid):
            for req in traces[tid]:
                handles[req.rid] = sess.submit(req)

        with sess.driving():
            threads = [threading.Thread(target=producer, args=(tid,)) for tid in traces]
            for t in threads:
                t.start()
            _join(threads)
            sess.wait_idle(timeout=TIMEOUT)
        counts = sched.compile_counts()
        assert counts["decode"] == 1 and all(n == 1 for n in counts["prefill"].values())
        assert all(b in sched.prefill_buckets and w in (1, 2) for b, w in counts["prefill"])
        return {"tokens": _tokens([handles[r].result for r in sorted(handles)]),
                "results": [handles[r].result for r in sorted(handles)]}

    got = scenario(*m.side("torch"))
    want = _norm(scenario(*m.side("jax")))
    assert _norm(got["tokens"]) == want["tokens"]
    _assert_margins(m, got["results"], 32)


def test_observers_read_tokens_while_the_pump_runs(model):
    """The pump holds the session lock for one tick at a time: a consumer
    streams a long request's tokens before it retires, and a producer's
    submission mid-trace joins the running trace.  (The reference's pump
    holds the lock for the whole busy period, so there the consumer sees
    every token at once and the producer's request opens a second
    trace; the tokens are the same.)"""
    pkg, cfg, params = model.side("torch")
    sess = pkg.Scheduler(cfg, params, max_slots=2, max_len=64, page_size=8).session()
    rng = np.random.default_rng(27)
    long_req = pkg.Request(prompt=_prompt(rng, 5), n_tokens=48, rid=0)
    late_req = pkg.Request(prompt=_prompt(rng, 4), n_tokens=3, rid=1)
    h = sess.submit(long_req)
    seen, late = [], []

    def consume():
        for _ in h.stream():
            seen.append(h.n_generated)
            if not late:
                late.append(sess.submit(late_req))

    with sess.driving():
        t = threading.Thread(target=consume)
        t.start()
        _join([t])
        sess.wait_idle(timeout=TIMEOUT)
    assert seen[0] < long_req.n_tokens and len(set(seen)) > 1
    assert late[0].done and sess.last_stats.trace_index == 0
    jpkg, jcfg, jparams = model.side("jax")
    want = jpkg.Scheduler(jcfg, jparams, max_slots=2, max_len=64, page_size=8).serve(
        [jpkg.Request(prompt=r.prompt, n_tokens=r.n_tokens, rid=r.rid)
         for r in (long_req, late_req)])
    assert _tokens([h.result, late[0].result]) == _tokens(want)
