"""The port's multi-tenant Scheduler against the JAX reference, on the CPU:
priorities with stride fairness, preemption with resume, queue
shedding, chunked prefill (chunks that are not a page multiple
included), the monolithic ``paged=False`` path and ``compile_counts``.

Every case runs one trace through ``repro.serve.Scheduler`` and
``repro_torch.serve.Scheduler`` on the reference's own params (smoke
configs with ``cache_dtype="float32"``, so prefix reuse, preemption and
chunking are active where the architecture allows them) and requires the
same greedy tokens, the same ``RequestResult`` fields (admitted and
finished steps, prefix-hit tokens, preemptions, priority, tenant), the
same ``ServeStats`` counters (preemptions, prefill chunks, shed and the
paging dict included) and the same ``compile_counts()``.  Every greedy
token the port serves is also its own ``Engine``'s teacher-forced argmax
with a top-2 margin of at least MIN_MARGIN (``tests/test_torch_serve.py``'s
rule), so that a near-tie fails by name.

The helpers here (``_both``, ``_norm``, ``_assert_margins``) are shared
with ``test_torch_serve_session.py`` and
``test_torch_serve_concurrent.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import lm as jlm
from repro_torch import bridge, configs
from repro_torch import serve as tserve
from repro_torch.models import lm as tlm

VOCAB = 512
MIN_MARGIN = 1e-4
RESULT_FIELDS = ("rid", "prompt_len", "arrival", "admitted_step", "finished_step",
                 "prefix_hit_tokens", "priority", "tenant", "preemptions")
STAT_FIELDS = ("steps", "decode_steps", "prefills", "prefill_batches", "max_slots",
               "generated_tokens", "prefix_reuse_active", "paging", "trace_index",
               "pool_bytes", "preemptions", "prefill_chunks", "shed")


@dataclasses.dataclass
class Model:
    arch: str
    jcfg: object
    tcfg: object
    jparams: object
    tparams: object

    def side(self, name):
        """(package, cfg, params) of one side: "jax" or "torch"."""
        if name == "jax":
            return jserve, self.jcfg, self.jparams
        return tserve, self.tcfg, self.tparams


_MODELS = {}


def _model(arch="qwen2.5-3b") -> Model:
    """Smoke ``arch`` with a float32 cache on both sides, the port on the
    reference's params (built once per process)."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), cache_dtype="float32")
        if arch != "qwen2.5-3b":
            jcfg = dataclasses.replace(jcfg, attn_backend="xla")
        tcfg = dataclasses.replace(configs.get_smoke_config(arch), cache_dtype="float32")
        params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg))
        _MODELS[arch] = Model(arch, jcfg, tcfg, params, bridge.params_from_numpy(params, "cpu"))
    return _MODELS[arch]


@pytest.fixture(scope="module")
def model():
    return _model()


def _prompt(rng, n, vocab=VOCAB):
    return rng.integers(0, vocab, n).astype(np.int32)


def _norm(x):
    """Results, stats and containers as plain comparable values."""
    if isinstance(x, (jserve.RequestResult, tserve.RequestResult)):
        out = {f: getattr(x, f) for f in RESULT_FIELDS}
        out["tokens"] = np.asarray(x.tokens).tolist()
        return out
    if isinstance(x, (jserve.ServeStats, tserve.ServeStats)):
        return {f: getattr(x, f) for f in STAT_FIELDS}
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _both(model: Model, scenario, **kw):
    """Run ``scenario(pkg, cfg, params, **kw)`` (a dict of results) on
    both sides and require the two equal; returns the port's dict."""
    want = _norm(scenario(*model.side("jax"), **kw))
    got = scenario(*model.side("torch"), **kw)
    norm = _norm(got)
    assert norm.keys() == want.keys()
    for k in want:
        assert norm[k] == want[k], k
    return got


def _assert_margins(model: Model, results, max_len):
    """Each served token is the port Engine's teacher-forced argmax with a
    top-2 margin >= MIN_MARGIN."""
    eng = tserve.Engine(model.tcfg, model.tparams, max_len=max_len)
    logits = eng.teacher_force([r.tokens[:r.prompt_len] for r in results],
                               [r.generated for r in results])
    for r, lg in zip(results, logits):
        top2 = torch.topk(lg, 2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        assert margin >= MIN_MARGIN, f"rid {r.rid}: near-tie, top-2 margin {margin:.3g}"
        np.testing.assert_array_equal(torch.argmax(lg, dim=-1).numpy(), r.generated)


def _served(sched, results):
    return {"results": results, "stats": sched.last_stats, "counts": sched.compile_counts()}


# --- preemption ----------------------------------------------------------------------
def _preempt_trace(pkg, cfg, params, temperature=0.0):
    rng = np.random.default_rng(7)
    sched = pkg.Scheduler(cfg, params, max_slots=1, max_len=64, page_size=8)
    lo = pkg.Request(prompt=_prompt(rng, 6), n_tokens=10, rid=0, priority=1, arrival=0,
                     tenant="batch", temperature=temperature)
    hi = pkg.Request(prompt=_prompt(rng, 5), n_tokens=3, rid=1, priority=3, arrival=3,
                     tenant="interactive")
    return _served(sched, sched.serve([lo, hi]))


def test_preemption_resumes_and_matches_reference(model):
    """One slot: a priority-3 arrival evicts the priority-1 occupant,
    which re-queues and resumes from its cached pages."""
    out = _both(model, _preempt_trace)
    r_lo, r_hi = out["results"]
    assert out["stats"].preemptions == 1
    assert (r_lo.preemptions, r_hi.preemptions) == (1, 0)
    assert r_lo.admitted_step == 0 and r_lo.tenant == "batch" and r_hi.priority == 3
    _assert_margins(model, out["results"], 64)


def test_preempted_sampled_stream_is_the_unpreempted_stream(model):
    """A preempted sampled request reproduces the port's own stream served
    alone (the counter-hash sampler is keyed by (seed, rid, step)); the
    schedule and the counters are the reference's."""
    _, cfg, params = model.side("torch")
    rng = np.random.default_rng(7)
    lone = tserve.Scheduler(cfg, params, max_slots=1, max_len=64, page_size=8).serve(
        [tserve.Request(prompt=_prompt(rng, 6), n_tokens=10, rid=0, temperature=0.8)])[0]
    j = _norm(_preempt_trace(*model.side("jax"), temperature=0.8))
    t = _preempt_trace(*model.side("torch"), temperature=0.8)
    assert t["stats"].preemptions == 1
    np.testing.assert_array_equal(lone.tokens, t["results"][0].tokens)
    for k in ("stats", "counts"):
        assert _norm(t[k]) == j[k]
    drop = ("tokens",)
    assert ([{f: v for f, v in r.items() if f not in drop} for r in _norm(t["results"])]
            == [{f: v for f, v in r.items() if f not in drop} for r in j["results"]])
    greedy = _preempt_trace(*model.side("torch"))["results"][0]
    assert not np.array_equal(greedy.tokens, t["results"][0].tokens)


def test_equal_priority_never_preempts(model):
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(9)
        sched = pkg.Scheduler(cfg, params, max_slots=1, max_len=32, page_size=8)
        return _served(sched, sched.serve([
            pkg.Request(prompt=_prompt(rng, 4), n_tokens=6, rid=0, priority=2),
            pkg.Request(prompt=_prompt(rng, 4), n_tokens=2, rid=1, priority=2, arrival=2)]))

    out = _both(model, scenario)
    assert out["stats"].preemptions == 0
    assert out["results"][1].admitted_step == out["results"][0].finished_step


def test_preempt_false_waits_instead(model):
    """``preempt=False``: the higher class waits for the slot."""
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(7)
        sched = pkg.Scheduler(cfg, params, max_slots=1, max_len=64, page_size=8,
                              preempt=False)
        return _served(sched, sched.serve([
            pkg.Request(prompt=_prompt(rng, 6), n_tokens=10, rid=0, priority=1),
            pkg.Request(prompt=_prompt(rng, 5), n_tokens=3, rid=1, priority=3, arrival=3)]))

    out = _both(model, scenario)
    assert out["stats"].preemptions == 0
    assert out["results"][1].admitted_step == out["results"][0].finished_step


# --- chunked prefill -------------------------------------------------------------------
def test_chunked_prefill_interleaves_cotenant_decode(model):
    """``prefill_chunk=4``: a 24-token prompt fills over 6 ticks while a
    co-tenant decodes; the per-tick token counts are the reference's."""
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(10)
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8,
                              prefill_chunk=4)
        sess = sched.session()
        h_long = sess.submit(pkg.Request(prompt=_prompt(rng, 24), n_tokens=3, rid=0))
        h_short = sess.submit(pkg.Request(prompt=_prompt(rng, 4), n_tokens=6, rid=1))
        ticks, overlapped = [], False
        while not sess.idle:
            ticks.append(sess.step())
            overlapped |= bool(h_short.n_generated and not h_long.n_generated)
        return {**_served(sched, [h_long.result, h_short.result]), "ticks": ticks,
                "overlapped": overlapped, "chunk_active": sched.chunk_active}

    out = _both(model, scenario)
    assert out["overlapped"] and out["chunk_active"]
    assert out["stats"].prefill_chunks == 6
    _assert_margins(model, out["results"], 32)


def test_chunked_prefill_shares_the_program_budget(model):
    """Chunk advances draw from the burst prefill's (bucket, width) keys;
    a warm re-serve stays inside the same budget."""
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(11)
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8,
                              prefill_chunk=4)
        reqs = [pkg.Request(prompt=_prompt(rng, n), n_tokens=t, rid=i)
                for i, (n, t) in enumerate([(17, 2), (24, 3), (4, 2), (7, 3)])]
        first = _served(sched, sched.serve(reqs))
        again = sched.serve([dataclasses.replace(r, rid=100 + i) for i, r in enumerate(reqs)])
        return {"first": first, "again": _served(sched, again)}

    out = _both(model, scenario)
    counts = out["again"]["counts"]
    assert counts["decode"] == 1 and all(n == 1 for n in counts["prefill"].values())
    assert all(w in (1, 2) for _, w in counts["prefill"])
    assert counts["total"] <= 1 + 6 * 2
    _assert_margins(model, out["first"]["results"] + out["again"]["results"], 32)


def test_chunks_off_the_page_grid_with_prefix_reuse(model):
    """``prefill_chunk=3`` over pages of 8: every chunk after the first
    starts mid-page, chunk pages register as they fill, and a later
    request hits them; a priority-2 arrival preempts a chunking slot."""
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(21)
        system = _prompt(rng, 19)
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=48, page_size=8,
                              prefill_chunk=3)
        reqs = [pkg.Request(prompt=np.concatenate([system, _prompt(rng, 2 + i)]),
                            n_tokens=4, rid=i, arrival=a)
                for i, a in enumerate([0, 0, 9])]
        reqs.append(pkg.Request(prompt=_prompt(rng, 5), n_tokens=3, rid=3, priority=2,
                                arrival=2, tenant="interactive"))
        return _served(sched, sched.serve(reqs))

    out = _both(model, scenario)
    st = out["stats"]
    assert st.prefill_chunks > 8 and st.preemptions >= 1
    assert out["results"][2].prefix_hit_tokens == 16       # two pages filled by chunks
    _assert_margins(model, out["results"], 48)


def test_transient_page_wait_during_chunk_fill(model):
    """A chunk fill holds most of a tight pool while an eligible request
    cannot fit and nothing decodes: a wait, not a page accounting bug."""
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(13)
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=4, n_pages=8,
                              prefill_chunk=4)
        return _served(sched, sched.serve([
            pkg.Request(prompt=_prompt(rng, 20), n_tokens=2, rid=0),
            pkg.Request(prompt=_prompt(rng, 12), n_tokens=2, rid=1)]))

    assert tserve.pages_needed(20, 2, 4) == 6 and tserve.pages_needed(12, 2, 4) == 4
    out = _both(model, scenario)
    assert out["stats"].prefill_chunks == 5 + 3
    assert out["results"][1].admitted_step >= out["results"][0].finished_step
    _assert_margins(model, out["results"], 32)


def test_page_leak_still_raises(model):
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8)
        sess = sched.session()
        assert sess.ppool.allocate(sess.ppool.available())
        sess.submit(pkg.Request(prompt=_prompt(np.random.default_rng(14), 6), n_tokens=2,
                                rid=0))
        with pytest.raises(RuntimeError, match="page accounting bug"):
            sess.step()
        return {"queued": len(sess.queue)}

    _both(model, scenario)


def test_decode_masks_chunk_slots_to_the_garbage_page(model, monkeypatch):
    """Poison the inactive rows' input: every slot's decode input starts
    as a token no prompt holds, so a clamped decode write through a
    chunk-filling slot's real block table would overwrite row 0 of its
    first page with that token's K/V.  Around every decode step the
    filled rows of each chunking slot's pages must be unchanged, and the
    tokens must be the unpoisoned run's and the reference's."""
    _, cfg, params = model.side("torch")
    sched = tserve.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8,
                             prefill_chunk=4)
    sess = sched.session()
    sess.cur[:] = VOCAB - 1
    real = tlm.decode_step_paged
    checked = []

    def guarded(params_, inputs, pos, pool, block_tables, cfg_):
        rows = []
        for slot in sorted(sess._chunk_slots):
            ck = sess.occupant[slot]["chunk"]
            pages = torch.as_tensor(sess.btables[slot, :-(-ck["filled"] // 8)]).long()
            rows.append([{k: v[:, pages].clone() for k, v in c.items()} for c in pool])
            assert not block_tables[slot].any()
        out = real(params_, inputs, pos, pool, block_tables, cfg_)
        for slot, before in zip(sorted(sess._chunk_slots), rows):
            ck = sess.occupant[slot]["chunk"]
            pages = torch.as_tensor(sess.btables[slot, :-(-ck["filled"] // 8)]).long()
            for c, b in zip(pool, before):
                for k, v in c.items():
                    filled = v[:, pages].reshape(v.shape[0], -1, *v.shape[3:])[:, :ck["filled"]]
                    want = b[k].reshape(v.shape[0], -1, *v.shape[3:])[:, :ck["filled"]]
                    assert torch.equal(filled, want)
            checked.append(slot)
        return out

    monkeypatch.setattr(tlm, "decode_step_paged", guarded)
    rng = np.random.default_rng(10)
    reqs = [tserve.Request(prompt=_prompt(rng, 24, VOCAB - 1), n_tokens=3, rid=0),
            tserve.Request(prompt=_prompt(rng, 4, VOCAB - 1), n_tokens=6, rid=1)]
    poisoned = sess.serve(reqs)
    monkeypatch.setattr(tlm, "decode_step_paged", real)
    assert checked                              # decode ran beside a chunk fill
    clean = tserve.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8,
                             prefill_chunk=4).serve(reqs)
    jsched = jserve.Scheduler(model.jcfg, model.jparams, max_slots=2, max_len=32,
                              page_size=8, prefill_chunk=4)
    ref = jsched.serve([jserve.Request(prompt=r.prompt, n_tokens=r.n_tokens, rid=r.rid)
                        for r in reqs])
    for p, c, j in zip(poisoned, clean, ref):
        np.testing.assert_array_equal(p.tokens, c.tokens)
        np.testing.assert_array_equal(p.tokens, j.tokens)


# --- fairness --------------------------------------------------------------------------
def test_weighted_share_follows_priority(model):
    """One slot, a backlogged priority-2 class against a priority-1
    class: 2:1 admissions (2, 1, 2 in every 3), the low class not
    starved."""
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(15)
        sched = pkg.Scheduler(cfg, params, max_slots=1, max_len=32, page_size=8)
        return _served(sched, sched.serve([
            pkg.Request(prompt=_prompt(rng, 4), n_tokens=2, rid=i, priority=2 if i < 6 else 1)
            for i in range(9)]))

    out = _both(model, scenario)
    order = sorted(out["results"], key=lambda r: (r.admitted_step, r.rid))
    assert [r.priority for r in order] == [2, 1, 2, 2, 1, 2, 2, 1, 2]


def test_single_class_is_fifo(model):
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(16)
        sched = pkg.Scheduler(cfg, params, max_slots=1, max_len=32, page_size=8)
        return _served(sched, sched.serve([
            pkg.Request(prompt=_prompt(rng, 4), n_tokens=2, rid=i, priority=3)
            for i in range(4)]))

    out = _both(model, scenario)
    admits = [r.admitted_step for r in out["results"]]
    assert admits == sorted(admits)


@pytest.mark.parametrize("seed", [3, 101, 4242])
def test_random_multitenant_traffic(model, seed):
    """Random bursty traffic with mixed priorities on a tight pool
    (preemption and chunking reachable): the reference's schedule, page
    conservation after every tick, every request retired in full, and
    first admissions FIFO within each class."""
    def scenario(pkg, cfg, params):
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=4, n_pages=12,
                              prefill_chunk=6)
        sess = sched.session()
        rng = np.random.default_rng(seed)
        handles = [sess.submit(pkg.Request(
            prompt=_prompt(rng, int(rng.integers(2, 14))), n_tokens=int(rng.integers(1, 5)),
            rid=i, arrival=int(rng.integers(0, 4)), priority=int(rng.integers(1, 4)),
            tenant=f"t{int(rng.integers(0, 3))}")) for i in range(int(rng.integers(3, 7)))]
        sess.ppool.check_conservation()
        while not sess.idle:
            sess.step()
            sess.ppool.check_conservation()
        assert sess.ppool.available() == sess.ppool.usable_pages
        for h in handles:
            assert h.result.tokens.size == h.request.prompt.size + h.request.n_tokens
        return _served(sched, [h.result for h in handles])

    out = _both(model, scenario)
    by_class = {}
    for r in out["results"]:
        by_class.setdefault(r.priority, []).append(r)
    for rs in by_class.values():
        rs.sort(key=lambda r: (r.arrival, r.rid))
        assert [r.admitted_step for r in rs] == sorted(r.admitted_step for r in rs)
    _assert_margins(model, out["results"], 32)


# --- shedding ----------------------------------------------------------------------------
def test_check_queue_capacity_contract():
    for check in (jserve.check_queue_capacity, tserve.check_queue_capacity):
        check(5, 3, None)
        check(5, 3, 8)
        with pytest.raises(ValueError, match="queue overloaded: 5 queued \\+ 4 incoming"):
            check(5, 4, 8)


def test_submit_sheds_over_max_queue(model):
    """The third queued request sheds; the session serves the other two,
    and the shed one after the backlog drained; shed counts per trace
    (ServeStats) and per session (total_shed)."""
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(5)
        sched = pkg.Scheduler(cfg, params, max_slots=1, max_len=32, page_size=8, max_queue=2)
        sess = sched.session()
        reqs = [pkg.Request(prompt=_prompt(rng, 4), n_tokens=2, rid=i, arrival=5)
                for i in range(3)]
        h0, h1 = sess.submit(reqs[0]), sess.submit(reqs[1])
        with pytest.raises(ValueError, match="queue overloaded"):
            sess.submit(reqs[2])
        sess.drain()
        first = _served(sched, [h0.result, h1.result])
        h2 = sess.submit(dataclasses.replace(reqs[2], arrival=0))
        sess.drain()
        return {"first": first, "second": _served(sched, [h2.result]),
                "total_shed": sess.total_shed}

    out = _both(model, scenario)
    assert out["first"]["stats"].shed == 1 and out["second"]["stats"].shed == 0
    assert out["total_shed"] == 1


def test_batch_serve_sheds_atomically(model):
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(6)
        sched = pkg.Scheduler(cfg, params, max_slots=1, max_len=32, page_size=8, max_queue=2)
        reqs = [pkg.Request(prompt=_prompt(rng, 4), n_tokens=2, rid=i) for i in range(3)]
        with pytest.raises(ValueError, match="queue overloaded"):
            sched.serve(reqs)
        assert not sched.session().queue
        out = _served(sched, sched.serve(reqs[:2]))
        return {**out, "total_shed": sched.session().total_shed}

    out = _both(model, scenario)
    assert out["total_shed"] == 3 and out["stats"].shed == 0


def test_option_errors_and_gates(model):
    """The options' ValueErrors, and the gates: paged=False turns prefix
    reuse, preemption and chunking off."""
    for pkg, cfg, params in (model.side("jax"), model.side("torch")):
        for kw, msg in ((dict(max_queue=0), "max_queue"), (dict(prefill_chunk=0),
                                                            "prefill_chunk")):
            with pytest.raises(ValueError, match=msg):
                pkg.Scheduler(cfg, params, max_len=32, **kw)
        sched = pkg.Scheduler(cfg, params, max_slots=1, max_len=32, page_size=8)
        with pytest.raises(ValueError, match="priority must be >= 1"):
            sched.submit(pkg.Request(prompt=[1, 2], n_tokens=1, priority=0))
        assert sched.session().idle and sched.session().last_stats is None
        on = pkg.Scheduler(cfg, params, max_len=32, page_size=8, prefill_chunk=4)
        off = pkg.Scheduler(cfg, params, max_len=32, paged=False, prefill_chunk=4)
        assert (on.prefix_reuse_active, on.preempt_active, on.chunk_active) == (True,) * 3
        assert (off.prefix_reuse_active, off.preempt_active, off.chunk_active) == (False,) * 3
        assert not off.burst_prefill and off.pages_per_slot == 0


# --- the monolithic path -----------------------------------------------------------------
def test_paged_false_priorities_match_reference(model):
    """paged=False: one prefill per admission over the monolithic pool
    (programs keyed by prompt bucket), stride fairness over the classes,
    no paging stats; two traces through one session."""
    def scenario(pkg, cfg, params):
        rng = np.random.default_rng(19)
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, paged=False)
        reqs = [pkg.Request(prompt=_prompt(rng, n), n_tokens=t, rid=i, priority=p,
                            arrival=a, tenant=f"p{p}")
                for i, (n, t, p, a) in enumerate([(5, 6, 1, 0), (9, 3, 1, 0), (3, 4, 2, 1),
                                                  (12, 2, 2, 1), (7, 3, 1, 2), (4, 5, 2, 2)])]
        first = _served(sched, sched.serve(reqs))
        again = sched.serve([dataclasses.replace(r, rid=50 + i) for i, r in enumerate(reqs)])
        return {"first": first, "again": _served(sched, again)}

    out = _both(model, scenario)
    st = out["again"]["stats"]
    assert st.paging is None and st.trace_index == 1 and st.preemptions == 0
    assert set(out["again"]["counts"]["prefill"]) <= {4, 8, 16}
    for a, b in zip(out["first"]["results"], out["again"]["results"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    _assert_margins(model, out["first"]["results"], 32)


# --- the other families --------------------------------------------------------------------
def _family_trace(pkg, cfg, params):
    """A shared prefix, a long prompt over chunks of 5, and a priority-3
    arrival on 2 slots."""
    rng = np.random.default_rng(23)
    system = _prompt(rng, 10, cfg.vocab_size)
    sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=48, page_size=8, prefill_chunk=5,
                          max_queue=6)
    reqs = [pkg.Request(prompt=np.concatenate([system, _prompt(rng, 3 + i, cfg.vocab_size)]),
                        n_tokens=6, rid=i, tenant="batch") for i in range(2)]
    reqs.append(pkg.Request(prompt=_prompt(rng, 17, cfg.vocab_size), n_tokens=3, rid=2,
                            arrival=1, tenant="batch"))
    reqs.append(pkg.Request(prompt=_prompt(rng, 4, cfg.vocab_size), n_tokens=3, rid=3,
                            priority=3, arrival=2, tenant="interactive"))
    out = _served(sched, sched.serve(reqs))
    out["gates"] = (sched.prefix_reuse_active, sched.preempt_active, sched.chunk_active)
    return out


@pytest.mark.parametrize("arch,active", [("deepseek-v3-671b", True),
                                         ("falcon-mamba-7b", False),
                                         ("jamba-v0.1-52b", False)])
def test_family_tenant_trace_matches_reference(arch, active):
    """MLA (deepseek-v3): preemption and chunking active over compressed
    pages.  SSM (falcon-mamba) and hybrid (jamba): both gated off with
    prefix reuse, every prompt prefilled whole."""
    m = _model(arch)
    out = _both(m, _family_trace)
    st = out["stats"]
    assert out["gates"] == (active,) * 3
    assert (st.preemptions > 0, st.prefill_chunks > 0) == (active, active)
    _assert_margins(m, out["results"], 48)
