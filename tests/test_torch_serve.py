"""The port's serving stack against the JAX reference, on the CPU.

* ``PagePool``: a random admit/retire sequence with shared prefixes and
  eviction pressure, run on both pools; every return value, refcount and
  ``PageStats`` counter is equal at every step.
* ``Scheduler``: a mixed trace with shared prefixes, interleaved arrivals
  and burst admissions, through the JAX Scheduler and the port's on the
  reference's own params (smoke qwen2.5-3b with ``cache_dtype="float32"``,
  so prefix reuse is active, as ``tests/test_serve_scheduler.py`` runs
  it): greedy tokens and the ``ServeStats`` counters (steps, decode steps,
  prefills, prefill batches, the paging dict) are equal, and so are the
  port Scheduler's tokens and the port Engine's run per request.  The
  same holds under an int8 ``dcim_numerics``.
* Every greedy-equality check also requires a top-2 logit margin of at
  least MIN_MARGIN at each generated position (from the port Engine's
  teacher-forced logits), so that a near-tie fails by name: the two
  packages' float32 logits differ by ~1e-6 (``test_torch_lm.py``).
* Admission errors (oversize, duplicate rid), EOS retirement, the
  idle-gap jump, and the sampled-stream property: a request's sampled
  tokens depend on (seed, rid, step) only, not on its slot, its burst
  or the order of arrival.
* The MLA + MoE family (deepseek-v3 smoke, ``cache_dtype="float32"``):
  the same trace gives the JAX Scheduler's greedy tokens and
  ``ServeStats`` with prefix hits (the compressed c_kv / k_rope pages
  are reused), also under an int8 ``dcim_numerics``; jamba (smoke) gives
  them with prefix reuse gated off by its SSM layers.
* The SSM family (falcon-mamba-7b smoke, ``cache_dtype="float32"``): the
  same shared-prefix trace gives the JAX Scheduler's greedy tokens and
  ``ServeStats``, also under an int8 ``dcim_numerics``; and prefix reuse
  is gated off in both, with 0 prefix-hit tokens, although the cache
  dtype equals the compute dtype: a recurrent state is not held in
  pages, so a reused prefix would hand the tail a zero state.
"""
import dataclasses

import jax
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro import configs as jconfigs
from repro.core.precision import get as jget
from repro.models import lm as jlm
from repro.serve import PagePool as JPagePool
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import prefix_page_hashes as jhashes
from repro.sim.functional import DCIMMacroSim as JSim
from repro_torch import bridge, configs
from repro_torch.core.precision import get as tget
from repro_torch.serve import Engine, PagePool, Request, Scheduler, prefix_page_hashes
from repro_torch.sim.functional import DCIMMacroSim as TSim

ARCH = "qwen2.5-3b"
VOCAB = 512
MIN_MARGIN = 1e-4
STAT_FIELDS = ("steps", "decode_steps", "prefills", "prefill_batches", "max_slots",
               "generated_tokens", "prefix_reuse_active", "paging", "trace_index", "pool_bytes")


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), cache_dtype="float32")
    tcfg = dataclasses.replace(configs.get_smoke_config(ARCH), cache_dtype="float32")
    params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, params, bridge.params_from_numpy(params, "cpu")


def _trace(seed, n=7, vocab=VOCAB):
    """(prompt, n_tokens, arrival) triples: a 17-token shared prefix
    (two full pages of 8) with short unique tails, and plain prompts."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, 17).astype(np.int32)
    out = []
    for i in range(n):
        if i % 3 == 2:
            prompt = rng.integers(0, vocab, 3 + i).astype(np.int32)
        else:
            prompt = np.concatenate([pre, rng.integers(0, vocab, 1 + i).astype(np.int32)])
        out.append((prompt, 2 + (i * 3) % 5, [0, 0, 0, 1, 3, 3, 6][i % 7]))
    return out


def _assert_margins(engine, results):
    logits = engine.teacher_force([r.tokens[:r.prompt_len] for r in results],
                                  [r.generated for r in results])
    for r, lg in zip(results, logits):
        top2 = torch.topk(lg, 2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        assert margin >= MIN_MARGIN, f"rid {r.rid}: near-tie, top-2 margin {margin:.3g}"
        np.testing.assert_array_equal(torch.argmax(lg, dim=-1).numpy(), r.generated)


def _serve_both(model, trace, sched_kw, jsim=None, tsim=None):
    jcfg, tcfg, params, tparams = model
    jsched = JScheduler(jcfg, params, dcim_sim=jsim, **sched_kw)
    tsched = Scheduler(tcfg, tparams, dcim_sim=tsim, **sched_kw)
    jres = jsched.serve([JRequest(prompt=p, n_tokens=n, arrival=a) for p, n, a in trace])
    tres = tsched.serve([Request(prompt=p, n_tokens=n, arrival=a) for p, n, a in trace])
    return jsched, tsched, jres, tres


@pytest.fixture(scope="module")
def served(model):
    return _serve_both(model, _trace(0), dict(max_slots=3, max_len=48, page_size=8))


# --- PagePool ----------------------------------------------------------------------
def test_page_pool_accounting_matches_reference():
    rng = np.random.default_rng(0)
    page = 4
    pools = (JPagePool(14, page), PagePool(14, page))
    prefixes = [rng.integers(0, 50, 13).astype(np.int32) for _ in range(3)]
    live = []               # (pages) of admitted requests, in both pools alike
    for step in range(60):
        if step % 20 == 0:
            for pool in pools:
                pool.begin_trace()
        if live and (rng.random() < 0.4 or len(live) > 3):
            pages = live.pop(int(rng.integers(len(live))))
            for pool in pools:
                pool.release(pages)
        else:
            prompt = np.concatenate([prefixes[int(rng.integers(3))],
                                     rng.integers(0, 50, int(rng.integers(1, 9)))]).astype(np.int32)
            np.testing.assert_array_equal(prefix_page_hashes(prompt, page),
                                          jhashes(prompt, page))
            got = []
            for pool in pools:
                matched, hashes = pool.match_prefix(prompt)
                pool.ref(matched)
                need = -(-prompt.size // page) + 1
                if need - len(matched) > pool.available():
                    pool.unref(matched)
                    got.append((matched, None))
                    continue
                fresh = pool.allocate(need - len(matched))
                pages = matched + fresh
                if len(hashes) > len(matched):
                    pool.register_prefix(hashes[len(matched):], pages[len(matched):len(hashes)],
                                         parent=hashes[len(matched) - 1] if matched else None)
                got.append((matched, pages))
            assert got[0] == got[1]
            if got[1][1] is not None:
                live.append(got[1][1])
        j, t = pools
        assert t.stats.as_dict() == j.stats.as_dict()
        assert (t.available(), t.live_pages) == (j.available(), j.live_pages)
        assert [t.refcount(p) for p in range(14)] == [j.refcount(p) for p in range(14)]
        t.check_conservation()
    assert t.stats.evictions > 0 and t.stats.prefix_hits > 0


# --- Scheduler ---------------------------------------------------------------------
def test_scheduler_tokens_and_stats_match_reference(served):
    jsched, tsched, jres, tres = served
    for j, t in zip(jres, tres):
        assert t.rid == j.rid
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.prompt_len, t.arrival, t.admitted_step, t.finished_step,
                t.prefix_hit_tokens) == (j.prompt_len, j.arrival, j.admitted_step,
                                         j.finished_step, j.prefix_hit_tokens)
    js, ts = jsched.last_stats, tsched.last_stats
    for f in STAT_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.prefix_reuse_active and ts.paging["prefix_hits"] > 0
    assert ts.prefill_batches < ts.prefills            # bursts really batched
    assert len(ts.decode_step_s) == ts.decode_steps
    assert sum(w for w, _, _ in ts.prefill_s) >= ts.prefills


def test_scheduler_matches_engine_per_request(model, served):
    _, tcfg, _, tparams = model
    _, _, _, tres = served
    eng = Engine(tcfg, tparams, max_len=48)
    for r in tres:
        want = eng.generate(r.tokens[None, :r.prompt_len], n_tokens=r.generated.size,
                            request_ids=[r.rid])
        np.testing.assert_array_equal(want.tokens[0], r.tokens)
    _assert_margins(eng, tres)


def test_scheduler_matches_reference_under_int8_dcim_numerics(model):
    """Two prompts of one bucket's length, admitted in one burst: the
    macro's per-tensor activation scale spans the batch, and the Engine's
    teacher forcing then batches them as the Scheduler does."""
    rng = np.random.default_rng(1)
    trace = [(rng.integers(0, VOCAB, 8).astype(np.int32), 3, 0) for _ in range(2)]
    kw = dict(N=64, H=64, L=8, k=4)
    jsched, tsched, jres, tres = _serve_both(model, trace, dict(max_slots=2, max_len=32,
                                                                 page_size=8),
                                             JSim(jget("int8"), **kw), TSim(tget("int8"), **kw))
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
    assert tsched.last_stats.prefill_batches == jsched.last_stats.prefill_batches
    _assert_margins(Engine(model[1], model[3], max_len=32, dcim_sim=TSim(tget("int8"), **kw)),
                    tres)


def test_scheduler_matches_reference_under_fp8_dcim_numerics(model):
    """The macro's floating-point path (K3's pre-alignment, then K2 over
    every group) in every projection: an fp8 design gives the JAX
    Scheduler's tokens and counters under the same fp8 macro."""
    rng = np.random.default_rng(1)
    trace = [(rng.integers(0, VOCAB, 8).astype(np.int32), 3, 0) for _ in range(2)]
    kw = dict(N=64, H=16, L=8, k=4)
    jsched, tsched, jres, tres = _serve_both(model, trace, dict(max_slots=2, max_len=32,
                                                                 page_size=8),
                                             JSim(jget("fp8"), **kw), TSim(tget("fp8"), **kw))
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
    for f in STAT_FIELDS:
        assert getattr(tsched.last_stats, f) == getattr(jsched.last_stats, f), f
    _assert_margins(Engine(model[1], model[3], max_len=32, dcim_sim=TSim(tget("fp8"), **kw)),
                    tres)


def test_admission_errors(model):
    _, tcfg, _, tparams = model
    sched = Scheduler(tcfg, tparams, max_slots=2, max_len=32)
    rng = np.random.default_rng(2)
    bad = Request(prompt=rng.integers(0, VOCAB, 30).astype(np.int32), n_tokens=8)
    with pytest.raises(ValueError, match="max_len 32"):
        sched.serve([bad])
    ok = Request(prompt=bad.prompt[:4], n_tokens=28)      # prompt + n_tokens == max_len
    assert sched.serve([ok])[0].tokens.size == 32
    p = rng.integers(0, VOCAB, 4).astype(np.int32)
    with pytest.raises(ValueError, match="duplicate"):
        sched.serve([Request(prompt=p, n_tokens=2, rid=1), Request(prompt=p, n_tokens=2)])
    with pytest.raises(ValueError):
        sched.serve([Request(prompt=p, n_tokens=0)])
    assert sched.session().idle and not sched.session()._live_rids


def test_eos_retires_early_and_frees_the_slot(model, served):
    _, tcfg, _, tparams = model
    _, _, _, tres = served
    r = max(tres, key=lambda r: r.generated.size)
    eos = int(r.generated[1])
    sched = Scheduler(tcfg, tparams, max_slots=1, max_len=48, page_size=8, eos_id=eos)
    out = sched.serve([Request(prompt=r.tokens[:r.prompt_len], n_tokens=r.generated.size),
                       Request(prompt=r.tokens[:3], n_tokens=2)])
    first = list(r.generated).index(eos)
    np.testing.assert_array_equal(out[0].generated, r.generated[:first + 1])
    assert out[1].generated.size == 2
    assert sched.session().ppool.live_pages == 0


def test_idle_gap_jumps_to_next_arrival(model):
    _, tcfg, _, tparams = model
    sched = Scheduler(tcfg, tparams, max_slots=1, max_len=32)
    rng = np.random.default_rng(14)
    r0, r1 = sched.serve([Request(prompt=rng.integers(0, VOCAB, 4).astype(np.int32),
                                  n_tokens=2, arrival=a) for a in (0, 10_000_000)])
    assert r1.admitted_step == 10_000_000
    assert sched.last_stats.decode_steps == 2


def test_sampled_stream_depends_only_on_seed_rid_step(model):
    """The same sampled requests, served with their arrivals permuted (so
    other slots, bursts and batch widths), give the same tokens."""
    _, tcfg, _, tparams = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, n).astype(np.int32) for n in (3, 9, 5, 12)]
    tokens = []
    for arrivals in ([0, 0, 0, 0], [2, 0, 1, 0], [0, 3, 3, 1]):
        sched = Scheduler(tcfg, tparams, max_slots=2, max_len=32, page_size=8, seed=7)
        res = sched.serve([Request(prompt=p, n_tokens=6, temperature=0.8, rid=10 + i,
                                   arrival=a) for i, (p, a) in enumerate(zip(prompts, arrivals))])
        tokens.append([r.tokens for r in res])
    for other in tokens[1:]:
        for a, b in zip(tokens[0], other):
            np.testing.assert_array_equal(a, b)
    greedy = Scheduler(tcfg, tparams, max_slots=2, max_len=32, page_size=8, seed=7).serve(
        [Request(prompt=p, n_tokens=6, rid=10 + i) for i, p in enumerate(prompts)])
    assert any(not np.array_equal(a, g.tokens) for a, g in zip(tokens[0], greedy))


# --- the SSM family -------------------------------------------------------------------
SSM_ARCH = "falcon-mamba-7b"


@pytest.fixture(scope="module")
def ssm_model():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(SSM_ARCH), cache_dtype="float32")
    tcfg = dataclasses.replace(configs.get_smoke_config(SSM_ARCH), cache_dtype="float32")
    params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, params, bridge.params_from_numpy(params, "cpu")


@pytest.fixture(scope="module")
def ssm_served(ssm_model):
    return _serve_both(ssm_model, _trace(0, vocab=ssm_model[0].vocab_size),
                       dict(max_slots=3, max_len=48, page_size=8))


def test_ssm_scheduler_tokens_and_stats_match_reference(ssm_model, ssm_served):
    jsched, tsched, jres, tres = ssm_served
    for j, t in zip(jres, tres):
        assert t.rid == j.rid
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.admitted_step, t.finished_step) == (j.admitted_step, j.finished_step)
    js, ts = jsched.last_stats, tsched.last_stats
    for f in STAT_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.prefill_batches < ts.prefills            # bursts really batched
    _assert_margins(Engine(ssm_model[1], ssm_model[3], max_len=48), tres)


def test_ssm_prefix_reuse_gated_off(ssm_served):
    """The repair: a float32 cache over float32 compute passes the dtype
    term of the gate, so only the SSM term keeps reuse off."""
    jsched, tsched, jres, tres = ssm_served
    assert tsched.cfg.cache_dtype == tsched.cfg.compute_dtype
    assert tsched.prefix_reuse_active is False and jsched.prefix_reuse_active is False
    assert tsched.last_stats.prefix_reuse_active is False
    assert [r.prefix_hit_tokens for r in tres] == [0] * len(tres)
    assert [r.prefix_hit_tokens for r in jres] == [0] * len(jres)
    assert tsched.last_stats.paging["prefix_hits"] == 0


def test_ssm_scheduler_matches_reference_under_int8_dcim_numerics(ssm_model):
    rng = np.random.default_rng(1)
    trace = [(rng.integers(0, ssm_model[0].vocab_size, 8).astype(np.int32), 3, 0)
             for _ in range(2)]
    kw = dict(N=64, H=64, L=8, k=4)
    jsched, tsched, jres, tres = _serve_both(ssm_model, trace, dict(max_slots=2, max_len=32,
                                                                     page_size=8),
                                             JSim(jget("int8"), **kw), TSim(tget("int8"), **kw))
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
    for f in STAT_FIELDS:
        assert getattr(tsched.last_stats, f) == getattr(jsched.last_stats, f), f
    _assert_margins(Engine(ssm_model[1], ssm_model[3], max_len=32,
                           dcim_sim=TSim(tget("int8"), **kw)), tres)


# --- the MLA + MoE family, and jamba ----------------------------------------------------
MLA_ARCH = "deepseek-v3-671b"


def _family_model(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), cache_dtype="float32",
                               attn_backend="xla")
    tcfg = dataclasses.replace(configs.get_smoke_config(arch), cache_dtype="float32")
    params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, params, bridge.params_from_numpy(params, "cpu")


@pytest.fixture(scope="module")
def mla_model():
    return _family_model(MLA_ARCH)


def _assert_same_serve(model, served, reuse: bool):
    jsched, tsched, jres, tres = served
    for j, t in zip(jres, tres):
        assert t.rid == j.rid
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.admitted_step, t.finished_step, t.prefix_hit_tokens) == (
            j.admitted_step, j.finished_step, j.prefix_hit_tokens)
    for f in STAT_FIELDS:
        assert getattr(tsched.last_stats, f) == getattr(jsched.last_stats, f), f
    assert tsched.last_stats.prefix_reuse_active is reuse
    assert (tsched.last_stats.paging["prefix_hits"] > 0) is reuse
    _assert_margins(Engine(model[1], model[3], max_len=48), tres)


def test_mla_scheduler_tokens_and_stats_match_reference(mla_model):
    served = _serve_both(mla_model, _trace(0), dict(max_slots=3, max_len=48, page_size=8))
    _assert_same_serve(mla_model, served, reuse=True)
    assert sum(r.prefix_hit_tokens for r in served[3]) > 0
    assert served[1].last_stats.prefill_batches < served[1].last_stats.prefills


def test_mla_scheduler_matches_reference_under_int8_dcim_numerics(mla_model):
    rng = np.random.default_rng(1)
    trace = [(rng.integers(0, VOCAB, 8).astype(np.int32), 3, 0) for _ in range(2)]
    kw = dict(N=64, H=64, L=8, k=4)
    jsched, tsched, jres, tres = _serve_both(mla_model, trace, dict(max_slots=2, max_len=32,
                                                                     page_size=8),
                                             JSim(jget("int8"), **kw), TSim(tget("int8"), **kw))
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, j.tokens)
    for f in STAT_FIELDS:
        assert getattr(tsched.last_stats, f) == getattr(jsched.last_stats, f), f
    _assert_margins(Engine(mla_model[1], mla_model[3], max_len=32,
                           dcim_sim=TSim(tget("int8"), **kw)), tres)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mistral-nemo-12b", "qwen2.5-14b"])
def test_dense_families_scheduler_matches_reference(arch):
    model = _family_model(arch)
    served = _serve_both(model, _trace(0), dict(max_slots=3, max_len=48, page_size=8))
    _assert_same_serve(model, served, reuse=True)
    assert sum(r.prefix_hit_tokens for r in served[3]) > 0
    assert served[1].last_stats.prefill_batches < served[1].last_stats.prefills


def test_jamba_scheduler_matches_reference_with_reuse_gated_off():
    model = _family_model("jamba-v0.1-52b")
    served = _serve_both(model, _trace(0), dict(max_slots=3, max_len=48, page_size=8))
    _assert_same_serve(model, served, reuse=False)
    assert [r.prefix_hit_tokens for r in served[3]] == [0] * len(served[3])
