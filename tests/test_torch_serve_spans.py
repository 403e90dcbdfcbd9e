"""The serving scheduler's profiler spans and wall-clock stamps, on the CPU.

A tiny Scheduler, pumped by its background thread (``start()``), under
the profiler the benchmark traces with (host activity on every thread):
each of the eight ``serve.*`` spans appears, every program launch and
sync lies inside a tick, ticks never overlap, and the launch spans count
the programs ``ServeStats`` counts.  Without a profiler ``span()`` is
the shared no-op; greedy tokens do not change under the profiler.  Each
``RequestResult`` carries its admission and first-token times on the
clock of ``finished_wall_s``.
"""
import dataclasses
import threading

import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro_torch import configs, spans
from repro_torch.models import lm
from repro_torch.serve import Request, Scheduler

SPANS = ("serve.tick", "serve.admit", "serve.prefill.launch", "serve.prefill.sync",
         "serve.decode.launch", "serve.decode.sync", "serve.emit", "serve.submit")
TIMEOUT = 120
# (paged, prefill_chunk): burst prefill, chunk advances, the monolithic path
MODES = {"paged": (True, None), "chunked": (True, 8), "legacy": (False, None)}


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2.5-3b"), cache_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, lm.init(cfg, gen, "cpu")


def _profiler():
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _requests(n=5):
    rng = np.random.default_rng(3)
    return [Request(prompt=rng.integers(1, 500, int(rng.integers(5, 20))).astype(np.int32),
                    n_tokens=int(rng.integers(2, 6)), rid=i) for i in range(n)]


def _pumped(model, mode, prof=None):
    """Five requests on two slots, all submitted, then pumped to the end:
    (results by rid, the trace's ServeStats, the tokens each on_token saw)."""
    cfg, params = model
    paged, chunk = MODES[mode]
    sess = Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8, paged=paged,
                     prefill_chunk=chunk).session()
    seen = {}
    if prof is not None:
        prof.start()
    try:
        handles = [sess.submit(r, on_token=lambda h, t: seen.setdefault(h.rid, []).append(t))
                   for r in _requests()]
        sess.start()
        results = {h.rid: h.wait(timeout=TIMEOUT) for h in handles}
        sess.stop()
    finally:
        if prof is not None:
            prof.stop()
    return results, sess.last_stats, seen


def _spans(prof):
    """name -> [(thread, start_us, end_us)] of the serve spans recorded."""
    out = {n: [] for n in SPANS}
    for e in prof.events():
        if e.name in out:
            out[e.name].append((e.thread, e.time_range.start, e.time_range.end))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_spans_nest_and_count_programs(model, mode):
    prof = _profiler()
    results, stats, _ = _pumped(model, mode, prof)
    got = _spans(prof)
    assert [n for n in SPANS if not got[n]] == []
    ticks = sorted(got["serve.tick"], key=lambda s: s[1])
    assert all(a[2] <= b[1] for a, b in zip(ticks, ticks[1:])), "ticks overlap"
    for name in SPANS[1:6]:
        for thread, a, b in got[name]:
            assert any(t == thread and ta <= a and b <= tb for t, ta, tb in ticks), \
                f"a {name} span outside every tick"
    assert len(got["serve.decode.launch"]) == stats.decode_steps
    assert len(got["serve.decode.sync"]) == stats.decode_steps
    assert len(got["serve.prefill.launch"]) == stats.prefill_batches
    assert len(got["serve.prefill.sync"]) == stats.prefill_batches
    assert len(got["serve.submit"]) == len(results)
    # The submissions ran on this thread, the ticks on the pump's.
    assert {t for t, _, _ in got["serve.submit"]} != {t for t, _, _ in ticks}


def test_span_is_the_shared_no_op_without_a_profiler():
    assert spans.span("serve.tick") is spans._NULL
    assert spans.span("serve.decode.launch") is spans.span("train_optimizer")
    with spans.span("serve.tick") as inside:
        assert inside is None
    prof = _profiler()
    prof.start()
    try:
        on_main = spans.span("serve.tick")
        box = []
        t = threading.Thread(target=lambda: box.append(spans.span("serve.tick")))
        t.start()
        t.join(timeout=TIMEOUT)
    finally:
        prof.stop()
    assert on_main is not spans._NULL and box[0] is not spans._NULL
    assert spans.span("serve.tick") is spans._NULL


@pytest.mark.parametrize("mode", ["paged", "legacy"])
def test_greedy_tokens_equal_with_and_without_the_profiler(model, mode):
    plain, stats, seen = _pumped(model, mode)
    traced, tstats, tseen = _pumped(model, mode, _profiler())
    assert {r: np.asarray(v.tokens).tolist() for r, v in plain.items()} == \
        {r: np.asarray(v.tokens).tolist() for r, v in traced.items()}
    assert seen == tseen
    assert (stats.decode_steps, stats.prefill_batches) == \
        (tstats.decode_steps, tstats.prefill_batches)


@pytest.mark.parametrize("mode", list(MODES))
def test_wall_stamps_order_and_queueing(model, mode):
    results, _, _ = _pumped(model, mode)
    for r in results.values():
        assert 0.0 <= r.admitted_wall_s <= r.first_token_wall_s <= r.finished_wall_s
    # Two slots: requests 0 and 1 are seated by the first tick's
    # programs, request 4 only once both of them have retired.
    first = max(results[0].admitted_wall_s, results[1].admitted_wall_s)
    assert results[4].admitted_wall_s > first
    assert results[4].admitted_wall_s >= min(results[0].finished_wall_s,
                                             results[1].finished_wall_s)
