"""The serving session's captured decode step (``serve.decode_graph``).

On the CPU: which sessions the eligibility rule admits (read from the
scheduler alone, so it needs no card: a CPU scheduler is told it sits on
the card), the storage key a session captures again on, and that a CPU
session captures nothing and serves the tokens it served before.

On the card (``-m gpu``, small widths, bf16): one trace with admissions,
retirements, a chunk-filling slot and a sampled request, served by a
captured session and by an eager one (a routing hook installed, which
the rule leaves eager), then a second trace on the same sessions; the
tokens, and the logits of every row a token is kept from, are bitwise
equal, the captured
session captures once and replays every decode step but its first, and
the attention kernels' launch counts equal the eager run's.  Once per
mixer kind the rule admits: GQA, MLA, Mamba.
"""
import contextlib
import dataclasses
import sys

import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro_torch import configs
from repro_torch.kernels import cuda_lib
from repro_torch.models import lm, moe
from repro_torch.serve import Engine, Request, Scheduler
from repro_torch.serve import decode_graph
from repro_torch.serve import scheduler as scheduler_mod


def _params(cfg, device="cpu"):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return lm.init(cfg, gen, device)


def _no_routing(ids, positions, layer, idx):
    return None


@pytest.fixture(scope="module")
def qwen():
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2.5-3b"), cache_dtype="float32")
    return cfg, _params(cfg)


def _on_card(sched):
    """The scheduler as the rule sees it on the card (nothing runs)."""
    sched.device = torch.device("cuda", 0)
    return sched


def test_float_gqa_paged_session_on_the_card_is_eligible(qwen):
    assert decode_graph.eligible(_on_card(Scheduler(*qwen, max_slots=2, max_len=32,
                                                    page_size=8)))


@pytest.mark.parametrize("case", ["cpu params", "dcim_sim", "tp", "mesh", "moe layer",
                                  "routing hook", "paged=False"])
def test_eligibility_rule_leaves_these_sessions_eager(qwen, case):
    cfg, params = qwen
    kw = {"max_slots": 2, "max_len": 32, "page_size": 8}
    if case == "dcim_sim":
        kw["dcim_sim"] = object()           # the rule reads only that one is attached
    elif case == "tp":
        kw["tp"] = 1
    elif case == "mesh":
        kw["mesh"] = {"model": 1}
    elif case == "paged=False":
        kw["paged"] = False
    elif case == "moe layer":
        cfg = configs.get_smoke_config("moonshot-v1-16b-a3b")
        params = _params(cfg)
    sched = Scheduler(cfg, params, **kw)
    if case != "cpu params":
        _on_card(sched)
    if case == "routing hook":
        assert decode_graph.eligible(sched)
        with moe.routing(_no_routing):
            assert not decode_graph.eligible(sched)
        assert decode_graph.eligible(sched)
    else:
        assert not decode_graph.eligible(sched)


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "falcon-mamba-7b"])
def test_mla_and_mamba_layers_follow_the_mixer_list(name):
    cfg = configs.get_smoke_config(name)
    if cfg.ffn_kind == "moe":
        cfg = dataclasses.replace(cfg, ffn_kind="dense")
    kind = cfg.mixer_kind(0)
    sched = _on_card(Scheduler(cfg, _params(cfg), max_slots=2, max_len=32, page_size=8))
    assert decode_graph.eligible(sched) == (kind in decode_graph.GRAPH_MIXERS)


def test_storage_key_follows_the_pool_and_the_params(qwen):
    cfg, params = qwen
    sess = Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8).session()
    key = decode_graph.storage_key(params, sess.pool)
    assert key == decode_graph.storage_key(params, sess.pool)
    moved = [{k: v.clone() for k, v in leaves.items()} for leaves in sess.pool]
    assert decode_graph.storage_key(params, moved) != key
    params2 = dict(params, ln_f={k: v.clone() for k, v in params["ln_f"].items()})
    assert decode_graph.storage_key(params2, sess.pool) != key


def _trace(vocab, temperature=0.0, rid0=0):
    """Five requests over three slots: staggered arrivals, retirements
    at different steps, a 20-token prompt that chunk-fills (chunks of 8)
    while others decode, and request 1 sampled at ``temperature``."""
    rng = np.random.default_rng(rid0 + 7)
    spec = [(5, 6, 0), (12, 3, 0), (20, 4, 1), (7, 5, 2), (9, 2, 3)]
    return [Request(prompt=rng.integers(1, vocab, p).astype(np.int32), n_tokens=n,
                    arrival=a, rid=rid0 + i, temperature=temperature if i == 1 else 0.0)
            for i, (p, n, a) in enumerate(spec)]


def test_cpu_session_captures_nothing_and_serves_todays_tokens(qwen):
    cfg, params = qwen
    sess = Scheduler(cfg, params, max_slots=3, max_len=48, page_size=8,
                     prefill_chunk=8).session()
    eng = Engine(cfg, params, max_len=48)
    for rid0 in (0, 10):
        reqs = _trace(cfg.vocab_size, rid0=rid0)
        results = sess.serve(reqs)
        stats = sess.last_stats
        assert (stats.decode_graph_captures, stats.decode_graph_replays) == (0, 0)
        assert stats.decode_steps > 0 and stats.prefill_chunks > 0
        for req, res in zip(reqs, results):
            want = eng.generate(req.prompt[None], n_tokens=req.n_tokens).tokens[0]
            np.testing.assert_array_equal(res.tokens, want)
    assert sess._graph is None


# ------------------------------- on the card ----------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels run only there)")
    return torch.device("cuda", 0)


def _card_config(name):
    cfg = configs.get_smoke_config(name)
    if cfg.ffn_kind == "moe":
        cfg = dataclasses.replace(cfg, ffn_kind="dense")
    return dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16",
                               cache_dtype="bfloat16")


def _serve_two_traces(cfg, params, monkeypatch, eager: bool):
    """Two traces through one fresh session: (tokens by rid, the logits
    every sampling read, in order, each trace's ServeStats, launches).
    Of a decode step only the active slots' rows are kept: an inactive
    slot decodes junk over the garbage page, which every inactive slot
    writes at once (which write lands is not fixed), and its token is
    dropped."""
    logits_seen = []
    real = scheduler_mod.sample_tokens

    def spy(logits, *args):
        rows = slice(None)
        if sys._getframe(1).f_code.co_name in ("_decode_paged_fn", "_decode_graphed"):
            rows = torch.as_tensor(sess.active)
        logits_seen.append(logits.detach().cpu()[rows].clone())
        return real(logits, *args)

    monkeypatch.setattr(scheduler_mod, "sample_tokens", spy)
    sess = Scheduler(cfg, params, max_slots=3, max_len=48, page_size=8,
                     prefill_chunk=8).session()
    cuda_lib.reset_launches()
    tokens, stats = {}, []
    with moe.routing(_no_routing) if eager else contextlib.nullcontext():
        assert decode_graph.eligible(sess.s) != eager
        for rid0 in (0, 10):
            for res in sess.serve(_trace(cfg.vocab_size, temperature=0.8, rid0=rid0)):
                tokens[res.rid] = res.tokens.tolist()
            stats.append(sess.last_stats)
    monkeypatch.setattr(scheduler_mod, "sample_tokens", real)
    return tokens, logits_seen, stats, dict(cuda_lib.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kernel", [("qwen2.5-3b", "paged_decode_gqa"),
                                         ("deepseek-v3-671b", "paged_decode_mla"),
                                         ("falcon-mamba-7b", "selective_scan")])
def test_captured_decode_equals_eager_bitwise(cuda_device, monkeypatch, name, kernel):
    cfg = _card_config(name)
    assert cfg.mixer_kind(0) in decode_graph.GRAPH_MIXERS
    params = _params(cfg, cuda_device)
    e_tok, e_logits, e_stats, e_launch = _serve_two_traces(cfg, params, monkeypatch, True)
    g_tok, g_logits, g_stats, g_launch = _serve_two_traces(cfg, params, monkeypatch, False)
    assert g_tok == e_tok
    assert len(g_logits) == len(e_logits)
    for i, (g, e) in enumerate(zip(g_logits, e_logits)):
        assert torch.equal(g, e), f"logits of sampling call {i} differ"
    assert sum(s.decode_graph_captures for s in e_stats) == 0
    assert sum(s.decode_graph_replays for s in e_stats) == 0
    assert sum(s.decode_graph_captures for s in g_stats) == 1
    steps = sum(s.decode_steps for s in g_stats)
    assert steps == sum(s.decode_steps for s in e_stats)
    assert sum(s.decode_graph_replays for s in g_stats) == steps - 1
    assert g_stats[0].prefill_chunks == e_stats[0].prefill_chunks
    for k in (kernel, kernel + ("_bf16u" if kernel == "selective_scan" else "_mma")):
        assert g_launch[k] == e_launch[k], k
    assert g_launch[kernel] > 0
