"""The MoE routing hook (``moe.routing`` / ``moe.label_rows``) and the
smoke's ``RoutingTrace``, which holds jamba's top-2 serve to the Engine
with the Engine on the experts the served path chose.

On the CPU, in float32, the served path and the Engine route alike; in
bf16 over ``SERVE_FULL``'s trace the smoke jamba's two paths pick other
experts at a few router near-ties, and the Mamba state carries each into
later positions: the Engine's own routing then parts from the served
tokens by more than the Engine on the replayed routing does, which stays
within ``SSM_SERVE_DELTA``.  No tolerance is loosened here: every comparison is either bitwise
or the smoke's own delta.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the PyTorch port's tests need torch")

from repro_torch import configs, smoke  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

JAMBA = "jamba-v0.1-52b"


def _jamba(dtype: str):
    cfg = configs.get_smoke_config(JAMBA)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, param_dtype=dtype, cache_dtype=dtype)
    params, _ = smoke._draw_params("routing", JAMBA, cfg, torch.device("cpu"))
    return cfg, params


def _layer():
    cfg = configs.get_smoke_config(JAMBA)
    gen = torch.Generator().manual_seed(0)
    return cfg, moe.moe_init(gen, cfg, torch.float32, "cpu")


def test_route_takes_the_hooks_experts_and_their_router_probabilities():
    cfg, p = _layer()
    xt = torch.from_numpy(np.random.default_rng(0).standard_normal((6, cfg.d_model),
                                                                   dtype=np.float32))
    probs, _, idx = moe.route(p, xt, cfg)
    forced = torch.flip(idx, dims=[1]).roll(1, dims=0)
    seen = []

    def hook(ids, pos, layer, got):
        seen.append((ids.tolist(), pos.tolist(), layer, got.clone()))
        return forced

    labels = ([7, -1], [[0, 1, 2], [3, 4, 5]])
    with moe.routing(hook):
        moe.route(p, xt, cfg)                        # no labels: the hook is not called
        with moe.label_rows(*labels):
            _, gates, got = moe.route(p, xt, cfg)
            moe.route(p, xt, cfg)
    assert [s[:3] for s in seen] == [(*labels, 0), (*labels, 1)]
    assert torch.equal(seen[0][3], idx)
    assert torch.equal(got, forced)
    want = probs.gather(1, forced)
    assert torch.equal(gates, want / want.sum(dim=-1, keepdim=True).clamp_min(1e-9))
    assert moe._ROUTING is None and moe._LABELS is None
    with moe.label_rows(*labels):                    # no hook: labels are not kept
        assert moe._LABELS is None


def test_lone_token_takes_the_forced_experts_in_its_copy_too():
    cfg, p = _layer()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 1, cfg.d_model),
                                                                  dtype=np.float32))
    y0, _ = moe.moe_apply(p, x, cfg)
    _, _, own = moe.route(p, x.reshape(1, -1), cfg)
    other = torch.tensor([[e for e in range(cfg.moe.n_experts)
                           if e not in own[0].tolist()][:cfg.moe.top_k]])
    with moe.routing(lambda ids, pos, layer, idx: other), moe.label_rows([0], [[5]]):
        y1, _ = moe.moe_apply(p, x, cfg)
    with moe.routing(lambda ids, pos, layer, idx: own), moe.label_rows([0], [[5]]):
        y2, _ = moe.moe_apply(p, x, cfg)
    assert torch.equal(y2, y0) and not torch.equal(y1, y0)


def _served(cfg, params, sizes):
    reqs = smoke.serve_trace(sizes, cfg.vocab_size)
    trace = smoke.RoutingTrace()
    ecfg = dataclasses.replace(cfg, ssm_impl="assoc")
    chk = smoke._serve_and_check("routing", cfg, params, sizes, reqs, None, engine_cfg=ecfg,
                                 trace=trace)
    return chk, trace, ecfg


def test_replay_covers_every_engine_token_and_a_wrong_map_is_seen():
    """float32: the two paths route alike, so the replay changes nothing;
    every Engine token-layer finds the served path's choice under the
    request's id; handing the Engine another request's routing changes
    experts and logits."""
    cfg, params = _jamba("float32")
    sizes = smoke.SERVE_SMOKE
    chk, trace, ecfg = _served(cfg, params, sizes)
    n_moe = len({layer for _, _, layer, _ in trace._calls})
    tokens = sum(r.prompt_len + r.generated.size - 1 for r in chk.results)
    assert n_moe > 0 and trace.missing == 0 and trace.differ == 0
    assert trace.replayed == n_moe * tokens
    own = smoke._hold_to_engine("own", ecfg, params, sizes.max_len, chk.results, chk.stats, 0,
                                {}, None)
    assert chk.worst_gap == own.worst_gap == 0.0

    eng = Engine(ecfg, params, max_len=sizes.max_len)
    args = ([r.tokens[:r.prompt_len] for r in chk.results], [r.generated for r in chk.results])
    plain = eng.teacher_force(*args)
    rids = [r.rid for r in chk.results]
    shifted = smoke.RoutingTrace()
    shifted._calls = trace._calls
    with moe.routing(shifted.replay(rids[1:] + rids[:1])):
        wrong = eng.teacher_force(*args)
    assert shifted.differ > 0
    assert any(not torch.equal(a, b) for a, b in zip(plain, wrong))


def test_bf16_top2_serve_held_once_the_engine_takes_the_served_experts():
    cfg, params = _jamba("bfloat16")
    sizes = smoke.SERVE_FULL
    chk, trace, ecfg = _served(cfg, params, sizes)
    own = smoke._hold_to_engine("own", ecfg, params, sizes.max_len, chk.results, chk.stats, 0,
                                {}, None)
    delta = smoke.SSM_SERVE_DELTA["bfloat16"]
    assert trace.missing == 0 and trace.differ > 0
    assert chk.worst_gap <= delta
    assert own.worst_gap > chk.worst_gap
