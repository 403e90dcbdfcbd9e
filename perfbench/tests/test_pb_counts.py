"""The benchmark's counts against ``torch.utils.flop_counter`` on the plain
reference at small widths."""
import json
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import DATA
from harness import counts, spec, weights
from reference import mamba1, qwen2

aten = torch.ops.aten


def _params(name):
    config = json.loads((DATA / name).read_text())
    return config, spec.widths(config), weights.by_path(
        weights.draw(spec.program_config(config), 3, "cpu"))


def _flops(fn, custom=None) -> int:
    with FlopCounterMode(display=False, custom_mapping=custom or {}) as fc:
        fn()
    return fc.get_total_flops()


def test_gqa_forward_flops():
    config, w, P = _params("qwen-small.json")
    S = 24                                        # one query block: the reference scores S x S
    toks = torch.randint(0, w["vocab"], (S,))
    got = _flops(lambda: qwen2.logits_at(P, w, toks, range(S)))
    assert got == counts.forward_flops(w, S, S * S, S)


def test_gqa_train_step_is_three_forwards_of_causal_pairs():
    _, w, _ = _params("qwen-small.json")
    B, S = 2, 8
    fwd = counts.forward_flops(w, B * S, B * counts.causal_pairs(S), B * S)
    assert counts.train_step_flops(w, B, S) == 3 * fwd
    assert counts.causal_pairs(S) == S * (S + 1) // 2


def test_mamba_forward_flops():
    config, w, P = _params("mamba-small.json")
    S = 20
    toks = torch.randint(0, w["vocab"], (S,))
    got = _flops(lambda: mamba1.logits_at(P, w, toks, range(S)))
    # The counter sees the products and the scan's C.h contraction; the
    # count also holds the conv and the rest of the recurrence.
    contraction = 2 * w["d_inner"] * w["d_state"] * w["layers"] * S
    assert got == S * counts.dense_flops_per_token(w) + S * counts.head_flops(w) + contraction
    rest = S * counts.scan_flops_per_token(w) - contraction
    assert rest == S * w["layers"] * w["d_inner"] * (2 * w["d_conv"] + 5 * w["d_state"] + 3)


def _prefix_attention(q, k, v, ctx):
    """Query i of the tail attends the context and tail keys 0..i, one
    query at a time (so the counter sees exactly the causal pairs)."""
    T = q.shape[0]
    out = []
    for i in range(T):
        kk, vv = k[:ctx + i + 1], v[:ctx + i + 1]
        s = torch.einsum("hd,khd->hk", q[i], kk) / math.sqrt(q.shape[-1])
        out.append(torch.einsum("hk,khd->hd", torch.softmax(s, -1), vv))
    return torch.stack(out)


def test_k5_launch_flops():
    w = {"heads": 4, "kv_heads": 4, "head_dim": 8}
    rows = [(5, 1), (3, 7), (1, 2)]      # (an einsum over one key is no product)
    got = 0
    for tail, ctx in rows:
        q = torch.randn(tail, 4, 8)
        k, v = torch.randn(ctx + tail, 4, 8), torch.randn(ctx + tail, 4, 8)
        got += _flops(lambda: _prefix_attention(q, k, v, ctx))
    flops, nbytes = counts.k5_launch(w, rows)
    assert got == flops
    # bf16 q, K, V read once, float32 out written once, ctx_len read.
    assert nbytes == sum(t * 32 * 2 + 2 * (t + c) * 32 * 2 + t * 32 * 4 + 4 for t, c in rows)


def _elementwise(*args, out_shape=None, **kw):
    return math.prod(out_shape)


def _reduce(*args, out_shape=None, **kw):
    return math.prod(args[0])


def test_k7_launch_flops():
    D, N, S = 6, 4, 9
    u, dt = torch.randn(S, D), torch.rand(S, D)
    B, C, A, Dsk = torch.randn(S, N), torch.randn(S, N), -torch.rand(D, N), torch.randn(D)

    def scan():
        h = torch.zeros(D, N)
        for t in range(S):
            dtu = dt[t] * u[t]
            dA = torch.exp(dt[t][:, None] * A)
            h = dA * h + dtu[:, None] * B[t][None, :]
            y = (h * C[t][None, :]).sum(-1) + Dsk * u[t]
        return y

    custom = {aten.mul: _elementwise, aten.add: _elementwise, aten.exp: _elementwise,
              aten.sum: _reduce}
    flops, nbytes = counts.k7_launch({"d_inner": D, "d_state": N}, [S])
    assert _flops(scan, custom) == flops
    assert nbytes == S * (D * 10 + 2 * N * 4) + 2 * D * N * 4 + D * 4


def test_bound_is_the_slower_of_operations_and_bytes():
    from harness import peaks

    assert counts.bound_s(989e12, 0, peaks.BF16_FLOPS) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 3.35e12, peaks.BF16_FLOPS) == pytest.approx(1.0)
