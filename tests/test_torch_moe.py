"""The port's MoE FFN (drop-free inference, and the training path's
capacity dispatch) against the JAX reference, on the CPU.

The reference's own ``moe_init`` parameters (deepseek-v3 smoke: 8
experts, top-2, one shared expert; and the same without the shared
expert) are carried across by ``bridge.params_from_numpy``, the tokens
drawn from a numpy seed, and both packages run ``moe_apply(training=
False)`` at S = 1 (decode) and S > 1 (prefill).  The routed experts'
indices are equal (``route`` against ``jax.lax.top_k`` of the reference's
router), and the outputs and the aux loss agree to RTOL = ATOL = 1e-5:
both sides compute in float32, in different summation orders (XLA's
einsums against torch's batched products).  In the port a token served
alone gives the bits it gives inside a batch, and the chunking of the
tokens changes nothing beyond summation order.  The router and the shared
expert go through the ``set_mvm_impl`` hook; the expert products do not,
as in the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch import bridge, configs
from repro_torch.models import common, moe

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v3-671b"


def _cfgs(n_shared):
    jcfg, tcfg = jconfigs.get_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, n_shared=n_shared)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, n_shared=n_shared)))


@pytest.fixture(scope="module", params=[1, 0], ids=["shared", "no_shared"])
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    params = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(3), jcfg, jnp.float32))
    return jcfg, tcfg, params, bridge.params_from_numpy(params, "cpu")


def _tokens(seed, B, S, D):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


@pytest.mark.parametrize("B,S", [(4, 1), (3, 7)])
def test_moe_apply_matches_reference(model, B, S):
    jcfg, tcfg, params, tparams = model
    x = _tokens(B * 10 + S, B, S, jcfg.d_model)
    jy, jaux = jmoe.moe_apply(params, jnp.asarray(x), jcfg, training=False)
    ty, taux = moe.moe_apply(tparams, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    # The routed experts: the reference's router, softmax and top-k.
    xt = x.reshape(B * S, -1)
    jprobs = jax.nn.softmax(jcommon.dense(params["router"], jnp.asarray(xt)), axis=-1)
    jgates, jidx = jax.lax.top_k(jprobs, jcfg.moe.top_k)
    _, tgates, tidx = moe.route(tparams, torch.from_numpy(xt), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tgates.numpy(),
                               np.asarray(jgates / jgates.sum(-1, keepdims=True)), **TOL)


@pytest.mark.parametrize("S", [1, 5])
def test_a_row_alone_matches_the_row_in_a_batch_bitwise(model, S):
    _, tcfg, _, tparams = model
    x = torch.from_numpy(_tokens(7 + S, 4, S, tcfg.d_model))
    y, _ = moe.moe_apply(tparams, x, tcfg)
    for b in range(4):
        alone, _ = moe.moe_apply(tparams, x[b:b + 1], tcfg)
        assert torch.equal(alone[0], y[b])


def test_token_chunks_change_nothing(model, monkeypatch):
    _, tcfg, _, tparams = model
    x = torch.from_numpy(_tokens(11, 2, 9, tcfg.d_model))
    y, _ = moe.moe_apply(tparams, x, tcfg)
    per_token = tcfg.moe.n_experts * (2 * tcfg.moe.d_ff + tcfg.d_model) * 4
    for t in (2, 5, 17):
        monkeypatch.setattr(moe, "CHUNK_BYTES", t * per_token)
        yc, _ = moe.moe_apply(tparams, x, tcfg)
        np.testing.assert_allclose(yc.numpy(), y.numpy(), rtol=1e-6, atol=1e-6)


def test_hook_sees_router_and_shared_expert_only():
    _, tcfg = _cfgs(1)
    p = moe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu")
    seen = []

    def hook(x, w):
        seen.append((x.dtype, tuple(w.shape)))
        return torch.matmul(x, w)

    prev = common.set_mvm_impl(hook)
    try:
        moe.moe_apply(p, torch.randn(2, 3, tcfg.d_model), tcfg)
    finally:
        common.set_mvm_impl(prev)
    D, E, Fd = tcfg.d_model, tcfg.moe.n_experts, tcfg.moe.d_ff
    assert seen[0] == (torch.float32, (D, E))            # the router, in float32
    assert sorted(s for _, s in seen[1:]) == sorted([(D, Fd), (D, Fd), (Fd, D)])


def test_init_layout_and_scales():
    jcfg, tcfg = _cfgs(1)
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                        jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    p = moe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, "cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), p,
                       is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert got == want
    assert p["router"]["w"].dtype == torch.float32
    D, Fd = tcfg.d_model, tcfg.moe.d_ff
    for name, d_in in (("w_gate", D), ("w_up", D), ("w_down", Fd)):
        assert abs(float(p[name].float().std()) * np.sqrt(d_in) - 1.0) < 0.05, name


@pytest.mark.parametrize("B,S,group", [(1, 1, 16), (3, 7, 16), (2, 6, 5), (4, 1, 256)])
def test_group_matches_reference(B, S, group):
    x = _tokens(B + S, B, S, 8)
    jg, jtg = jmoe._group(jnp.asarray(x), group)
    tg, ttg = moe._group(torch.from_numpy(x), group)
    assert ttg == jtg
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("B,S", [(4, 1), (3, 8), (2, 16)])
def test_training_raises(cf, B, S):
    """Named for what it held until the capacity dispatch was ported
    (``training=True`` raised); it now holds that path to the
    reference's: outputs and aux loss to TOL, at decode shape (groups of
    one) and over groups of 16 tokens, with capacity factor 0.5 dropping
    tokens (two choices a token over 8 experts: C = 2 of a group's 4
    expected)."""
    jcfg, tcfg = _cfgs(1)
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
                  for c in (jcfg, tcfg))
    params = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(3), jcfg, jnp.float32))
    x = _tokens(B * 10 + S, B, S, jcfg.d_model)
    jy, jaux = jmoe.moe_apply(params, jnp.asarray(x), jcfg, training=True)
    ty, taux = moe.moe_apply(bridge.params_from_numpy(params, "cpu"), torch.from_numpy(x), tcfg,
                             training=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
