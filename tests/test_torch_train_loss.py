"""The port's training loss and its gradients against the JAX reference,
on the CPU.

Parameters are the reference's own ``lm.init`` trees for the smoke
configs (float32), carried across by ``bridge.params_from_numpy``; the
batch (tokens or, for qwen2-vl, embeddings with text-image-text M-RoPE
ids; targets; a loss mask with zeros) is drawn from a numpy seed.
``repro_torch.models.lm.loss_fn`` under ``torch.autograd`` is held to
``jax.value_and_grad(repro.models.lm.loss_fn)``:

* the loss and each metric (ce, aux, mtp) within LOSS_RTOL = 1e-5
  relative;
* each gradient leaf within GRAD_TOL = 1e-4 of the largest magnitude of
  the reference's leaf (both sides sum in float32, in different orders).

Six families (qwen2.5-3b, deepseek-v3 with MLA, capacity MoE, aux and
MTP, falcon-mamba's associative scan, jamba, musicgen, qwen2-vl), plus a
``loss_chunk`` that splits the sequence and a capacity factor at which
tokens drop.  Remat (``cfg.remat``) changes no gradient bit in the port.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import bridge, configs, smoke
from repro_torch.models import lm
from repro_torch.tree import flatten, paths, unflatten

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 16
VLM = "qwen2-vl-72b"
VLM_SIZES = smoke.VlmSizes(batch=B, text0=3, grid=(2, 3), text1=4, n_decode=3)   # S positions
_jvg = jax.jit(jax.value_and_grad(jlm.loss_fn, has_aux=True), static_argnums=(2,))


def _cfgs(arch, capacity_factor=None, **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), attn_backend="xla", **over)
    tcfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
    if capacity_factor is not None:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (jcfg, tcfg))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(7), jcfg))


def batch(arch, cfg, seed=0):
    """A numpy batch: row 1's last 3 positions masked out."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, S), np.float32)
    mask[1, -3:] = 0.0
    b = {"targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32), "loss_mask": mask}
    if arch == VLM:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        b["position_ids"] = np.ascontiguousarray(np.broadcast_to(
            smoke.vlm_position_ids(VLM_SIZES)[:, None, :S], (3, B, S)))
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return b


def port_value_and_grad(params, b, cfg):
    """(loss, metrics, grads as a list in the reference's leaf order)."""
    flat, tdef = flatten(params)
    leaves = [p.detach().clone().requires_grad_() for p in flat]
    loss, metrics = lm.loss_fn(unflatten(tdef, leaves), {k: torch.from_numpy(v)
                                                          for k, v in b.items()}, cfg)
    return loss, metrics, torch.autograd.grad(loss, leaves)


def assert_grads_close(got, want_tree, tol=GRAD_TOL):
    """Each leaf of ``got`` (port order) within ``tol`` of the largest
    magnitude of the reference's leaf."""
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        w = np.asarray(w)
        bound = tol * float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)


CASES = [
    ("qwen2.5-3b", {}),
    ("deepseek-v3-671b", {}),
    ("falcon-mamba-7b", {}),
    ("jamba-v0.1-52b", {}),
    ("musicgen-large", {}),
    (VLM, {}),
    ("qwen2.5-3b", {"loss_chunk": 8}),                       # two chunks of S = 16
    # C = ceil(16 * 2 / 8 * 0.5) = 2 slots an expert a group of 16: tokens drop.
    ("deepseek-v3-671b", {"capacity_factor": 0.5, "loss_chunk": 4}),
]


@pytest.mark.parametrize("arch,over", CASES,
                         ids=[a + "".join(f"-{k}" for k in o) for a, o in CASES])
def test_loss_and_grads_match_reference(arch, over):
    jcfg, tcfg = _cfgs(arch, **over)
    params = _params(arch)
    b = batch(arch, tcfg)
    (jloss, jmet), jgrads = _jvg(params, jax.tree.map(jax.numpy.asarray, b), jcfg)
    loss, met, grads = port_value_and_grad(bridge.params_from_numpy(params, "cpu"), b, tcfg)
    assert set(met) == set(jmet)
    assert ("mtp" in met) == (arch == "deepseek-v3-671b")
    for k in jmet:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]), rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL, atol=0)
    assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b", "jamba-v0.1-52b"])
def test_remat_changes_no_gradient_bit(arch):
    """Each layer group under ``checkpoint`` (jamba: one group of 8
    layers a period) against no remat, with ``loss_chunk`` splitting S."""
    _, tcfg = _cfgs(arch, loss_chunk=8)
    params = bridge.params_from_numpy(_params(arch), "cpu")
    b = batch(arch, tcfg, seed=1)
    runs = [port_value_and_grad(params, b, dataclasses.replace(tcfg, remat=r))
            for r in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    for (p, _), g0, g1 in zip(paths(params), runs[0][2], runs[1][2]):
        assert torch.equal(g0, g1), p
