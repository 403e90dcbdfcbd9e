"""The port's MLA attention and K6's plain version against the JAX
reference, on the CPU.

The reference's own ``mla_init`` parameters for the deepseek-v3 smoke
config (float32) are carried across by ``bridge.params_from_numpy``, the
activations drawn from a numpy seed, and both packages run the query and
compressed-cache projections (scalar and per-row rope offsets), the
training forward (reconstructed K/V, chunked flash attention), the
absorbed attend ``mla_attend_core`` (scalar and vector positions), the
monolithic decode, the paged decode and the paged prefix prefill (with
and without a reused context), the reference on ``attn_backend="xla"``
(Pallas-interpret misses XLA by an ulp on this jax).  Held to RTOL = ATOL
= 1e-5: float32 on both sides, in different summation orders (XLA's
einsums against torch's); the pools written by the paged programs are
held to the same bound.

K6's plain version ``ref.paged_decode_mla_ref`` (through
``ops.paged_decode_mla`` on CPU tensors, which launches nothing) is held
to ``repro.kernels.ops.paged_decode_mla(backend="xla")`` at the shapes of
``tests/test_paged_attention.py`` with bfloat16 pages, and on a slot of
garbage-page rows at position 0, to ATOL = RTOL = 1e-6: scores, softmax
and context are float32 on both sides.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch import bridge, configs
from repro_torch.kernels import cuda_lib, ops
from repro_torch.models import attention as attn

TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=1e-6, atol=1e-6)
ARCH = "deepseek-v3-671b"
_jdecode_mla = jax.jit(functools.partial(jops.paged_decode_mla, backend="xla"),
                       static_argnums=(6,))


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), attn_backend="xla")
    tcfg = configs.get_smoke_config(ARCH)
    params = jax.tree.map(np.asarray, jattn.mla_init(jax.random.PRNGKey(2), jcfg, jnp.float32))
    return jcfg, tcfg, params, bridge.params_from_numpy(params, "cpu")


def _x(seed, B, S, D):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("per_row", [False, True])
def test_query_and_compressed_projections(model, per_row):
    jcfg, tcfg, params, tparams = model
    x = _x(1, 3, 5, jcfg.d_model)
    off = np.asarray([[0], [4], [9]], np.int32) if per_row else 6
    joff = jnp.asarray(off) if per_row else off
    toff = torch.from_numpy(off) if per_row else off
    for jfn, tfn in ((jattn._mla_q, attn._mla_q), (jattn._mla_ckv, attn._mla_ckv)):
        want = jfn(params, jnp.asarray(x), jcfg, joff)
        got = tfn(tparams, torch.from_numpy(x), tcfg, toff)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w)


def test_train_forward(model):
    jcfg, tcfg, params, tparams = model
    x = _x(2, 2, 19, jcfg.d_model)                   # past the smoke config's 8-row chunks
    jy, (jc, jr) = jattn.mla_apply_train(params, jnp.asarray(x), jcfg)
    ty, (tc, tr) = attn.mla_apply_train(tparams, torch.from_numpy(x), tcfg)
    for g, w in ((ty, jy), (tc, jc), (tr, jr)):
        _close(g, w)


def _absorbed_inputs(model, seed, B, S):
    jcfg, _, _, _ = model
    m = jcfg.mla
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f32(B, 1, jcfg.n_heads, m.kv_lora_rank), f32(B, 1, jcfg.n_heads, m.qk_rope_dim),
            f32(B, S, m.kv_lora_rank), f32(B, S, m.qk_rope_dim))


@pytest.mark.parametrize("pos", [0, 7, 15, "vector"])
def test_mla_attend_core(model, pos):
    qa, qr, ckv, kr = _absorbed_inputs(model, 3, 3, 16)
    if pos == "vector":
        pos = np.asarray([0, 9, 15], np.int32)
        jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    else:
        jpos = tpos = pos
    scale = 1.0 / np.sqrt(24.0)
    want = jattn.mla_attend_core(*map(jnp.asarray, (qa, qr, ckv, kr)), jpos, scale)
    got = attn.mla_attend_core(*map(torch.from_numpy, (qa, qr, ckv, kr)), tpos, scale)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("per_row", [False, True])
def test_monolithic_decode(model, per_row):
    jcfg, tcfg, params, tparams = model
    m = jcfg.mla
    B, S_max = 3, 16
    rng = np.random.default_rng(4)
    cache = {"c_kv": rng.standard_normal((B, S_max, m.kv_lora_rank)).astype(np.float32),
             "k_rope": rng.standard_normal((B, S_max, m.qk_rope_dim)).astype(np.float32)}
    x = _x(5, B, 1, jcfg.d_model)
    pos = np.asarray([3, 11, 15], np.int32) if per_row else 9
    jy, jc = jattn.mla_apply_decode(params, jnp.asarray(x), jcfg,
                                    {k: jnp.asarray(v) for k, v in cache.items()},
                                    jnp.asarray(pos) if per_row else pos)
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ty, tc = attn.mla_apply_decode(tparams, torch.from_numpy(x), tcfg, tc,
                                   torch.from_numpy(pos) if per_row else pos)
    _close(ty, jy)
    for k in cache:
        _close(tc[k], jc[k])


def _pool(rng, n_pages, page, m):
    return {"c_kv": rng.standard_normal((n_pages, page, m.kv_lora_rank)).astype(np.float32),
            "k_rope": rng.standard_normal((n_pages, page, m.qk_rope_dim)).astype(np.float32)}


def test_paged_decode(model):
    """Three slots, the last inactive (all garbage page, position 0)."""
    jcfg, tcfg, params, tparams = model
    page, nb = 4, 4
    rng = np.random.default_rng(6)
    pool = _pool(rng, 12, page, jcfg.mla)
    bt = np.zeros((3, nb), np.int32)
    bt[0], bt[1] = [1, 2, 3, 4], [5, 6, 7, 8]
    pos = np.asarray([13, 4, 0], np.int32)
    x = _x(7, 3, 1, jcfg.d_model)
    jy, jpool = jattn.mla_apply_decode_paged(params, jnp.asarray(x), jcfg,
                                             {k: jnp.asarray(v) for k, v in pool.items()},
                                             jnp.asarray(bt), jnp.asarray(pos))
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    ty, tpool = attn.mla_apply_decode_paged(tparams, torch.from_numpy(x), tcfg, tpool,
                                            torch.from_numpy(bt), torch.from_numpy(pos))
    _close(ty, jy)
    for k in pool:
        _close(tpool[k], jpool[k])


@pytest.mark.parametrize("use_context", [True, False])
def test_paged_prefix_prefill(model, use_context):
    """Two tail rows, one over a reused 6-token context and one without
    (right-padded: its pads write the garbage page)."""
    jcfg, tcfg, params, tparams = model
    page, nb, T = 4, 4, 5
    rng = np.random.default_rng(8)
    pool = _pool(rng, 10, page, jcfg.mla)
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    ctx = np.asarray([6, 0] if use_context else [0, 0], np.int32)
    tv = np.asarray([5, 3], np.int32)
    g = ctx[:, None] + np.arange(T)[None]
    wr_pg = np.where(np.arange(T)[None] < tv[:, None],
                     np.take_along_axis(bt, np.minimum(g // page, nb - 1), 1), 0).astype(np.int32)
    wr_rw = np.where(np.arange(T)[None] < tv[:, None], g % page, 0).astype(np.int32)
    x = _x(9, 2, T, jcfg.d_model)
    args = (bt, ctx, wr_pg, wr_rw)
    jy, jpool = jattn.mla_apply_prefix(params, jnp.asarray(x), jcfg,
                                       {k: jnp.asarray(v) for k, v in pool.items()},
                                       *map(jnp.asarray, args), use_context=use_context)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    ty, tpool = attn.mla_apply_prefix(tparams, torch.from_numpy(x), tcfg, tpool,
                                      *map(torch.from_numpy, args), use_context=use_context)
    _close(ty[0], np.asarray(jy)[0])
    _close(ty[1, :3], np.asarray(jy)[1, :3])
    for k in pool:
        _close(tpool[k], jpool[k])


# --- K6's plain version ---------------------------------------------------------------
def _bf16(a):
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _decode_mla_both(rng, B, H, r, dr, page, nb, pos=None, garbage_rows=()):
    n_pages = 1 + B * nb + 2
    jc, tc = _bf16(rng.standard_normal((n_pages, page, r)))
    jr, tr = _bf16(rng.standard_normal((n_pages, page, dr)))
    bt = rng.permutation(np.arange(1, n_pages))[:B * nb].reshape(B, nb).astype(np.int32)
    for b in garbage_rows:
        bt[b] = 0
    qa = rng.standard_normal((B, 1, H, r)).astype(np.float32)
    qr = rng.standard_normal((B, 1, H, dr)).astype(np.float32)
    if pos is None:
        pos = rng.integers(0, nb * page, B).astype(np.int32)
    scale = 1.0 / np.sqrt(r + dr)
    want = _jdecode_mla(jnp.asarray(qa), jnp.asarray(qr), jc, jr, jnp.asarray(bt),
                        jnp.asarray(pos), scale)
    before = dict(cuda_lib.launches)
    got = ops.paged_decode_mla(torch.from_numpy(qa), torch.from_numpy(qr), tc, tr,
                               torch.from_numpy(bt), torch.from_numpy(pos), scale)
    assert cuda_lib.launches == before            # a CPU tensor never launches
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("B,H,r,dr,page,nb", [
    (1, 1, 8, 4, 4, 1),
    (3, 4, 32, 16, 8, 3),
    (2, 8, 64, 32, 8, 2),
])
def test_paged_decode_mla_plain_version(B, H, r, dr, page, nb):
    _decode_mla_both(np.random.default_rng(B * 10 + H), B, H, r, dr, page, nb)


def test_paged_decode_mla_garbage_page_rows():
    """An inactive slot names page 0 throughout at position 0: only key 0
    of the garbage page is attended, and the output is finite."""
    _decode_mla_both(np.random.default_rng(12), 3, 4, 32, 16, 4, 3,
                     pos=np.asarray([11, 0, 5], np.int32), garbage_rows=(1,))
