"""K4 and K5's plain versions against the JAX reference, on the CPU.

The port's ``ops.paged_decode_gqa`` / ``ops.prefix_prefill`` on CPU
tensors (their plain versions: gather or concatenate, then one masked
softmax) against ``repro.kernels.ops.*(backend="xla")``, the reference's
gather+attend path, at the shapes of ``tests/test_paged_attention.py``:
the garbage page, ragged positions including 0 and the last slot
position, ``ctx_len`` 0 and L, L = 0, bfloat16 pages and bfloat16
context pages cast to the compute dtype.  Held to ATOL = RTOL = 1e-6:
scores, softmax and PV are float32 on both sides, in different
summation orders (XLA's einsums against torch's), so they agree to a
few float32 ulps of the output's magnitude (~1).  The kernels are held
to these plain versions on the card (``test_torch_kernels_gpu.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import cuda_lib, ops

TOL = dict(rtol=1e-6, atol=1e-6)
# One compiled program per shape is quicker here than op-by-op dispatch.
_jdecode = jax.jit(functools.partial(jops.paged_decode_gqa, backend="xla"))
_jprefill = jax.jit(functools.partial(jops.prefix_prefill, backend="xla"))


def _bf16(a):
    """numpy float32 -> (jax bf16 array, torch bf16 tensor) of the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _block_table(rng, B, nb, n_pages):
    """Distinct non-garbage pages per (slot, idx); page 0 is reserved."""
    return rng.permutation(np.arange(1, n_pages))[: B * nb].reshape(B, nb).astype(np.int32)


def _decode_both(q, kp, vp, bt, pos):
    jk, tk = _bf16(kp)
    jv, tv = _bf16(vp)
    want = _jdecode(jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(pos))
    before = dict(cuda_lib.launches)
    got = ops.paged_decode_gqa(torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
                               torch.from_numpy(pos))
    assert cuda_lib.launches == before          # a CPU tensor never launches
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,Hk,G,hd,hdv,page,nb", [
    (1, 1, 1, 8, 8, 4, 1),
    (3, 2, 4, 16, 16, 8, 3),
    (2, 2, 1, 16, 8, 8, 2),
    (4, 1, 6, 32, 32, 16, 2),
])
def test_paged_decode_gqa(B, Hk, G, hd, hdv, page, nb):
    rng = np.random.default_rng(B * 100 + nb)
    n_pages = 1 + B * nb + 3
    kp = rng.standard_normal((n_pages, page, Hk, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, Hk, hdv)).astype(np.float32)
    bt = _block_table(rng, B, nb, n_pages)
    q = rng.standard_normal((B, 1, Hk * G, hd)).astype(np.float32)
    pos = rng.integers(0, nb * page, B).astype(np.int32)
    pos[0] = 0
    pos[-1] = nb * page - 1
    _decode_both(q, kp, vp, bt, pos)


def test_paged_decode_garbage_page_rows():
    """An inactive slot names page 0 throughout at position 0: only key 0
    of the garbage page is attended, and the output is finite."""
    rng = np.random.default_rng(7)
    B, Hk, G, hd, page, nb = 3, 2, 2, 16, 8, 2
    n_pages = 1 + B * nb
    kp = rng.standard_normal((n_pages, page, Hk, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, Hk, hd)).astype(np.float32)
    bt = _block_table(rng, B, nb, n_pages)
    bt[1] = 0
    q = rng.standard_normal((B, 1, Hk * G, hd)).astype(np.float32)
    _decode_both(q, kp, vp, bt, np.asarray([5, 0, nb * page - 1], np.int32))


def _prefill_both(q, kc, vc, kt, vt, ctx):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = _jprefill(j(q), j(kc), j(vc), j(kt), j(vt), j(ctx))
    got = ops.prefix_prefill(t(q), t(kc), t(vc), t(kt), t(vt), t(ctx))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,T,Hk,G,hd,L", [
    (1, 1, 1, 1, 8, 0),
    (3, 7, 2, 4, 16, 16),
    (2, 8, 2, 1, 16, 24),
    (2, 5, 1, 3, 8, 8),
    (2, 12, 2, 2, 8, 0),
])
def test_prefix_prefill(B, T, Hk, G, hd, L):
    rng = np.random.default_rng(B + T + L)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kt, vt = f32(B, T, Hk * G, hd), f32(B, T, Hk, hd), f32(B, T, Hk, hd)
    if L:
        kc, vc = f32(B, L, Hk, hd), f32(B, L, Hk, hd)
        ctx = rng.integers(0, L + 1, B).astype(np.int32)
        ctx[0] = 0                                  # a burst member without a hit
        ctx[-1] = L                                 # a fully valid context
    else:
        kc = vc = None
        ctx = np.zeros(B, np.int32)
    _prefill_both(q, kc, vc, kt, vt, ctx)


def test_prefix_prefill_bf16_context_pages():
    """Serving casts the gathered bfloat16 context pages to the compute
    dtype before attending."""
    rng = np.random.default_rng(3)
    B, T, Hk, G, hd, L = 2, 4, 2, 2, 16, 16
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q = f32(B, T, Hk * G, hd)
    kc = np.array(jnp.asarray(f32(B, L, Hk, hd), jnp.bfloat16).astype(jnp.float32))
    vc = np.array(jnp.asarray(f32(B, L, Hk, hd), jnp.bfloat16).astype(jnp.float32))
    _prefill_both(q, kc, vc, f32(B, T, Hk, hd), f32(B, T, Hk, hd), np.asarray([7, L], np.int32))


def test_prefix_prefill_padded_tail_rows_are_finite():
    """Right-padded (all-zero) tail rows, as burst prefill gives the
    padding rows of a batch, still see their own tail column."""
    rng = np.random.default_rng(9)
    B, T, Hk, G, hd, L = 2, 6, 1, 2, 8, 8
    q = np.zeros((B, T, Hk * G, hd), np.float32)
    kt = np.zeros((B, T, Hk, hd), np.float32)
    q[0, :3] = rng.standard_normal((3, Hk * G, hd))
    kt[0, :3] = rng.standard_normal((3, Hk, hd))
    vt = rng.standard_normal((B, T, Hk, hd)).astype(np.float32)
    kc = rng.standard_normal((B, L, Hk, hd)).astype(np.float32)
    _prefill_both(q, kc, kc.copy(), kt, vt, np.asarray([L, 0], np.int32))
