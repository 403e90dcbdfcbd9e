"""The kernels' plain versions against the JAX Pallas kernels (interpret
mode), on the CPU.

Bitwise: ``dcim_mvm`` (bit-width sweep including int16, whose
B_x + B_w = 32 shift must give 0; all four signedness combinations;
ragged shapes; the batch axis) and ``fp_prealign`` (B_M in {4, 8, 11,
24}; zeros, -0.0, subnormals, mixed signs).  ``dcim_fp_matmul``: the
mantissas, group exponents and group partials are bitwise on both the
narrow (fp8/bf16/fp16) and the wide 12-bit-split (fp32) path; the output
is held to RTOL_FP because the reference scales each group by
``jnp.exp2``, which XLA's CPU computes up to 4.05e-6 relative off for
integer exponents, while ``torch.exp2`` is exact there.

The kernels themselves are held to these plain versions on a card in
test_torch_kernels_gpu.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro.kernels import ops as jops
from repro.kernels.dcim_mvm import dcim_mvm_pallas
from repro.kernels.fp_prealign import fp_prealign_pallas
from repro_torch.kernels import cuda_lib, ops, ref
from repro_torch.kernels.dcim_mvm import dcim_mvm
from repro_torch.kernels.fp_prealign import fp_prealign

RTOL_FP = 2e-5     # ~5x the reference's worst exp2 error (4.05e-6 relative)


def _ints(rng, shape, bits, signed):
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed else (0, 1 << bits)
    return rng.integers(lo, hi, size=shape).astype(np.int32)


# --- dcim_mvm -------------------------------------------------------------------
@pytest.mark.parametrize("B_x,B_w,k", [(2, 2, 1), (4, 4, 2), (8, 8, 4), (8, 8, 1),
                                       (8, 4, 8), (16, 16, 4), (16, 16, 16), (12, 14, 16)])
def test_dcim_mvm_bitwidth_sweep(B_x, B_w, k):
    rng = np.random.default_rng(B_x * 100 + B_w * 10 + k)
    x, w = _ints(rng, (9, 40), B_x, True), _ints(rng, (40, 7), B_w, True)
    got = ops.dcim_mvm(torch.from_numpy(x), torch.from_numpy(w), B_x=B_x, B_w=B_w, k=k)
    want = dcim_mvm_pallas(jnp.asarray(x), jnp.asarray(w), B_x=B_x, B_w=B_w, k=k,
                           block_m=16, block_n=8, block_k=32, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("x_signed", [True, False])
@pytest.mark.parametrize("w_signed", [True, False])
def test_dcim_mvm_signedness(x_signed, w_signed):
    rng = np.random.default_rng(int(x_signed) * 2 + int(w_signed))
    x, w = _ints(rng, (5, 19), 8, x_signed), _ints(rng, (19, 11), 8, w_signed)
    got = ops.dcim_mvm(torch.from_numpy(x), torch.from_numpy(w), x_signed=x_signed,
                       w_signed=w_signed)
    want = dcim_mvm_pallas(jnp.asarray(x), jnp.asarray(w), x_signed=x_signed,
                           w_signed=w_signed, block_m=8, block_n=8, block_k=8,
                           interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64) @ w.astype(np.int64))


def test_dcim_mvm_batch_axis_and_extremes():
    """(Bt, M, K) @ (Bt, K, N) equals the per-batch reference; extreme
    codes (-128, 127) included."""
    rng = np.random.default_rng(11)
    x, w = _ints(rng, (3, 6, 33), 8, True), _ints(rng, (3, 33, 10), 8, True)
    x[0, 0], w[1, :, 0] = -128, 127
    got = ops.dcim_mvm(torch.from_numpy(x), torch.from_numpy(w), k=2)
    for b in range(3):
        want = dcim_mvm_pallas(jnp.asarray(x[b]), jnp.asarray(w[b]), k=2, block_m=8,
                               block_n=8, block_k=16, interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_dcim_mvm_int16_wraps_like_int32():
    """int16 x int16 at K = 64 overflows int32: both wrap modulo 2^32."""
    rng = np.random.default_rng(5)
    x, w = _ints(rng, (4, 64), 16, True), _ints(rng, (64, 4), 16, True)
    x[:], w[:] = -(1 << 15), -(1 << 15)
    got = ops.dcim_mvm(torch.from_numpy(x), torch.from_numpy(w), B_x=16, B_w=16, k=4)
    want = dcim_mvm_pallas(jnp.asarray(x), jnp.asarray(w), B_x=16, B_w=16, k=4,
                           block_m=8, block_n=8, block_k=32, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = (x.astype(np.int64) @ w.astype(np.int64)) & 0xFFFFFFFF
    np.testing.assert_array_equal(got.numpy().view(np.uint32), exact.astype(np.uint32))


# --- fp_prealign ------------------------------------------------------------------
def _fp_inputs(rng, shape):
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = 0.0
    flat[1::11] = -0.0
    flat[2::13] = 1e-40                  # subnormal
    flat[3::17] = -3e-39                 # negative subnormal
    return x


@pytest.mark.parametrize("shape", [(1, 1, 2), (6, 4, 16), (3, 7, 64), (2, 2, 33)])
@pytest.mark.parametrize("B_M", [4, 8, 11, 24])
def test_fp_prealign_matches_pallas(shape, B_M):
    x = _fp_inputs(np.random.default_rng(shape[0] * B_M), shape)
    m_t, e_t = fp_prealign(torch.from_numpy(x), B_M=B_M)
    m_j, e_j = fp_prealign_pallas(jnp.asarray(x), B_M=B_M, interpret=True)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))


# --- dcim_fp_matmul ----------------------------------------------------------------
def _jax_partials(mx, mw, B_M, B_w, k):
    """The reference's per-group partials, group by group through its own
    dispatcher (ops.py:249-293), as (G, M, N) float32."""
    SPLIT = 12
    narrow = (B_M + 1) + (B_w + 1) + math.ceil(math.log2(mx.shape[-1])) <= 31
    out = []
    for g in range(mx.shape[1]):
        a, b = jnp.asarray(mx[:, g]), jnp.asarray(mw[:, g])
        if narrow:
            p = jops.dcim_mvm(a, b.T, B_x=B_M + 1, B_w=B_w + 1, k=k).astype(jnp.float32)
        else:
            def mm(u, v, bx, bw, xs, ws):
                return jops.dcim_mvm(u, v.T, B_x=bx, B_w=bw, k=k, x_signed=xs,
                                     w_signed=ws).astype(jnp.float32)
            hb = max(B_M, B_w) + 1 - SPLIT + 1
            lo = (1 << SPLIT) - 1
            p = (mm(a >> SPLIT, b >> SPLIT, hb, hb, True, True) * float(2 ** (2 * SPLIT))
                 + (mm(a >> SPLIT, b & lo, hb, SPLIT, True, False)
                    + mm(a & lo, b >> SPLIT, SPLIT, hb, False, True)) * float(2 ** SPLIT)
                 + mm(a & lo, b & lo, SPLIT, SPLIT, False, False))
        out.append(np.asarray(p))
    return np.stack(out)


@pytest.mark.parametrize("B_M,H,k", [(4, 16, 2), (8, 32, 1), (11, 16, 4), (24, 8, 16)])
def test_dcim_fp_matmul_stages_and_output(B_M, H, k, monkeypatch):
    rng = np.random.default_rng(B_M)
    x = rng.normal(size=(6, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 10)) * 0.05).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)

    m_x, e_x = ops.fp_prealign(xt, H, B_M)
    m_w, e_w = ops.fp_prealign(wt.t(), H, B_M)
    jm_x, je_x = jops.fp_prealign(jnp.asarray(x), H, B_M, interpret=True)
    jm_w, je_w = jops.fp_prealign(jnp.asarray(w).T, H, B_M, interpret=True)
    for a, b in ((m_x, jm_x), (e_x, je_x), (m_w, jm_w), (e_w, je_w)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    narrow = (B_M + 1) * 2 + math.ceil(math.log2(H)) <= 31
    got_p = ops._group_partials(m_x.permute(1, 0, 2).contiguous(),
                                m_w.permute(1, 2, 0).contiguous(), B_M, B_M, k, narrow)
    np.testing.assert_array_equal(got_p.numpy(),
                                  _jax_partials(np.asarray(jm_x), np.asarray(jm_w), B_M, B_M, k))

    want = np.asarray(jops.dcim_fp_matmul(jnp.asarray(x), jnp.asarray(w), H=H, B_M=B_M,
                                          B_w=B_M, k=k))
    for budget in (ops.PARTIAL_BYTES, 6 * 4 * 4 * (64 // H)):   # one chunk; 4-column chunks
        monkeypatch.setattr(ops, "PARTIAL_BYTES", budget)
        got = ops.dcim_fp_matmul(xt, wt, H=H, B_M=B_M, B_w=B_M, k=k)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_FP, atol=RTOL_FP * np.abs(want).max())


def test_dcim_fp_matmul_wide_path_guard():
    x, w = torch.zeros((4, 512)), torch.zeros((512, 4))
    with pytest.raises(ValueError, match="too large"):
        ops.dcim_fp_matmul(x, w, H=512, B_M=24, B_w=24, k=4)
    with pytest.raises(ValueError):
        jops.dcim_fp_matmul(jnp.zeros((4, 512)), jnp.zeros((512, 4)), H=512, B_M=24, B_w=24, k=4)


def test_cpu_tensors_take_the_plain_versions():
    before = dict(cuda_lib.launches)
    rng = np.random.default_rng(0)
    x, w = torch.from_numpy(_ints(rng, (3, 8), 8, True)), torch.from_numpy(_ints(rng, (8, 2), 8, True))
    np.testing.assert_array_equal(dcim_mvm(x, w).numpy(), ref.dcim_mvm_ref(x, w).numpy())
    xf = torch.from_numpy(_fp_inputs(rng, (2, 3, 8)))
    for a, b in zip(fp_prealign(xf), ref.fp_prealign_ref(xf)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert cuda_lib.launches == before
