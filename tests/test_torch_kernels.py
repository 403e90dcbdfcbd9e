"""The kernels' plain versions against the JAX Pallas kernels (interpret
mode), on the CPU.

Bitwise: ``dcim_mvm`` (bit-width sweep including int16, whose
B_x + B_w = 32 shift must give 0; all four signedness combinations;
ragged shapes; the batch axis; arbitrary int32 codes outside the B-bit
range, against which also a numpy emulation of the card kernel's
base-256 digit products is held) and ``fp_prealign`` (B_M in {4, 8, 11,
24}; zeros, -0.0, subnormals, mixed signs; and a numpy emulation of the
card kernel's vector path: its lanes of 4, group segments, xor
butterfly and chunks a lane).  ``dcim_fp_matmul``: the
mantissas, group exponents and group partials are bitwise on both the
narrow (fp8/bf16/fp16) and the wide 12-bit-split (fp32) path; the output
is held to RTOL_FP because the reference scales each group by
``jnp.exp2``, which XLA's CPU computes up to 4.05e-6 relative off for
integer exponents, while ``torch.exp2`` is exact there.

The kernels themselves are held to these plain versions on a card in
test_torch_kernels_gpu.py.
"""
import functools
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
from repro_torch.kernels.fp_prealign import plan as fp_prealign_plan

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


# Arbitrary int32 codes, far outside the B-bit range: the card kernel is
# held to the plain version on such inputs, so both are held to the TPU
# kernel on them here.
ARBITRARY_CASES = [(bx, bw, k, xs, ws)
                   for bx, bw, k in [(8, 8, 1), (9, 9, 1), (16, 16, 4), (24, 24, 8), (2, 2, 1),
                                     (15, 15, 4), (23, 23, 8), (15, 8, 1)]
                   for xs in (True, False) for ws in (True, False)]


@functools.lru_cache(maxsize=None)
def _arbitrary_case(B_x, B_w, k, x_signed, w_signed):
    """(x, w, the TPU kernel's result) on arbitrary int32 codes."""
    rng = np.random.default_rng(B_x * 1000 + B_w * 10 + k + 2 * x_signed + w_signed)
    x = rng.integers(-2**31, 2**31, size=(7, 45), dtype=np.int64).astype(np.int32)
    w = rng.integers(-2**31, 2**31, size=(45, 9), dtype=np.int64).astype(np.int32)
    x[0, :4] = [-1, -(2**31), 2**31 - 1, 0]
    w[:4, 0] = [-1, -(2**31), 2**31 - 1, 0]
    want = dcim_mvm_pallas(jnp.asarray(x), jnp.asarray(w), B_x=B_x, B_w=B_w, k=k,
                           x_signed=x_signed, w_signed=w_signed, block_m=8, block_n=16,
                           block_k=64, interpret=True)
    return x, w, np.asarray(want)


@pytest.mark.parametrize("B_x,B_w,k,x_signed,w_signed", ARBITRARY_CASES)
def test_dcim_mvm_plain_matches_pallas_on_arbitrary_int32(B_x, B_w, k, x_signed, w_signed):
    x, w, want = _arbitrary_case(B_x, B_w, k, x_signed, w_signed)
    got = ref.dcim_mvm_ref(torch.from_numpy(x), torch.from_numpy(w), B_x=B_x, B_w=B_w, k=k,
                           x_signed=x_signed, w_signed=w_signed)
    np.testing.assert_array_equal(got.numpy(), want)


def _balanced_digits(B):
    """csrc/dcim_mvm.cu's n_digits: the least D whose s8 digits reach
    127 (256^D - 1) / 255 >= 2^B - 1, the top of X'."""
    D = 1
    while D < 4 and 127 * (256**D - 1) // 255 < 2**B - 1:
        D += 1
    return D


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("B", range(1, 25))
def test_dcim_mvm_balanced_digits_reach_both_ends(B, signed):
    """Both ends of X' (and 0, -1 and the in-range ends) come back exactly
    from their balanced digits, whose count is the closed form that
    csrc/dcim_mvm.cu states: 1 up to 7 bits, then ceil((B + 2) / 8)."""
    ends = np.array([-(2**31), 2**31 - 1, -1, 0, 2**B - 1, -(2**(B - 1)), 2**(B - 1) - 1],
                    dtype=np.int64).astype(np.int32)
    _digits(ends, B, signed, "balanced")
    assert _balanced_digits(B) == (1 if B <= 7 else -(-(B + 2) // 8))


def _digits(v, B, signed, form):
    """X' = (v & (2^B - 1)) - (signed and v < 0 ? 2^B : 0) in base-256 digits.

    ``"balanced"`` is the card kernel's form (csrc/dcim_mvm.cu):
    D = _balanced_digits(B) digits, each an s8, digit i being byte i of
    (X' + bias) ^ bias with bias = 0x80 in each of the D low bytes.
    ``"top"``: D = ceil((B + signed) / 8) digits, u8 below the top one,
    the top one X' >> 8(D - 1) (arithmetic), s8 when signed, u8 when not.
    """
    v = v.astype(np.int64)
    xp = (v & ((1 << B) - 1)) - np.where(signed & (v < 0), 1 << B, 0)
    if form == "balanced":
        D = _balanced_digits(B)
        bias = int("80" * D, 16)
        word = (xp + bias) ^ bias
        digits = [((word >> (8 * i)) & 0xFF) for i in range(D)]
        digits = [np.where(d >= 128, d - 256, d) for d in digits]
        lo, hi = -128, 127
    else:
        D = -(-(B + int(signed)) // 8)
        digits = [(xp >> (8 * i)) & 0xFF for i in range(D - 1)] + [xp >> (8 * (D - 1))]
        lo, hi = (-128, 127) if signed else (0, 255)
    assert all(lo <= d.min() and d.max() <= hi for d in digits[-1:])
    assert all(-128 <= d.min() and d.max() <= 255 for d in digits)
    assert np.array_equal(sum(d << (8 * i) for i, d in enumerate(digits)), xp)
    return digits


def _digit_matmul(x, w, B_x, B_w, x_signed, w_signed, form):
    """Y = sum_{i + j < 4} (d^x_i @ d^w_j) << 8(i + j) mod 2^32, each digit
    product wrapped to s32 as the tensor cores' accumulator wraps."""
    dx, dw = _digits(x, B_x, x_signed, form), _digits(w, B_w, w_signed, form)
    y = np.zeros((x.shape[0], w.shape[1]), np.int64)
    for i, a in enumerate(dx):
        for j, b in enumerate(dw):
            if i + j < 4:
                prod = ((a @ b) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
                y += prod.astype(np.int64) << (8 * (i + j))
    return (y & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("form", ["balanced", "top"])
@pytest.mark.parametrize("B_x,B_w,k,x_signed,w_signed", ARBITRARY_CASES)
def test_dcim_mvm_digit_products_match_pallas(B_x, B_w, k, x_signed, w_signed, form):
    x, w, want = _arbitrary_case(B_x, B_w, k, x_signed, w_signed)
    np.testing.assert_array_equal(_digit_matmul(x, w, B_x, B_w, x_signed, w_signed, form), want)


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


def _align(b, e_max, B_M):
    """The kernel's alignment of f32 bit patterns b (uint32) against
    their group's e_max: the signed B_M-bit mantissa with its hidden bit
    (0 for zero and subnormals), shifted right by min(e_max - e, 31)."""
    e = ((b >> 23) & 0xFF).astype(np.int32)
    full = np.where(e > 0, (b & 0x7FFFFF) | (1 << 23), 0).astype(np.int32) >> (24 - B_M)
    m = np.where(b >> 31 == 1, -full, full)
    return m >> np.minimum(e_max - e, 31)


def _vector_prealign(x, B_M):
    """The vector kernel's work split, warp slot by warp slot: groups of
    H / 4 16-byte chunks over L lanes (``plan``), lane l of a group taking
    chunks l, l + L, ...; chunks past the group or past the last row read
    as 0; a max of 4 exponents a chunk in the lane, then an xor butterfly
    over the L lanes of each segment of the warp; each chunk stored as 4
    mantissas, emax by the group's first lane.  Unwritten outputs keep a
    sentinel."""
    M, G, H = x.shape
    vec, log_l, nc = fp_prealign_plan(H)
    assert vec
    L, C = 1 << log_l, H // 4
    chunks = np.ascontiguousarray(x).reshape(M * G, C, 4).view(np.uint32)
    R = M * G
    mant = np.full((R, C, 4), 0x5EED, np.int32)
    emax = np.full(R, -1, np.int32)
    lane = np.arange(32)
    for row0 in range(0, R, 32 // L):              # one load slot of a warp
        row, sub = row0 + lane // L, lane % L
        c = np.arange(nc)[None, :] * L + sub[:, None]              # (32, nc)
        live = (row[:, None] < R) & (c < C)
        v = np.zeros((32, nc, 4), np.uint32)
        v[live] = chunks[row[:, None].repeat(nc, 1)[live], c[live]]
        e = ((v >> 23) & 0xFF).astype(np.int32).reshape(32, -1).max(axis=1)
        off = L // 2
        while off:
            e = np.maximum(e, e[lane ^ off])
            off //= 2
        out = _align(v, e[:, None, None], B_M)
        mant[row[:, None].repeat(nc, 1)[live], c[live]] = out[live]
        first = (sub == 0) & (row < R)
        emax[row[first]] = e[first]
    return mant.reshape(M, G, H), emax.reshape(M, G)


@pytest.mark.parametrize("H", [4, 8, 12, 32, 64, 128, 132, 256, 512])
@pytest.mark.parametrize("B_M", [1, 8, 24])
def test_fp_prealign_lane_split(H, B_M):
    """The vector kernel's lanes of 4, group segments, xor butterfly and
    (H > 128) several chunks a lane, bitwise against the Pallas kernel;
    5 x 7 = 35 groups leave the last warp slot ragged at every L < 32."""
    x = _fp_inputs(np.random.default_rng(H + B_M), (5, 7, H))
    x[0, 1] = 0.0                        # an all-zero group
    x[0, 2] = 1e-40                      # an all-subnormal group
    m_j, e_j = fp_prealign_pallas(jnp.asarray(x), B_M=B_M, interpret=True)
    m_e, e_e = _vector_prealign(x, B_M)
    np.testing.assert_array_equal(m_e, np.asarray(m_j))
    np.testing.assert_array_equal(e_e, np.asarray(e_j))


@pytest.mark.parametrize("H", [1, 2, 3, 4, 12, 32, 33, 128, 132, 2048, 2052])
def test_fp_prealign_plan(H):
    """The vector path takes H % 4 == 0 up to 2048 on 16-byte aligned
    storage, with L * NC * 4 >= H, L and NC powers of two, NC > 1 only
    at 32 lanes; the scalar path takes the rest with L the old rule."""
    vec, log_l, nc = fp_prealign_plan(H)
    assert vec == (H % 4 == 0 and H <= 2048)
    L = 1 << log_l
    if vec:
        assert L <= 32 and nc & (nc - 1) == 0 and (nc == 1 or L == 32)
        assert L * nc * 4 >= H                          # the lanes cover the group
        assert L == 1 or (L // 2) * nc * 4 < H          # no fewer lanes would
        assert nc == 1 or L * (nc // 2) * 4 < H         # no fewer chunks a lane would
    else:
        assert nc == 0 and L == min(32, 1 << max(0, (H - 1).bit_length()))
    assert fp_prealign_plan(H, x_aligned=False)[0] is False


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
