"""The hand-written kernels against their plain versions, on a card.

Every test here is marked ``gpu``: the ``cuda_device`` fixture decides
whether there is a card and skips with a reason where there is none.
The file imports only the port (the machine with the card has no JAX):

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro_torch.kernels import cuda_lib, ops, paged_attention, ref
from repro_torch.kernels.dcim_mvm import dcim_mvm
from repro_torch.kernels.dcim_mvm import plan as dcim_mvm_plan
from repro_torch.kernels.fp_prealign import fp_prealign


def _ints(rng, shape, bits, signed):
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed else (0, 1 << bits)
    return rng.integers(lo, hi, size=shape).astype(np.int32)


def _range_ends(bits, signed):
    return [-(1 << (bits - 1)), (1 << (bits - 1)) - 1] if signed else [0, (1 << bits) - 1]


def _fp_inputs(rng, shape):
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = 0.0
    flat[1::11] = -0.0
    flat[2::13] = 1e-40                  # subnormal
    flat[3::17] = -3e-39                 # negative subnormal
    return x


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels run only there)")
    return torch.device("cuda", 0)


# (B_x, B_w, k, x_signed, w_signed, (Bt, M, K, N), codes): codes "range"
# draws in-range B-bit codes, both ends of the range among them,
# "arbitrary" any int32, "mixed" in-range
# codes with arbitrary ones at k in [64, 80) of x only or of w only (so
# some 32-deep steps of a launch take the low digit product alone and
# others every product).  The first seven are
# the original cases; then both tiles (M <= 16 and above) and their
# ragged edges, K off the 32-deep step, narrow and wide N (at M = 2,
# K = 2048, N = 256 the launch splits K), B = 24 under every signedness,
# arbitrary codes, the widths whose top code needs one more balanced
# digit than B + 1 bits would (15, 23), and the batched FP shape
# (G, M, 32) @ (G, 32, N).
DCIM_CASES = [
    (8, 8, 4, True, True, (3, 70, 45, 130), "range"),
    (8, 8, 1, True, False, (3, 70, 45, 130), "range"),
    (16, 16, 4, True, True, (3, 70, 45, 130), "range"),
    (16, 16, 16, False, True, (3, 70, 45, 130), "range"),
    (9, 9, 1, True, True, (3, 70, 45, 130), "range"),
    (14, 12, 16, True, False, (3, 70, 45, 130), "range"),
    (2, 2, 1, False, False, (3, 70, 45, 130), "range"),
] + [
    (8, 8, 1, True, True, (2, M, 96, 130), "range") for M in (1, 2, 16, 17, 130)
] + [
    (8, 8, 1, True, True, (2, M, K, 136), "range") for M in (2, 130) for K in (45, 70)
] + [
    (8, 8, 1, True, True, (1, 2, 2048, N), "range") for N in (7, 256, 2000)
] + [
    (24, 24, 8, xs, ws, (2, M, 200, 72), "range")
    for xs in (True, False) for ws in (True, False) for M in (2, 70)
] + [
    (bx, bw, k, xs, ws, (2, M, 77, 40), "arbitrary")
    for bx, bw, k in ((8, 8, 1), (9, 9, 1), (16, 16, 4), (24, 24, 8), (2, 2, 1))
    for xs in (True, False) for ws in (True, False) for M in (3, 33)
] + [
    (bx, bw, k, xs, ws, (2, M, 77, 40), codes)
    for bx, bw, k in ((15, 15, 4), (23, 23, 8), (15, 8, 1))
    for xs in (True, False) for ws in (True, False) for M in (3, 33)
    for codes in ("range", "arbitrary")
] + [
    (8, 8, 1, True, True, shape, codes) for shape in ((2, 2, 200, 130), (2, 130, 300, 136))
    for codes in ("mixed_x", "mixed_w")
] + [
    (9, 9, 1, True, True, (64, 20, 32, 300), "range"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B_x,B_w,k,x_signed,w_signed,shape,codes", DCIM_CASES)
def test_dcim_mvm_kernel_matches_plain(cuda_device, B_x, B_w, k, x_signed, w_signed, shape,
                                       codes):
    Bt, M, K, N = shape
    rng = np.random.default_rng(B_x + B_w + k + M + K + N + 2 * x_signed + w_signed)
    if codes == "arbitrary":
        x_np = rng.integers(-2**31, 2**31, size=(Bt, M, K), dtype=np.int64).astype(np.int32)
        w_np = rng.integers(-2**31, 2**31, size=(Bt, K, N), dtype=np.int64).astype(np.int32)
    else:
        x_np, w_np = _ints(rng, (Bt, M, K), B_x, x_signed), _ints(rng, (Bt, K, N), B_w, w_signed)
        x_np[:, 0, :2] = _range_ends(B_x, x_signed)
        w_np[:, :2, 0] = _range_ends(B_w, w_signed)
    if codes == "mixed_x":
        x_np[..., 64:80] = rng.integers(-2**31, 2**31, size=(Bt, M, 16), dtype=np.int64)
    if codes == "mixed_w":
        w_np[:, 64:80] = rng.integers(-2**31, 2**31, size=(Bt, 16, N), dtype=np.int64)
    x, w = torch.from_numpy(x_np).to(cuda_device), torch.from_numpy(w_np).to(cuda_device)
    kw = dict(B_x=B_x, B_w=B_w, k=k, x_signed=x_signed, w_signed=w_signed)
    if (M, K, N) == (2, 2048, 256):
        assert dcim_mvm_plan(Bt, M, K, N, B_x, B_w, cuda_device)[1] > 1
    before = cuda_lib.launches["dcim_mvm"]
    got = dcim_mvm(x, w, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.launches["dcim_mvm"] == before + 1
    assert torch.equal(got, ref.dcim_mvm_ref(x, w, **kw))
    assert torch.equal(dcim_mvm(x[0], w[0], **kw), got[0])


@pytest.mark.gpu
def test_dcim_mvm_kernel_wraps_int16_extremes(cuda_device):
    """Every code -2^15 over K = 64: each output is 2^36 mod 2^32; the
    tensor cores' accumulators wrap, they do not saturate."""
    x = torch.full((5, 64), -(1 << 15), dtype=torch.int32, device=cuda_device)
    w = torch.full((64, 9), -(1 << 15), dtype=torch.int32, device=cuda_device)
    before = cuda_lib.launches["dcim_mvm"]
    got = dcim_mvm(x, w, B_x=16, B_w=16, k=4)
    torch.cuda.synchronize()
    assert cuda_lib.launches["dcim_mvm"] == before + 1
    # int64 product as a sum (the card has no int64 matmul).
    exact = (x.to(torch.int64).unsqueeze(-1) * w.to(torch.int64).unsqueeze(0)).sum(1)
    exact = exact & 0xFFFFFFFF
    exact = torch.where(exact >= 2**31, exact - 2**32, exact).to(torch.int32)
    assert torch.equal(got, exact)
    assert torch.equal(got, ref.dcim_mvm_ref(x, w, B_x=16, B_w=16, k=4))


@pytest.mark.gpu
@pytest.mark.parametrize("S,P", [(1, 1), (2, 33), (16, 256)])
def test_dominance_kernel_matches_plain(cuda_device, S, P):
    rng = np.random.default_rng(P)
    F = np.round(rng.normal(size=(S, P, 4)), 1).astype(np.float32)
    F[rng.random(F.shape) < 0.05] = np.nan
    F[rng.random(F.shape) < 0.05] = np.inf
    v = np.where(rng.random((S, P)) < 0.3, rng.random((S, P)), 0).astype(np.float32)
    Ft, vt = torch.from_numpy(F).to(cuda_device), torch.from_numpy(v).to(cuda_device)
    for vv in (vt, None):
        assert torch.equal(ops.dominance_matrix(Ft, vv), ref.dominance_matrix_ref(Ft, vv))
    assert torch.equal(ops.dominance_matrix(Ft[0], vt[0]), ref.dominance_matrix_ref(Ft[0], vt[0]))


# --- K3's vector and scalar paths ----------------------------------------------------
# H % 4 == 0 on 16-byte aligned storage takes the vector path (lanes of 4
# floats, several chunks a lane above H = 128), the rest the scalar one;
# each case checks which ran through launches["fp_prealign_vec"].
VEC_H = [4, 8, 16, 32, 64, 128, 256, 512]
SCALAR_H = [1, 2, 3, 33]


def _prealign_and_check(x, B_M, vec):
    n_vec = cuda_lib.launches["fp_prealign_vec"]
    got = fp_prealign(x, B_M=B_M)
    torch.cuda.synchronize()
    assert cuda_lib.launches["fp_prealign_vec"] - n_vec == int(vec)
    want = ref.fp_prealign_ref(x, B_M=B_M)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("H", VEC_H + SCALAR_H)
@pytest.mark.parametrize("B_M", [1, 4, 8, 24])
def test_fp_prealign_kernel_matches_plain(cuda_device, H, B_M):
    """37 x 5 = 185 groups: a ragged last CTA on every path."""
    x = _fp_inputs(np.random.default_rng(H), (37, 5, H))
    x[0, 1] = 0.0                                        # an all-zero group
    x[0, 2] = -1e-40                                     # an all-subnormal group
    _prealign_and_check(torch.from_numpy(x).to(cuda_device), B_M, H in VEC_H)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [4, 32, 256])
@pytest.mark.parametrize("R", [1, 127, 128, 129, 3001])
def test_fp_prealign_vector_path_ragged_rows(cuda_device, H, R):
    """Group counts around and off a CTA's (128 at H = 32, 1024 at H = 4,
    16 at H = 256)."""
    x = _fp_inputs(np.random.default_rng(R + H), (R, 1, H))
    _prealign_and_check(torch.from_numpy(x).to(cuda_device), 8, True)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [4, 32])
def test_fp_prealign_takes_storage_off_16_byte_alignment(cuda_device, H):
    """A contiguous view that starts 4 bytes past a 16-byte boundary takes
    the scalar path."""
    x = torch.from_numpy(_fp_inputs(np.random.default_rng(H), (9, 4, H))).to(cuda_device)
    view = _offset(x, 1)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    _prealign_and_check(view, 8, False)


@pytest.mark.gpu
def test_fp_prealign_past_2_31_elements(cuda_device):
    """R * H = 2^31 + 2048 (8.6 GB in): 64-bit row offsets.  The last 1024
    groups, which straddle element 2^31, against the plain version of
    those rows."""
    R, H = (1 << 26) + 64, 32
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(5)
    x = torch.randn((R, 1, H), generator=gen, device=cuda_device)
    x[-3:-1] = 1e-40                                     # subnormal groups at the end
    n_vec = cuda_lib.launches["fp_prealign_vec"]
    mant, emax = fp_prealign(x, B_M=8)
    torch.cuda.synchronize()
    assert cuda_lib.launches["fp_prealign_vec"] - n_vec == 1
    want_m, want_e = ref.fp_prealign_ref(x[-1024:], B_M=8)
    assert torch.equal(mant[-1024:], want_m) and torch.equal(emax[-1024:], want_e)
    want_m, want_e = ref.fp_prealign_ref(x[:1024], B_M=8)
    assert torch.equal(mant[:1024], want_m) and torch.equal(emax[:1024], want_e)


# --- K1: ragged and chunked tiles, special values, scenario counts ------------------
def _dominance_inputs(rng, S, P, M):
    F = np.round(rng.normal(size=(S, P, M)), 1).astype(np.float32)   # ties
    for value in (np.nan, np.inf, -np.inf, 0.0, -0.0):
        F[rng.random(F.shape) < 0.04] = value
    F[:, -1] = F[:, 0]                                   # a duplicate row
    v = np.where(rng.random((S, P)) < 0.3, rng.random((S, P)), 0.0).astype(np.float32)
    v[:, 1:3] = 0.5                                      # tied violations
    return F, v


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 15, 16, 17, 128, 256, 2048])
@pytest.mark.parametrize("M", [1, 3, 4, 5, 8])
def test_dominance_tiles_match_plain(cuda_device, P, M):
    """P off and on 16 (byte and 16-byte stores), P = 2048 in several
    shared-memory chunks at M >= 4, with and without v, batched and not;
    no row dominates itself."""
    S = 2 if P == 2048 else 3
    F, v = _dominance_inputs(np.random.default_rng(P * 10 + M), S, P, M)
    Ft, vt = torch.from_numpy(F).to(cuda_device), torch.from_numpy(v).to(cuda_device)
    for vv in (vt, None):
        got = ops.dominance_matrix(Ft, vv)
        assert torch.equal(got, ref.dominance_matrix_ref(Ft, vv))
        assert not got.diagonal(dim1=1, dim2=2).any()
    assert torch.equal(ops.dominance_matrix(Ft[1], vt[1]), ref.dominance_matrix_ref(Ft[1], vt[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("P", [17, 48])
@pytest.mark.parametrize("M", [0, 4000])
def test_dominance_any_M(cuda_device, P, M):
    """M = 0 (D is v_i < v_j) and M = 4000 (too wide to stage: F[j] is
    read in place), with and without v, batched and not."""
    F, v = _dominance_inputs(np.random.default_rng(P + M), 2, P, M)
    Ft, vt = torch.from_numpy(F).to(cuda_device), torch.from_numpy(v).to(cuda_device)
    for vv in (vt, None):
        assert torch.equal(ops.dominance_matrix(Ft, vv), ref.dominance_matrix_ref(Ft, vv))
    assert torch.equal(ops.dominance_matrix(Ft[1], vt[1]), ref.dominance_matrix_ref(Ft[1], vt[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4, 5])
def test_dominance_takes_storage_off_16_byte_alignment(cuda_device, M):
    """F and v views that start 4 bytes past a 16-byte boundary (M = 4
    then takes the loop over M instead of float4 reads)."""
    F, v = _dominance_inputs(np.random.default_rng(M), 3, 48, M)
    Ft = _offset(torch.from_numpy(F).to(cuda_device), 1)
    vt = _offset(torch.from_numpy(v).to(cuda_device), 1)
    assert Ft.data_ptr() % 16 == 4
    assert torch.equal(ops.dominance_matrix(Ft, vt), ref.dominance_matrix_ref(Ft, vt))


@pytest.mark.gpu
def test_dominance_special_values(cuda_device):
    """NaN reads as +inf (a NaN row ties an inf row), -0.0 ties +0.0,
    -inf dominates; identical rows dominate neither way."""
    inf, nan = np.inf, np.nan
    F = np.array([[0.0, 1.0], [-0.0, 1.0], [nan, 1.0], [inf, 1.0], [-inf, 1.0],
                  [0.0, nan], [0.0, inf], [1.0, 2.0], [1.0, 2.0], [-0.0, 0.5]], np.float32)
    Ft = torch.from_numpy(F).to(cuda_device)
    got = ops.dominance_matrix(Ft)
    assert torch.equal(got, ref.dominance_matrix_ref(Ft))
    assert not got[0, 1] and not got[1, 0]               # -0.0 ties +0.0
    assert not got[2, 3] and not got[3, 2]               # NaN ties +inf
    assert got[4, 0] and got[0, 3] and got[9, 0]
    assert not got[7, 8] and not got[8, 7]


@pytest.mark.gpu
def test_dominance_more_than_65535_scenarios(cuda_device):
    """The grid puts scenarios and row tiles on its x axis, so S is not
    held to the 65535 of a y or z axis."""
    F, v = _dominance_inputs(np.random.default_rng(3), 70000, 3, 4)
    Ft, vt = torch.from_numpy(F).to(cuda_device), torch.from_numpy(v).to(cuda_device)
    assert torch.equal(ops.dominance_matrix(Ft, vt), ref.dominance_matrix_ref(Ft, vt))


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        dcim_mvm(x.float(), x.t().contiguous())
    with pytest.raises(ValueError):
        dcim_mvm(x, x.t())                       # not contiguous
    with pytest.raises(ValueError):
        dcim_mvm(x, x.t().contiguous(), k=17)
    with pytest.raises(ValueError):
        fp_prealign(torch.zeros((2, 3, 4), dtype=torch.float64, device=cuda_device))


# --- K4 / K5: paged GQA decode, [context ; causal tail] prefill ------------------
# Against the plain version on the same card: f32 operands differ only by
# summation order and the online softmax's rescaling (1e-5); bf16
# operands also round the softmax weights to bf16 before PV, the kernel
# unnormalised and the plain version normalised, one bf16 ulp (2^-8)
# apart at most per weight (2e-2).
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _rand(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


def _close(got, want, dtype):
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.float32, torch.bfloat16),
                                      (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("B,Hk,G,hd,page,nb", [(3, 2, 4, 16, 8, 1), (4, 2, 8, 128, 16, 64),
                                               (2, 1, 3, 64, 4, 5)])
def test_paged_decode_gqa_kernel_matches_plain(cuda_device, qdt, kvdt, B, Hk, G, hd, page, nb):
    rng = np.random.default_rng(B * 7 + nb)
    n_pages = 1 + B * nb + 2
    kp = _rand(rng, (n_pages, page, Hk, hd), kvdt, cuda_device)
    vp = _rand(rng, (n_pages, page, Hk, hd), kvdt, cuda_device)
    bt = rng.permutation(np.arange(1, n_pages))[:B * nb].reshape(B, nb).astype(np.int32)
    bt[-1] = 0                                   # an inactive slot: all garbage page
    pos = rng.integers(0, nb * page, B).astype(np.int32)
    pos[0], pos[-1] = nb * page - 1, 0            # a full slot, and the inactive one
    bt, pos = torch.from_numpy(bt).to(cuda_device), torch.from_numpy(pos).to(cuda_device)
    q = _rand(rng, (B, 1, Hk * G, hd), qdt, cuda_device)
    before = dict(cuda_lib.launches)
    got = ops.paged_decode_gqa(q, kp, vp, bt, pos)
    torch.cuda.synchronize()
    assert cuda_lib.launches["paged_decode_gqa"] == before["paged_decode_gqa"] + 1
    mma = qdt == kvdt == torch.bfloat16           # the tensor-core kernel, by dtype alone
    assert cuda_lib.launches["paged_decode_gqa_mma"] == before["paged_decode_gqa_mma"] + mma
    _close(got, ref.paged_decode_gqa_ref(q, kp, vp, bt, pos), kvdt)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt,kvdt", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.bfloat16),
                                      (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("B,T,Hk,G,hd,L", [(3, 7, 2, 4, 16, 16), (2, 37, 2, 8, 128, 0),
                                           (4, 64, 2, 8, 128, 1024), (1, 1, 1, 1, 8, 0),
                                           (2, 9, 1, 80, 32, 8)])
def test_prefix_prefill_kernel_matches_plain(cuda_device, qdt, kvdt, B, T, Hk, G, hd, L):
    rng = np.random.default_rng(B + T + L)
    q = _rand(rng, (B, T, Hk * G, hd), qdt, cuda_device)
    kt, vt = (_rand(rng, (B, T, Hk, hd), kvdt, cuda_device) for _ in range(2))
    if L:
        kc, vc = (_rand(rng, (B, L, Hk, hd), kvdt, cuda_device) for _ in range(2))
        ctx = rng.integers(0, L + 1, B).astype(np.int32)
        ctx[0] = 0
        ctx[-1] = L
    else:
        kc = vc = None
        ctx = np.zeros(B, np.int32)
    q[:, T // 2:] = 0                              # right-padded rows stay finite
    ctx = torch.from_numpy(ctx).to(cuda_device)
    before = dict(cuda_lib.launches)
    got = ops.prefix_prefill(q, kc, vc, kt, vt, ctx)
    torch.cuda.synchronize()
    assert cuda_lib.launches["prefix_prefill"] == before["prefix_prefill"] + 1
    mma = qdt == kvdt == torch.bfloat16           # the tensor-core kernel, by dtype alone
    assert cuda_lib.launches["prefix_prefill_mma"] == before["prefix_prefill_mma"] + mma
    _close(got, ref.prefix_prefill_ref(q, kc, vc, kt, vt, ctx), kvdt)


@pytest.mark.gpu
def test_attention_wrappers_reject_what_they_do_not_take(cuda_device):
    d = cuda_device
    q = torch.zeros((2, 1, 6, 16), device=d)
    kp = torch.zeros((5, 4, 2, 16), device=d)
    bt = torch.ones((2, 2), dtype=torch.int32, device=d)
    pos = torch.zeros(2, dtype=torch.int32, device=d)
    before = dict(cuda_lib.launches)
    with pytest.raises(ValueError):               # 4 KV heads do not divide 6
        ops.paged_decode_gqa(q, torch.zeros((5, 4, 4, 16), device=d),
                             torch.zeros((5, 4, 4, 16), device=d), bt, pos)
    with pytest.raises(ValueError):               # float16
        ops.paged_decode_gqa(q.half(), kp.half(), kp.half(), bt, pos)
    with pytest.raises(ValueError):               # not contiguous
        ops.paged_decode_gqa(q.transpose(0, 2).contiguous().transpose(0, 2), kp, kp, bt, pos)
    with pytest.raises(ValueError):               # int64 positions
        ops.paged_decode_gqa(q, kp, kp, bt, pos.long())
    qt = torch.zeros((2, 3, 6, 16), device=d)
    kt = torch.zeros((2, 3, 2, 16), device=d)
    with pytest.raises(ValueError):               # K and V of different dtypes
        ops.prefix_prefill(qt, None, None, kt, kt.bfloat16(), pos)
    with pytest.raises(ValueError):               # one context operand alone
        ops.prefix_prefill(qt, kt, None, kt, kt, pos)
    with pytest.raises(ValueError):               # 4 KV heads do not divide 6
        ops.prefix_prefill(qt, None, None, torch.zeros((2, 3, 4, 16), device=d),
                           torch.zeros((2, 3, 4, 16), device=d), pos)
    assert cuda_lib.launches == before


# --- K5 at the MLA shape: hd 192 != hdv 128, one query head per KV head --------------
@pytest.mark.gpu
@pytest.mark.parametrize("kvdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,H,L", [(2, 70, 128, 256), (2, 130, 16, 0), (4, 64, 128, 1024)])
def test_prefix_prefill_kernel_mla_shape(cuda_device, kvdt, B, T, H, L):
    rng = np.random.default_rng(B + T + H + L)
    hd, hdv = 192, 128
    q = _rand(rng, (B, T, H, hd), kvdt, cuda_device)
    kt, vt = _rand(rng, (B, T, H, hd), kvdt, cuda_device), _rand(rng, (B, T, H, hdv), kvdt,
                                                                    cuda_device)
    if L:
        kc, vc = _rand(rng, (B, L, H, hd), kvdt, cuda_device), _rand(rng, (B, L, H, hdv), kvdt,
                                                                        cuda_device)
        ctx = np.full(B, min(L, 256), np.int32)
        ctx[0] = 0
    else:
        kc = vc = None
        ctx = np.zeros(B, np.int32)
    ctx = torch.from_numpy(ctx).to(cuda_device)
    before = dict(cuda_lib.launches)
    got = ops.prefix_prefill(q, kc, vc, kt, vt, ctx)
    torch.cuda.synchronize()
    assert cuda_lib.launches["prefix_prefill"] == before["prefix_prefill"] + 1
    assert (cuda_lib.launches["prefix_prefill_mma"]
            == before["prefix_prefill_mma"] + (kvdt == torch.bfloat16))
    assert got.shape == (B, T, H, hdv)
    _close(got, ref.prefix_prefill_ref(q, kc, vc, kt, vt, ctx), kvdt)


# --- K5's tensor-core kernel: bf16 q, K and V ---------------------------------------
def _offset(t, elements):
    """A contiguous copy of ``t`` that starts ``elements`` past an
    allocation's start (rows no longer 16-byte aligned)."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    view = buf[elements:].view(t.shape)
    view.copy_(t)
    return view


# (B, T, Hk, G, hd, hdv, L, offset): T * G off the 64-row tile (296, 720,
# 130, 63, 148 rows ...); G 1, 2, 3, 4, 8 and 80; hd 8, 16, 128 and 192 with
# hdv != hd, and the widths that take 4-byte copies (hd 12, hdv 20),
# element copies (hd 7, hdv 5), 32-key tiles (hdv 192, 256); T = 1; a
# 1024-row context; rows that start 1 or 2 elements past a 16-byte
# boundary.  ctx_len is 0, partial and L within each launch with context.
MMA_CASES = [
    (3, 37, 2, 8, 128, 64, 1024, 0),
    (3, 9, 1, 80, 16, 32, 40, 0),
    (3, 130, 4, 1, 192, 128, 256, 0),
    (2, 256, 2, 8, 128, 128, 1024, 0),
    (2, 1, 2, 8, 8, 16, 24, 0),
    (1, 1, 1, 1, 8, 8, 0, 0),
    (3, 70, 1, 1, 12, 20, 33, 0),
    (2, 21, 1, 3, 7, 5, 9, 0),
    (3, 50, 2, 4, 256, 256, 100, 0),
    (3, 45, 1, 2, 64, 192, 64, 0),
    (3, 37, 2, 4, 128, 128, 80, 2),
    (3, 37, 2, 4, 128, 128, 80, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,Hk,G,hd,hdv,L,offset", MMA_CASES)
def test_prefix_prefill_mma_kernel_matches_plain(cuda_device, B, T, Hk, G, hd, hdv, L, offset):
    rng = np.random.default_rng(B * 1000 + T + G + hd + L + offset)
    bf = torch.bfloat16

    def rand(*shape):
        return _offset(_rand(rng, shape, bf, cuda_device), offset)

    q = _rand(rng, (B, T, Hk * G, hd), bf, cuda_device)
    q[:, T // 2 + 1:] = 0                          # rows of zero queries stay finite
    q = _offset(q, offset)
    kt, vt = rand(B, T, Hk, hd), rand(B, T, Hk, hdv)
    if L:
        kc, vc = rand(B, L, Hk, hd), rand(B, L, Hk, hdv)
        ctx = rng.integers(1, L + 1, B).astype(np.int32)
        ctx[0], ctx[-1] = 0, L
    else:
        kc = vc = None
        ctx = np.zeros(B, np.int32)
    ctx = torch.from_numpy(ctx).to(cuda_device)
    before = dict(cuda_lib.launches)
    got = ops.prefix_prefill(q, kc, vc, kt, vt, ctx)
    torch.cuda.synchronize()
    assert cuda_lib.launches["prefix_prefill"] == before["prefix_prefill"] + 1
    assert cuda_lib.launches["prefix_prefill_mma"] == before["prefix_prefill_mma"] + 1
    assert got.shape == (B, T, Hk * G, hdv)
    _close(got, ref.prefix_prefill_ref(q, kc, vc, kt, vt, ctx), bf)


# --- K4's tensor-core kernel: bf16 q and pages -----------------------------------------
# (B, Hk, G, hd, hdv, page, nb, offset): qwen's decode shape; G 1, 3, 8,
# 20 and 80 (two and five 16-row tiles); hd 7 (element copies), 12/20
# (4-byte copies), 64, 128 and 256, hdv != hd in four; page 1, 3, 16 and
# 64; nb 1 and 256 (4096 keys at page 16); B 1 and 64; rows that start 1
# or 2 elements past a 16-byte boundary.  Each launch with B >= 4 holds a
# full slot, a split's last key, the key one past it, and an inactive
# slot on the garbage page at position 0.
DECODE_MMA_CASES = [
    (4, 2, 8, 128, 128, 16, 64, 0),
    (4, 1, 1, 64, 64, 16, 256, 0),
    (4, 1, 3, 7, 5, 3, 40, 0),
    (5, 2, 20, 64, 32, 1, 256, 0),
    (4, 1, 80, 128, 64, 64, 4, 0),
    (4, 2, 4, 256, 256, 16, 8, 0),
    (4, 1, 3, 12, 20, 16, 9, 0),
    (1, 2, 8, 128, 128, 16, 1, 0),
    (64, 2, 8, 128, 128, 16, 16, 0),
    (4, 2, 8, 128, 128, 16, 64, 1),
    (4, 2, 8, 128, 128, 16, 64, 2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hk,G,hd,hdv,page,nb,offset", DECODE_MMA_CASES)
def test_paged_decode_gqa_mma_kernel_matches_plain(cuda_device, B, Hk, G, hd, hdv, page, nb,
                                                   offset):
    from repro_torch.kernels.paged_attention import decode_split

    rng = np.random.default_rng(B * 1000 + G + hd + page + nb + offset)
    bf = torch.bfloat16
    n_pages = 1 + B * nb + 2
    kp = _offset(_rand(rng, (n_pages, page, Hk, hd), bf, cuda_device), offset)
    vp = _offset(_rand(rng, (n_pages, page, Hk, hdv), bf, cuda_device), offset)
    q = _offset(_rand(rng, (B, 1, Hk * G, hd), bf, cuda_device), offset)
    bt = rng.permutation(np.arange(1, n_pages))[:B * nb].reshape(B, nb).astype(np.int32)
    pos = rng.integers(0, nb * page, B).astype(np.int32)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    kps = decode_split(B, Hk, G, page, nb, sms) * page
    pos[0] = nb * page - 1
    if B >= 4:
        pos[1:3] = np.minimum([kps - 1, kps], nb * page - 1)
        bt[-1], pos[-1] = 0, 0                   # an inactive slot: all garbage page
    bt, pos = torch.from_numpy(bt).to(cuda_device), torch.from_numpy(pos).to(cuda_device)
    before = dict(cuda_lib.launches)
    got = ops.paged_decode_gqa(q, kp, vp, bt, pos)
    torch.cuda.synchronize()
    assert cuda_lib.launches["paged_decode_gqa"] == before["paged_decode_gqa"] + 1
    assert cuda_lib.launches["paged_decode_gqa_mma"] == before["paged_decode_gqa_mma"] + 1
    assert got.shape == (B, 1, Hk * G, hdv)
    _close(got, ref.paged_decode_gqa_ref(q, kp, vp, bt, pos), bf)


# --- K6: paged absorbed-MLA decode ----------------------------------------------------
# Against the plain version on the same card, both in float32 to within
# the tensor cores' f32 accumulation.  bf16 pages take the split walk on
# bf16 mma.sync: the pages are exact bf16 operands, and q_abs (an f32
# q_rope too) and the softmax weights are cut into three bf16 planes that
# sum exactly to the f32 values, so every plane product is exact in f32
# and the kernel differs from the plain version by summation order only
# (scores, the online softmax's and the merge's rescaling).  f32 pages
# take the CUDA-core kernel, f32 throughout.  A few float32 ulps of
# outputs of magnitude ~1-3.
MLA_TOL = 1e-5


def _mla_inputs(rng, B, H, r, dr, page, nb, qrdt, kvdt, dev):
    n_pages = 1 + B * nb + 2
    cp, rp = _rand(rng, (n_pages, page, r), kvdt, dev), _rand(rng, (n_pages, page, dr), kvdt, dev)
    bt = rng.permutation(np.arange(1, n_pages))[:B * nb].reshape(B, nb).astype(np.int32)
    bt[-1] = 0                                   # an inactive slot: all garbage page
    pos = rng.integers(0, nb * page, B).astype(np.int32)
    pos[-1] = 0                                  # ... at position 0
    pos[0] = nb * page - 1                       # a full slot
    if B > 2:
        pos[1] = min(page, nb * page - 1)        # the first key of its second page
    if B > 3:
        pos[2] = page - 1                        # the last key of its first page
    qa = _rand(rng, (B, 1, H, r), torch.float32, dev)
    qr = _rand(rng, (B, 1, H, dr), qrdt, dev)
    return (qa, qr, cp, rp, torch.from_numpy(bt).to(dev), torch.from_numpy(pos).to(dev),
            1.0 / np.sqrt(r + dr))


def _mla_check(args):
    """One launch against the plain version, and the launch counts: one
    more ``paged_decode_mla``, and one more ``paged_decode_mla_mma`` where
    the pages are bf16."""
    mma = args[2].dtype == torch.bfloat16
    before = dict(cuda_lib.launches)
    got = ops.paged_decode_mla(*args)
    torch.cuda.synchronize()
    assert cuda_lib.launches["paged_decode_mla"] == before["paged_decode_mla"] + 1
    assert (cuda_lib.launches["paged_decode_mla_mma"]
            == before["paged_decode_mla_mma"] + int(mma))
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.paged_decode_mla_ref(*args), rtol=MLA_TOL, atol=MLA_TOL)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("qrdt,kvdt", [(torch.float32, torch.float32),
                                       (torch.float32, torch.bfloat16),
                                       (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("B,H,r,dr,page,nb", [(3, 4, 16, 8, 8, 3), (4, 16, 512, 64, 16, 8),
                                              (4, 128, 512, 64, 16, 64), (2, 16, 16, 64, 16, 5),
                                              (5, 128, 512, 8, 8, 40), (3, 4, 40, 12, 16, 2),
                                              (2, 8, 1024, 128, 16, 4)])
def test_paged_decode_mla_kernel_matches_plain(cuda_device, qrdt, kvdt, B, H, r, dr, page, nb):
    _mla_check(_mla_inputs(np.random.default_rng(B * 7 + H + r), B, H, r, dr, page, nb, qrdt,
                           kvdt, cuda_device))


# The split walk at the serve's shape (4 slots, 128 heads, r 512, dr 64,
# 16-row pages, 64 pages a slot) with the slots at split and tile
# boundaries: the last key of a split and the first of the next (127 and
# 128 where a split is 128 keys, and the split found for this card), the
# last key of a 64-key tile and the first of the next, a full slot.
@pytest.mark.gpu
@pytest.mark.parametrize("qrdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("at", ["split", "tile"])
def test_paged_decode_mla_split_boundaries(cuda_device, qrdt, at):
    B, H, r, dr, page, nb = 4, 128, 512, 64, 16, 64
    args = list(_mla_inputs(np.random.default_rng(31), B, H, r, dr, page, nb, qrdt,
                            torch.bfloat16, cuda_device))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    kps = paged_attention.mla_decode_split(B, H, r, dr, page, nb, sms) * page
    pos = [127, 128, nb * page - 1, kps] if at == "split" else [63, 64, kps - 1, 191]
    args[5] = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    _mla_check(tuple(args))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged_heads", "short_last_split", "wide_exponents",
                                  "peaked", "dr12", "odd_widths", "rank1024"])
def test_paged_decode_mla_split_walk_cases(cuda_device, case):
    """bf16 pages: H 20 (a ragged second row tile); 13 pages a slot, not a
    whole number of splits; q_abs of magnitudes 2^-20 to 2^4 (all three
    planes non-zero); a peaked softmax (scores x 10 on q_abs of a quarter
    the unit scale: logits of std ~2.5, a few keys carry each row); dr 12
    (rows off 16-byte alignment: 4-byte copies); r 17 / dr 5 (element
    copies of the pages, 4-byte copies of q_abs, element loads of
    q_rope); r 1024 / dr 128 (32-key tiles, one stage).  Unit-scale q_abs
    x 10 (logits of std ~10) is past any float32 comparison at MLA_TOL:
    the rounding of scores that large moves the output by more, in the
    plain version as in the kernel."""
    shape = {"ragged_heads": (3, 20, 512, 64, 16, 8),
             "short_last_split": (2, 16, 64, 16, 16, 13),
             "wide_exponents": (3, 32, 512, 64, 16, 8), "peaked": (3, 32, 512, 64, 16, 8),
             "dr12": (3, 24, 40, 12, 16, 6), "odd_widths": (3, 8, 17, 5, 16, 6),
             "rank1024": (3, 16, 1024, 128, 16, 6)}[case]
    for qrdt in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(len(case))
        args = list(_mla_inputs(rng, *shape, qrdt, torch.bfloat16, cuda_device))
        if case == "wide_exponents":
            q = rng.choice([-1.0, 1.0], shape[:2] + (shape[2],)) * np.exp2(
                rng.uniform(-20.0, 4.0, shape[:2] + (shape[2],)))
            args[0] = torch.from_numpy(q.astype(np.float32)[:, None]).to(cuda_device)
        if case == "peaked":
            args[0], args[6] = args[0] * 0.25, args[6] * 10.0
        _mla_check(tuple(args))


@pytest.mark.gpu
def test_paged_decode_mla_split_walk_is_deterministic(cuda_device):
    """No atomics: two calls at the serve's shape give the same bits."""
    args = _mla_inputs(np.random.default_rng(8), 4, 128, 512, 64, 16, 64, torch.bfloat16,
                       torch.bfloat16, cuda_device)
    first = _mla_check(args)
    assert torch.equal(first, _mla_check(args))


@pytest.mark.gpu
def test_paged_decode_mla_wrapper_rejects_what_it_does_not_take(cuda_device):
    qa, qr, cp, rp, bt, pos, scale = _mla_inputs(np.random.default_rng(0), 2, 4, 32, 16, 4, 2,
                                                 torch.float32, torch.float32, cuda_device)
    d = cuda_device
    before = dict(cuda_lib.launches)
    with pytest.raises(ValueError):               # bfloat16 q_abs
        ops.paged_decode_mla(qa.bfloat16(), qr, cp, rp, bt, pos, scale)
    with pytest.raises(ValueError):               # c_kv and k_rope of different dtypes
        ops.paged_decode_mla(qa, qr, cp, rp.bfloat16(), bt, pos, scale)
    with pytest.raises(ValueError):               # not contiguous
        ops.paged_decode_mla(qa.transpose(0, 2).contiguous().transpose(0, 2), qr, cp, rp, bt,
                             pos, scale)
    with pytest.raises(ValueError):               # int64 positions
        ops.paged_decode_mla(qa, qr, cp, rp, bt, pos.long(), scale)
    with pytest.raises(ValueError):               # pages of another rank than q_abs
        ops.paged_decode_mla(qa, qr, cp[..., :16].contiguous(), rp, bt, pos, scale)
    with pytest.raises(ValueError):               # rank past MAX_RANK
        ops.paged_decode_mla(torch.zeros((2, 1, 4, 1040), device=d), qr,
                             torch.zeros((cp.shape[0], 4, 1040), device=d), rp, bt, pos, scale)
    with pytest.raises(ValueError):               # rope dim past MAX_ROPE_DIM
        ops.paged_decode_mla(qa, torch.zeros((2, 1, 4, 136), device=d), cp,
                             torch.zeros((rp.shape[0], 4, 136), device=d), bt, pos, scale)
    with pytest.raises(ValueError):               # block table on the CPU
        ops.paged_decode_mla(qa, qr, cp, rp, bt.cpu(), pos, scale)
    assert cuda_lib.launches == before


# --- K7: the selective scan ---------------------------------------------------------
# Against the plain version on the same card, both float32 (a bf16 u is
# widened exactly on both sides): the kernel takes exp(dt A) as exp2 of
# dt * (A log2 e) on the SFUs, h with a fused multiply-add and the N-sum
# as per-lane partials folded by shuffles, a few ulps of |y| apart; the
# recurrence contracts (|exp(dt A)| <= 1), so the differences do not grow
# along S.
SCAN_TOL = 1e-5
U_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _scan_inputs(rng, B, S, D, N, dev, u_type="float32"):
    """The model's ranges: dt log-uniform in [1e-3, 1e-1], A = -(1..N)
    per channel times a random factor, unit-normal u (of ``u_type``), B,
    C, D and h0."""
    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)

    return (t(rng.standard_normal((B, S, D))).to(U_TYPES[u_type]),
            t(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, D)))),
            t(rng.standard_normal((B, S, N))), t(rng.standard_normal((B, S, N))),
            t(-np.arange(1, N + 1) * rng.uniform(0.5, 1.5, (D, 1))),
            t(rng.standard_normal(D))), t(rng.standard_normal((B, D, N)))


def _scan_and_check(args, h0):
    """One launch against the plain version (u widened to float32), and
    the launch counts: one more ``selective_scan``, and one more
    ``selective_scan_bf16u`` where u is bf16."""
    u_bf16 = args[0].dtype == torch.bfloat16
    before = dict(cuda_lib.launches)
    y, h = ops.selective_scan(*args, h0)
    torch.cuda.synchronize()
    assert cuda_lib.launches["selective_scan"] == before["selective_scan"] + 1
    assert (cuda_lib.launches["selective_scan_bf16u"]
            == before["selective_scan_bf16u"] + int(u_bf16))
    want_y, want_h = ref.selective_scan_ref(args[0].float(), *args[1:], h0)
    for got, want in ((y, want_y), (h, want_h)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=SCAN_TOL, atol=SCAN_TOL)


# D 130 (bf16 rows of 260 bytes: 4-byte copies; f32: 520), 129 (bf16:
# element copies), 200 (16-byte copies, a ragged last CTA), 1; S 0, 1, 17
# (a ragged last chunk), 512; N 8 and 16; the serve's shape last.
@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D,N", [(2, 1, 130, 8), (3, 37, 200, 16), (2, 512, 256, 16),
                                     (1, 37, 64, 8), (2, 0, 130, 16), (2, 17, 1, 8),
                                     (1, 17, 1, 16), (2, 17, 129, 16), (3, 512, 130, 8),
                                     (2, 17, 200, 8), (4, 512, 8192, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("u_type", list(U_TYPES))
def test_selective_scan_kernel_matches_plain(cuda_device, B, S, D, N, with_h0, u_type):
    args, h0 = _scan_inputs(np.random.default_rng(B + S + D + N), B, S, D, N, cuda_device,
                            u_type)
    _scan_and_check(args, h0 if with_h0 else None)


@pytest.mark.gpu
@pytest.mark.parametrize("u_type", list(U_TYPES))
def test_selective_scan_kernel_takes_unaligned_operands(cuda_device, u_type):
    """Contiguous operands whose storage starts off 16-byte (u: off 4-byte
    in bf16) alignment take the narrower copies."""
    args, h0 = _scan_inputs(np.random.default_rng(9), 2, 40, 136, 16, cuda_device, u_type)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        v = buf[1:].view(x.shape)
        v.copy_(x)
        assert v.is_contiguous() and v.data_ptr() % 16
        return v

    _scan_and_check([shifted(a) for a in args[:4]] + list(args[4:]), shifted(h0))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("u_type", list(U_TYPES))
def test_selective_scan_kernel_carries_state_through_dt_zero(cuda_device, N, u_type):
    """Steps with dt = 0 (the caller's padding) leave h bit for bit."""
    (u, dt, Bc, Cc, A, Ds), h0 = _scan_inputs(np.random.default_rng(N), 2, 40, 150, N,
                                              cuda_device, u_type)
    dt[:, 17:40] = 0.0
    _, h_short = ops.selective_scan(u[:, :17].contiguous(), dt[:, :17].contiguous(),
                                    Bc[:, :17].contiguous(), Cc[:, :17].contiguous(), A, Ds, h0)
    _, h_long = ops.selective_scan(u, dt, Bc, Cc, A, Ds, h0)
    torch.cuda.synchronize()
    assert torch.equal(h_short, h_long)


@pytest.mark.gpu
def test_selective_scan_wrapper_rejects_what_it_does_not_take(cuda_device):
    args, h0 = _scan_inputs(np.random.default_rng(0), 2, 8, 32, 16, cuda_device)
    u, dt, Bc, Cc, A, Ds = args
    before = dict(cuda_lib.launches)
    with pytest.raises(ValueError):               # not contiguous
        ops.selective_scan(u.transpose(0, 1).contiguous().transpose(0, 1), dt, Bc, Cc, A, Ds)
    with pytest.raises(ValueError):               # A on the CPU
        ops.selective_scan(u, dt, Bc, Cc, A.cpu(), Ds)
    with pytest.raises(ValueError):               # A on the CPU, with a bf16 u
        ops.selective_scan(u.to(torch.bfloat16), dt, Bc, Cc, A.cpu(), Ds)
    with pytest.raises(ValueError):               # h0 on the CPU
        ops.selective_scan(u, dt, Bc, Cc, A, Ds, h0.cpu())
    with pytest.raises(ValueError):               # N = 4: no kernel instance
        ops.selective_scan(u, dt, Bc[..., :4].contiguous(), Cc[..., :4].contiguous(),
                           A[:, :4].contiguous(), Ds)
    with pytest.raises(ValueError):               # A of another width than B/C
        ops.selective_scan(u, dt, Bc, Cc, A[:, :8].contiguous(), Ds)
    assert cuda_lib.launches == before


@pytest.mark.gpu
def test_dcim_sim_matmul_takes_any_layout(cuda_device):
    """A projection's input may come transposed (the SSM decode's conv is
    an einsum's output): the macro's matmul takes it as torch.matmul does."""
    from repro_torch.core.precision import get
    from repro_torch.sim.functional import DCIMMacroSim

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((300, 4), dtype=np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.standard_normal((300, 72), dtype=np.float32)).to(cuda_device)
    xt = x.t()[:, None]                          # (4, 1, 300), strides (1, ., 4)
    assert not xt.is_contiguous()
    for prec in ("int8", "bf16"):
        sim = DCIMMacroSim(get(prec), N=64, H=32, L=8, k=4)
        assert torch.equal(sim.matmul(xt, w), sim.matmul(xt.contiguous(), w))
        assert torch.equal(sim.matmul(xt.contiguous(), w.t().contiguous().t()),
                           sim.matmul(xt.contiguous(), w))
