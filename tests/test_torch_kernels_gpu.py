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

from repro_torch.kernels import cuda_lib, ops, ref
from repro_torch.kernels.dcim_mvm import dcim_mvm
from repro_torch.kernels.fp_prealign import fp_prealign


def _ints(rng, shape, bits, signed):
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed else (0, 1 << bits)
    return rng.integers(lo, hi, size=shape).astype(np.int32)


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


@pytest.mark.gpu
@pytest.mark.parametrize("B_x,B_w,k,x_signed,w_signed", [
    (8, 8, 4, True, True), (8, 8, 1, True, False), (16, 16, 4, True, True),
    (16, 16, 16, False, True), (9, 9, 1, True, True), (14, 12, 16, True, False),
    (2, 2, 1, False, False),
])
def test_dcim_mvm_kernel_matches_plain(cuda_device, B_x, B_w, k, x_signed, w_signed):
    rng = np.random.default_rng(B_x + B_w + k)
    x = torch.from_numpy(_ints(rng, (3, 70, 45), B_x, x_signed)).to(cuda_device)
    w = torch.from_numpy(_ints(rng, (3, 45, 130), B_w, w_signed)).to(cuda_device)
    kw = dict(B_x=B_x, B_w=B_w, k=k, x_signed=x_signed, w_signed=w_signed)
    before = cuda_lib.launches["dcim_mvm"]
    got = dcim_mvm(x, w, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.launches["dcim_mvm"] == before + 1
    assert torch.equal(got, ref.dcim_mvm_ref(x, w, **kw))
    assert torch.equal(dcim_mvm(x[0], w[0], **kw), got[0])


@pytest.mark.gpu
@pytest.mark.parametrize("H", [1, 2, 16, 32, 33, 256])
@pytest.mark.parametrize("B_M", [4, 8, 24])
def test_fp_prealign_kernel_matches_plain(cuda_device, H, B_M):
    x = torch.from_numpy(_fp_inputs(np.random.default_rng(H), (37, 5, H))).to(cuda_device)
    got = fp_prealign(x, B_M=B_M)
    want = ref.fp_prealign_ref(x, B_M=B_M)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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
    before = cuda_lib.launches["paged_decode_gqa"]
    got = ops.paged_decode_gqa(q, kp, vp, bt, pos)
    torch.cuda.synchronize()
    assert cuda_lib.launches["paged_decode_gqa"] == before + 1
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
    before = cuda_lib.launches["prefix_prefill"]
    got = ops.prefix_prefill(q, kc, vc, kt, vt, ctx)
    torch.cuda.synchronize()
    assert cuda_lib.launches["prefix_prefill"] == before + 1
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
    before = cuda_lib.launches["prefix_prefill"]
    got = ops.prefix_prefill(q, kc, vc, kt, vt, ctx)
    torch.cuda.synchronize()
    assert cuda_lib.launches["prefix_prefill"] == before + 1
    assert got.shape == (B, T, H, hdv)
    _close(got, ref.prefix_prefill_ref(q, kc, vc, kt, vt, ctx), kvdt)


# --- K6: paged absorbed-MLA decode ----------------------------------------------------
# Against the plain version on the same card: both widen the pages and
# q_rope to float32 and compute in float32 (the kernel rounds nothing to
# the page type), so they differ only by summation order and the online
# softmax's rescaling, a few float32 ulps of outputs of magnitude ~1-3.
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


@pytest.mark.gpu
@pytest.mark.parametrize("qrdt,kvdt", [(torch.float32, torch.float32),
                                       (torch.float32, torch.bfloat16),
                                       (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("B,H,r,dr,page,nb", [(3, 4, 16, 8, 8, 3), (4, 16, 512, 64, 16, 8),
                                              (4, 128, 512, 64, 16, 64), (2, 16, 16, 64, 16, 5),
                                              (5, 128, 512, 8, 8, 40), (3, 4, 40, 12, 16, 2),
                                              (2, 8, 1024, 128, 16, 4)])
def test_paged_decode_mla_kernel_matches_plain(cuda_device, qrdt, kvdt, B, H, r, dr, page, nb):
    args = _mla_inputs(np.random.default_rng(B * 7 + H + r), B, H, r, dr, page, nb, qrdt,
                       kvdt, cuda_device)
    before = cuda_lib.launches["paged_decode_mla"]
    got = ops.paged_decode_mla(*args)
    torch.cuda.synchronize()
    assert cuda_lib.launches["paged_decode_mla"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, r)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.paged_decode_mla_ref(*args), rtol=MLA_TOL, atol=MLA_TOL)


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
# Against the plain version on the same card, both float32: the kernel
# takes exp(dt A) h + (dt u) B with a fused multiply-add and the N-sum in
# its own order, a few ulps of |y| apart; the recurrence contracts
# (|exp(dt A)| <= 1), so the differences do not grow along S.
SCAN_TOL = 1e-5


def _scan_inputs(rng, B, S, D, N, dev):
    """The model's ranges: dt log-uniform in [1e-3, 1e-1], A = -(1..N)
    per channel times a random factor, unit-normal u, B, C, D and h0."""
    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)

    return (t(rng.standard_normal((B, S, D))),
            t(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, D)))),
            t(rng.standard_normal((B, S, N))), t(rng.standard_normal((B, S, N))),
            t(-np.arange(1, N + 1) * rng.uniform(0.5, 1.5, (D, 1))),
            t(rng.standard_normal(D))), t(rng.standard_normal((B, D, N)))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D,N", [(2, 1, 130, 8), (3, 37, 200, 16), (2, 512, 256, 16),
                                     (1, 37, 64, 8), (4, 512, 8192, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_kernel_matches_plain(cuda_device, B, S, D, N, with_h0):
    args, h0 = _scan_inputs(np.random.default_rng(B + S + D + N), B, S, D, N, cuda_device)
    h0 = h0 if with_h0 else None
    before = cuda_lib.launches["selective_scan"]
    y, h = ops.selective_scan(*args, h0)
    torch.cuda.synchronize()
    assert cuda_lib.launches["selective_scan"] == before + 1
    want_y, want_h = ref.selective_scan_ref(*args, h0)
    for got, want in ((y, want_y), (h, want_h)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [8, 16])
def test_selective_scan_kernel_carries_state_through_dt_zero(cuda_device, N):
    """Steps with dt = 0 (the caller's padding) leave h bit for bit."""
    (u, dt, Bc, Cc, A, Ds), h0 = _scan_inputs(np.random.default_rng(N), 2, 40, 150, N,
                                              cuda_device)
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
