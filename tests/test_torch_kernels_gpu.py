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
