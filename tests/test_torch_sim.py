"""The macro simulator against the JAX reference, on the reference's own
weights: ``wq`` of ``lm.init(PRNGKey(0), get_smoke_config("qwen2.5-3b"))``,
carried across by ``bridge.params_from_numpy``.

``quantize_sym`` and the integer path are bitwise.  The block-FP path is
held to RTOL_FP: the reference scales each group by ``jnp.exp2``, up to
4.05e-6 relative off for integer exponents on XLA's CPU, where
``torch.exp2`` is exact, and the two packages sum the G group partials
in different orders.  ``account`` goes through the cost model, whose
delay differs by 1-2 float32 ulp (see test_torch_cost_model.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro import configs as jconfigs
from repro.core.precision import get as jget
from repro.models import lm
from repro.sim.functional import DCIMMacroSim as JSim
from repro.sim.functional import quantize_sym as jquant
from repro_torch import bridge
from repro_torch.core.explorer import ParetoPoint
from repro_torch.core.precision import get as tget
from repro_torch.sim.functional import DCIMMacroSim as TSim
from repro_torch.sim.functional import quantize_sym as tquant

RTOL_FP = 2e-5


@pytest.fixture(scope="module")
def wq():
    cfg = jconfigs.get_smoke_config("qwen2.5-3b")
    params = jax.tree.map(np.asarray, lm.init(jax.random.PRNGKey(0), cfg))
    jw = params["blocks"][0]["mixer"]["wq"]["w"][0]
    tw = bridge.params_from_numpy(params, "cpu")["blocks"][0]["mixer"]["wq"]["w"][0]
    assert isinstance(tw, torch.Tensor) and tw.shape == jw.shape
    np.testing.assert_array_equal(tw.numpy(), jw)
    return jw, tw


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).normal(size=(2, 3, 64)).astype(np.float32)


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_quantize_sym_bitwise(wq, x, bits):
    for a in (wq[0], x):
        qj, sj = jquant(jnp.asarray(a), bits)
        qt, st = tquant(torch.from_numpy(np.array(a)), bits)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert float(st) == float(sj)


@pytest.mark.parametrize("prec,k", [("int8", 4), ("int4", 1), ("int16", 16)])
def test_integer_path_bitwise(wq, x, prec, k):
    jw, tw = wq
    js, ts = JSim(jget(prec), N=64, H=64, L=8, k=k), TSim(tget(prec), N=64, H=64, L=8, k=k)
    np.testing.assert_array_equal(ts.mvm(torch.from_numpy(x[0]), tw).numpy(),
                                  np.asarray(js.mvm(jnp.asarray(x[0]), jnp.asarray(jw))))
    got = ts.matmul(torch.from_numpy(x), tw)
    assert got.shape == (2, 3, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(js.matmul(jnp.asarray(x), jnp.asarray(jw))))


@pytest.mark.parametrize("prec,H,k", [("fp8", 16, 2), ("bf16", 32, 1), ("fp16", 64, 4),
                                      ("fp32", 8, 16), ("bf16", 48, 4)])
def test_fp_path_within_rtol(wq, x, prec, H, k):
    jw, tw = wq
    js, ts = JSim(jget(prec), N=64, H=H, L=4, k=k), TSim(tget(prec), N=64, H=H, L=4, k=k)
    want = np.asarray(js.matmul(jnp.asarray(x), jnp.asarray(jw)))
    got = ts.matmul(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_FP, atol=RTOL_FP * np.abs(want).max())
    np.testing.assert_allclose(ts.mvm_fp(torch.from_numpy(x[1]), tw).numpy(), want[1],
                               rtol=RTOL_FP, atol=RTOL_FP * np.abs(want).max())


def test_precision_kind_is_checked(wq):
    _, tw = wq
    with pytest.raises(ValueError):
        TSim(tget("bf16"), N=64, H=16, L=4, k=1).mvm(tw[:2], tw)
    with pytest.raises(ValueError):
        TSim(tget("int8"), N=64, H=16, L=4, k=1).mvm_fp(tw[:2], tw)


@pytest.mark.parametrize("prec,N,H,L,k", [("int8", 64, 32, 64, 1), ("bf16", 128, 16, 8, 2),
                                          ("fp32", 256, 64, 4, 8)])
def test_account_and_from_point(prec, N, H, L, k):
    js, ts = JSim(jget(prec), N, H, L, k, activity=0.1), TSim(tget(prec), N, H, L, k, activity=0.1)
    assert ts.w_store == js.w_store
    for M, K, Nout in ((1, 2048, 151936), (128, 11008, 2048), (3, 5, 7)):
        a, b = ts.account(M, K, Nout), js.account(M, K, Nout)
        assert a.keys() == b.keys()
        for key in ("cycles", "macs", "weight_loads"):
            assert a[key] == b[key]
        for key in ("latency_us", "energy_uJ", "tops_effective"):
            assert a[key] == pytest.approx(b[key], rel=1e-6)
    pt = ParetoPoint(prec, ts.w_store, N, H, L, k, np.zeros(3, np.int32),
                     *([1.0] * 10))
    assert TSim.from_point(pt) == TSim(tget(prec), N, H, L, k)
