"""The port's Mamba-1 mixer and K7's plain version against the JAX
reference, on the CPU.

* Kernel level: ``ref.selective_scan_ref`` against the reference's
  sequential oracle ``repro.kernels.ref.selective_scan_ref`` and against
  its Pallas kernel in interpret mode, with and without h0, at N 8 and
  16 and S not a multiple of 8.
* Module level (falcon-mamba-7b smoke, the reference's ``lm.init``
  params through ``bridge``, conv bias and D skip redrawn from a numpy
  seed so that both count): ``mamba_mix`` for both ``ssm_impl`` values
  with ``valid_len`` None, an int and a (B,) vector — the output, the
  post-prompt state h and the conv tail; ``mamba_step`` chained over
  several steps from that state.

Tolerance: RTOL = ATOL = 1e-5.  Both sides compute in float32 but take
``exp`` and the N-sum (and, for the associative scan, the combine tree)
in another order, ~1e-7 apart at these magnitudes; the recurrence
contracts (|exp(dt A)| <= 1), so the differences do not grow along S.
The conv tail is a slice of the same float32 projection: bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan_pallas
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro_torch import bridge, configs
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "falcon-mamba-7b"


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _scan_inputs(rng, B, S, D, N, with_h0):
    """Inputs in the ranges the model feeds the scan: dt log-uniform in
    [1e-3, 1e-1] (softplus of the init's dt_bias), A = -(1..N) per
    channel (S4D-real) times a random factor, unit-normal u, B, C."""
    f32 = np.float32
    args = [rng.standard_normal((B, S, D)).astype(f32),
            np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, D))).astype(f32),
            rng.standard_normal((B, S, N)).astype(f32),
            rng.standard_normal((B, S, N)).astype(f32),
            (-np.arange(1, N + 1) * rng.uniform(0.5, 1.5, (D, 1))).astype(f32),
            rng.standard_normal(D).astype(f32)]
    h0 = rng.standard_normal((B, D, N)).astype(f32) if with_h0 else None
    return args, h0


@pytest.mark.parametrize("B,S,D,N", [(2, 37, 24, 8), (1, 16, 32, 16), (3, 5, 16, 8),
                                     (2, 1, 8, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_plain_matches_reference(B, S, D, N, with_h0):
    args, h0 = _scan_inputs(np.random.default_rng(B * S + D + N), B, S, D, N, with_h0)
    ty, th = ops.selective_scan(*map(torch.from_numpy, args),
                                None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == th.dtype == torch.float32
    assert tuple(ty.shape) == (B, S, D) and tuple(th.shape) == (B, D, N)
    jargs = [jnp.asarray(a) for a in args]
    jh0 = None if h0 is None else jnp.asarray(h0)
    jy, jh = jref.selective_scan_ref(*jargs, h0=jh0)
    _close(ty, jy)
    _close(th, jh)
    py, ph = selective_scan_pallas(*jargs, h0=jh0, interpret=True)
    _close(ty, py)
    _close(th, ph)


def test_selective_scan_plain_carries_state_through_dt_zero():
    """A run of dt = 0 steps is the identity on h (the padding contract)."""
    args, h0 = _scan_inputs(np.random.default_rng(7), 2, 9, 16, 8, True)
    args[1][:, 3:7] = 0.0
    u, dt, Bc, Cc, A, Ds = map(torch.from_numpy, args)
    _, h_a = ref.selective_scan_ref(u[:, :3], dt[:, :3], Bc[:, :3], Cc[:, :3], A, Ds,
                                    torch.from_numpy(h0))
    _, h_b = ref.selective_scan_ref(u[:, :7], dt[:, :7], Bc[:, :7], Cc[:, :7], A, Ds,
                                    torch.from_numpy(h0))
    assert torch.equal(h_a, h_b)


# --- the mixer ------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mixer():
    """Layer 0's mixer params of the smoke model, in both packages."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    tcfg = configs.get_smoke_config(ARCH)
    params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg))
    p = jax.tree.map(lambda a: np.array(a[0]), params["blocks"][0]["mixer"])
    rng = np.random.default_rng(3)
    p["conv_b"] = (rng.standard_normal(p["conv_b"].shape) * 0.1).astype(np.float32)
    p["D"] = rng.uniform(0.5, 1.5, p["D"].shape).astype(np.float32)
    return jcfg, tcfg, p, bridge.params_from_numpy(p, "cpu")


VALID_LENS = {"none": None, "int": 9, "vector": np.asarray([13, 5, 0], np.int32)}


@pytest.mark.parametrize("impl", ["pallas", "assoc"])
@pytest.mark.parametrize("vl_kind", list(VALID_LENS))
def test_mamba_mix_matches_reference(mixer, impl, vl_kind):
    jcfg, tcfg, jp, tp = mixer
    jcfg = dataclasses.replace(jcfg, ssm_impl=impl)
    tcfg = dataclasses.replace(tcfg, ssm_impl=impl)
    vl = VALID_LENS[vl_kind]
    x = np.random.default_rng(11).standard_normal((3, 13, jcfg.d_model)).astype(np.float32)
    jout, jst = jmamba.mamba_mix(jp, jnp.asarray(x), jcfg, jcfg.mamba_chunk, return_state=True,
                                 training=False,
                                 valid_len=None if vl is None else jnp.asarray(vl))
    tvl = torch.from_numpy(vl) if isinstance(vl, np.ndarray) else vl
    tout, tst = mamba.mamba_mix(tp, torch.from_numpy(x), tcfg, tcfg.mamba_chunk,
                                return_state=True, training=False, valid_len=tvl)
    if vl is None:
        _close(tout, jout)
    else:
        # Outputs at padded positions are unspecified: compare real ones.
        keep = np.arange(13)[None, :] < np.broadcast_to(vl, (3,))[:, None]
        np.testing.assert_allclose(tout.numpy()[keep], np.asarray(jout)[keep], **TOL)
    _close(tst["h"], jst["h"])
    np.testing.assert_array_equal(tst["conv"].numpy(), np.asarray(jst["conv"]))


def test_mamba_mix_impls_agree_and_training_takes_assoc(mixer, monkeypatch):
    """The kernel path and the associative scan compute one function;
    ``training=True`` keeps the associative scan (as the reference: its
    kernel has no gradient)."""
    _, tcfg, _, tp = mixer
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 17, tcfg.d_model)).astype(np.float32))
    outs = {impl: mamba.mamba_mix(tp, x, dataclasses.replace(tcfg, ssm_impl=impl),
                                  tcfg.mamba_chunk, return_state=True, training=False)
            for impl in ("pallas", "assoc")}
    torch.testing.assert_close(outs["pallas"][0], outs["assoc"][0], **TOL)
    torch.testing.assert_close(outs["pallas"][1]["h"], outs["assoc"][1]["h"], **TOL)
    calls = []
    real = mamba.selective_scan
    monkeypatch.setattr(mamba, "selective_scan",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    mamba.mamba_mix(tp, x, tcfg, tcfg.mamba_chunk, training=True)
    assert calls == []
    mamba.mamba_mix(tp, x, tcfg, tcfg.mamba_chunk, training=False)
    assert calls == [1]


def test_mamba_step_chain_matches_reference(mixer):
    jcfg, tcfg, jp, tp = mixer
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    _, jc = jmamba.mamba_mix(jp, jnp.asarray(x), jcfg, jcfg.mamba_chunk, return_state=True,
                             training=False)
    _, tc = mamba.mamba_mix(tp, torch.from_numpy(x), tcfg, tcfg.mamba_chunk,
                            return_state=True, training=False)
    for _ in range(5):
        step = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jout, jc = jmamba.mamba_step(jp, jnp.asarray(step), jcfg, jc)
        tout, tc = mamba.mamba_step(tp, torch.from_numpy(step), tcfg, tc)
        _close(tout, jout)
        _close(tc["h"], jc["h"])
        _close(tc["conv"], jc["conv"])


def test_mamba_cache_init_layout(mixer):
    jcfg, tcfg, _, _ = mixer
    want = jmamba.mamba_cache_init(jcfg, 3, jnp.bfloat16)
    got = mamba.mamba_cache_init(tcfg, 3, torch.bfloat16, "cpu", lead=())
    for name in ("h", "conv"):
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[1] == want[name].dtype.name
        assert not got[name].any()
