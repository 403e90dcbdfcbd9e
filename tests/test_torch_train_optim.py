"""The port's optimizers, schedule and int8 gradient compression against
the JAX reference, on the CPU.

Parameters (float32 leaves of several shapes, factored and not, and a
bfloat16 leaf) and three rounds of gradients spread over four decades are
drawn from a numpy seed; both packages run ``init``, then ``update`` and
``apply_updates`` three times.  Bounds, in units in the last place (ulp)
of the larger of the two values:

* moments (AdamW's m and v, the 8-bit scales, Adafactor's vr, vc, v)
  within MOMENT_ULPS = 8; 8-bit codes off by at most one;
* each update within UPDATE_ULPS = 16 (``b ** t``, ``t ** -decay``,
  ``sqrt`` and the means round differently on the two sides), counted in
  ulp of its larger term where the weight decay nearly cancels it;
  Adafactor's within RMS_CLIP_ULPS = 1024 (6e-5 relative): its RMS clip
  divides a whole leaf by the root of a mean of u^2 over up to 50,310
  values spread over eight decades, which XLA's CPU reduction sums with
  ~1e-5 relative error (up to 200 ulp seen over four seeds; torch sums
  pairwise);
* float32 parameters within PARAM_TOL = 1e-6 of the leaf's largest
  magnitude (a parameter near 0 takes its update's error, not its own);
  bfloat16 parameters within one bfloat16 ulp;
* ``cosine_warmup`` within SCHEDULE_ULPS = 2 at every step.

``compress_decompress`` is bitwise, over three rounds of error feedback.
The port's in-place ``apply`` gives the bits of its own ``update`` then
``apply_updates``.  The reference's own optimizer and compression tests
(``tests/test_train_substrate.py``) are carried over onto the port.
"""
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro import optim as joptim
from repro.optim import grad_compress as jgc
from repro.optim.adamw import apply_updates as japply_updates
from repro_torch import bridge, optim
from repro_torch.optim import grad_compress as gc
from repro_torch.optim.adamw import apply_updates

MOMENT_ULPS = 8
UPDATE_ULPS = 16
RMS_CLIP_ULPS = 1024
PARAM_TOL = 1e-6
SCHEDULE_ULPS = 2
SHAPES = {"a": (300, 200), "b": (7,), "c": (3, 130, 129), "d": (5, 1000)}


def _ulps(got, want, floor=0.0) -> float:
    """The largest difference in ulp of the larger magnitude (or of
    ``floor``, where larger: the size of a sum's terms)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    big = np.maximum(np.maximum(np.abs(got), np.abs(want)), floor).astype(np.float32)
    return float(np.max(np.abs(got - want) / np.spacing(big).astype(np.float64)))


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in SHAPES.items()}
    params["e"] = (rng.standard_normal((64, 256)) * 0.1).astype(ml_dtypes.bfloat16)
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.uniform(-4, 0, v.shape))
              .astype(v.dtype) for k, v in params.items()} for _ in range(3)]
    return params, grads


LR_WD = {"adamw": 1e-3 * 0.1, "adamw-schedule": 1e-3 * 0.1, "adamw8bit": 1e-3 * 0.1,
         "adafactor": 1e-2 * 0.01}           # lr x weight decay: the decay term's scale
OPTS = {
    "adamw": (lambda: joptim.adamw(1e-3), lambda: optim.adamw(1e-3)),
    "adamw-schedule": (lambda: joptim.adamw(joptim.cosine_warmup(1e-3, 2, 10)),
                       lambda: optim.adamw(optim.cosine_warmup(1e-3, 2, 10))),
    "adamw8bit": (lambda: joptim.get_optimizer("adamw8bit", 1e-3),
                  lambda: optim.get_optimizer("adamw8bit", 1e-3)),
    "adafactor": (lambda: joptim.adafactor(1e-2, weight_decay=0.01),
                  lambda: optim.adafactor(1e-2, weight_decay=0.01)),
}


def _run_port(opt, params, grads, in_place: bool):
    tp = bridge.params_from_numpy(params, "cpu")
    ts = opt.init(tp)
    for g in grads:
        tg = bridge.params_from_numpy(g, "cpu")
        if in_place:
            ts = opt.apply(tg, ts, tp)
        else:
            tu, ts = opt.update(tg, ts, tp)
            tp = apply_updates(tp, tu)
    return tp, ts, (None if in_place else tu)


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_reference(name):
    params, grads = _problem()
    jopt, topt = OPTS[name][0](), OPTS[name][1]()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = japply_updates(jp, ju)
    tp, ts, tu = _run_port(topt, params, grads, in_place=False)
    assert int(ts["step"]) == int(js["step"]) == 3 and ts["step"].dtype == torch.int32
    for k in params:
        want = np.asarray(jp[k]).astype(np.float32)
        terms = np.abs(np.asarray(ju[k])) + 2 * LR_WD[name] * np.abs(want)
        bound = RMS_CLIP_ULPS if name == "adafactor" else UPDATE_ULPS
        assert _ulps(tu[k].numpy(), ju[k], terms) <= bound, k
        got = tp[k].float().numpy()
        assert tp[k].dtype == (torch.bfloat16 if k == "e" else torch.float32)
        if k == "e":      # one bfloat16 ulp: 2^-8 of the value's binade
            assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7), k
        else:
            assert np.abs(got - want).max() <= PARAM_TOL * np.abs(want).max(), k
        assert set(ts["mu"][k]) == set(js["mu"][k])
        for mk, mv in js["mu"][k].items():
            t, m = ts["mu"][k][mk].numpy(), np.asarray(mv)
            assert t.dtype == m.dtype and t.shape == m.shape, (k, mk)
            if m.dtype == np.int8:
                assert np.abs(t.astype(np.int32) - m.astype(np.int32)).max() <= 1, (k, mk)
            else:
                assert _ulps(t, m) <= MOMENT_ULPS, (k, mk)
    # The in-place form: the same bits as update then apply_updates.
    ip, istate, _ = _run_port(OPTS[name][1](), params, grads, in_place=True)
    for k in params:
        assert torch.equal(ip[k], tp[k]), k
        for mk in ts["mu"][k]:
            assert torch.equal(istate["mu"][k][mk], ts["mu"][k][mk]), (k, mk)


@pytest.mark.parametrize("name", ["adamw", "adamw-schedule"])
def test_adamw_apply_in_pieces_is_bitwise(name, monkeypatch):
    """``apply`` takes AdamW's big leaves in pieces along their leading
    axis (``adamw.CHUNK_ELEMS``): the same bits as ``update`` then
    ``apply_updates`` on whole leaves."""
    tadamw = sys.modules["repro_torch.optim.adamw"]       # the module, not the function
    params, grads = _problem(1)
    tp, ts, _ = _run_port(OPTS[name][1](), params, grads, in_place=False)
    monkeypatch.setattr(tadamw, "CHUNK_ELEMS", 1000)
    assert len(tadamw._pieces(torch.zeros(3, 130, 129))) == 3
    assert len(tadamw._pieces(torch.zeros(300, 200))) == 60
    ip, istate, _ = _run_port(OPTS[name][1](), params, grads, in_place=True)
    for k in params:
        assert torch.equal(ip[k], tp[k]), k
        for mk in ts["mu"][k]:
            assert torch.equal(istate["mu"][k][mk], ts["mu"][k][mk]), (k, mk)


def test_cosine_warmup_matches_reference():
    j, t = joptim.cosine_warmup(3e-4, 5, 100), optim.cosine_warmup(3e-4, 5, 100)
    for s in range(120):
        got = t(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert _ulps(got.numpy(), np.float32(j(s))) <= SCHEDULE_ULPS, s
    assert float(t(0)) == 0.0


@pytest.mark.parametrize("shape,dtype", [((3,), "float32"), ((512,), "float32"),
                                         ((1000,), "float32"), ((64, 33), "float32"),
                                         ((2, 2055), "float32"), ((40, 70), "bfloat16")])
def test_compress_decompress_bitwise(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    je = jnp.zeros(shape, jnp.float32)
    te = torch.zeros(shape, dtype=torch.float32)
    for r in range(3):
        g = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 1, shape)).astype(np.float32)
        if dtype == "bfloat16":
            g = g.astype(ml_dtypes.bfloat16)
        jg, je = jgc.compress_decompress(jnp.asarray(g), je)
        tg, te = gc.compress_decompress(bridge.params_from_numpy(g, "cpu"), te)
        assert str(tg.dtype).split(".")[1] == np.asarray(jg).dtype.name
        np.testing.assert_array_equal(tg.float().numpy(), np.asarray(jg).astype(np.float32))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_quantize_dequantize_bitwise():
    x = np.random.default_rng(3).standard_normal((3, 1100)).astype(np.float32)
    jq, js = jgc.quantize(jnp.asarray(x))
    tq, ts = gc.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(gc.dequantize(tq, ts, 1100).numpy(),
                                  np.asarray(jgc.dequantize(jq, js, 1100)))


def test_init_error_state_and_get_optimizer():
    p = {"w": torch.ones(3, 4, dtype=torch.bfloat16), "b": [torch.ones(2)]}
    e = gc.init_error_state(p)
    assert e["w"].dtype == torch.float32 and e["w"].shape == (3, 4) and not e["w"].any()
    assert e["b"][0].shape == (2,)
    st = optim.get_optimizer("adafactor", 0.1).init({"w": torch.zeros(256, 512)})
    assert {k: tuple(v.shape) for k, v in st["mu"]["w"].items()} == {"vr": (256,),
                                                                      "vc": (512,)}
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.get_optimizer("sgd", 0.1)


# --- the reference's own optimizer and compression tests, on the port ---------------
def _quad_losses(opt, steps=60):
    w = torch.tensor([3.0, -2.0, 1.5])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        g = {"w": 2 * (params["w"] - w)}
        upd, state = opt.update(g, state, params)
        params = apply_updates(params, upd)
        losses.append(float(torch.sum((params["w"] - w) ** 2)))
    return losses


def test_adamw_converges():
    losses = _quad_losses(optim.adamw(0.05, weight_decay=0.0))
    assert losses[-1] < 0.05 * losses[0]


def test_adamw8bit_converges():
    losses = _quad_losses(optim.adamw(0.05, weight_decay=0.0, quantize_moments=True))
    assert losses[-1] < 0.1 * losses[0]


def test_adafactor_converges():
    losses = _quad_losses(optim.adafactor(0.3))
    assert losses[-1] < 0.2 * losses[0]


def test_schedule():
    lr = optim.cosine_warmup(1.0, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1.0)
    assert float(lr(100)) < float(lr(50)) < float(lr(10))


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), n=st.integers(3, 2000))
def test_quantization_error_bounded(seed, n):
    g = torch.from_numpy(np.random.default_rng(seed).normal(size=(n,)).astype(np.float32))
    ghat, _ = gc.compress_decompress(g, torch.zeros(n))
    assert float(torch.max(torch.abs(ghat - g))) <= float(torch.max(torch.abs(g))) / 127.0 + 1e-6


def test_error_feedback_preserves_sum():
    rng = np.random.default_rng(0)
    err = torch.zeros(64)
    tot_true, tot_comp = np.zeros(64), np.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
        ghat, err = gc.compress_decompress(g, err)
        tot_true += g.numpy()
        tot_comp += ghat.numpy()
    assert np.abs(tot_true - tot_comp).max() < 0.2


def test_sgd_with_compression_converges():
    w = torch.from_numpy(np.linspace(-2, 2, 32).astype(np.float32))
    params, err = torch.zeros(32), torch.zeros(32)
    for _ in range(400):
        ghat, err = gc.compress_decompress(2 * (params - w), err)
        params = params - 0.05 * ghat
    assert float(torch.max(torch.abs(params - w))) < 1e-2
