"""The port's position encodings and input embedding against the JAX
reference, on the CPU: ``sinusoidal_positions`` (MusicGen),
``apply_mrope`` (Qwen2-VL's M-RoPE) and ``lm.embed_inputs``.

Tolerances, and why:

* ``apply_mrope`` over three equal streams is ``apply_rope`` bitwise: the
  per-channel positions are the same float32 values, and every later op is
  the same op in the same order.
* Against the reference, bfloat16 inputs agree bitwise (the float32
  rotation's last-ulp differences never cross a bfloat16 rounding
  boundary at these draws, and the test says so by asserting equality).
  float32 inputs agree to 4 float32 ulps of the operands' magnitude
  (``|x1| + |x2|``): XLA's and torch's CPU ``sin`` and ``cos`` differ by
  at most one ulp of a value <= 1 (2^-24; measured on 10^5 angles), and
  the rotation sums two such products.
* ``sinusoidal_positions``: the frequencies are ``exp`` of the same float32
  arguments, and the two libraries' ``exp`` differ by at most one ulp
  (measured); an angle ``pos * freq`` inherits ``pos`` times that ulp,
  then its own rounding (one ulp of the angle), and ``sin`` / ``cos``
  add one more ulp of a value <= 1 each side.  The per-element bound is
  therefore ``pos * ulp(freq) + ulp(angle) + 2^-23``: at position 32768
  and a frequency near 1 that is ~2e-3, the size of the measured
  differences, while a wrong frequency, a swapped sin / cos half or a
  position off by one is off by O(1) somewhere.
* ``embed_inputs``: an embedding gather and a cast are bitwise; the
  sinusoidal add takes the table's bound plus one ulp of the sum (one
  bfloat16 ulp in bfloat16, where the table is cast to the compute dtype
  before the add, as the reference casts it).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.models import common, lm

BF16_SPACING = 2.0 ** -7       # one bfloat16 ulp at magnitude [1, 2), relative


def _positions(rng, n_small=40, n_large=200, top=32768):
    return np.concatenate([np.arange(n_small), rng.integers(0, top + 1, n_large)]).astype(np.int32)


def _sinusoidal_bound(pos: np.ndarray, d: int) -> np.ndarray:
    """The per-element bound of the module docstring, (..., S, d)."""
    half = d // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half, dtype=np.float32) / half).astype(np.float32)
    ang = pos[..., None].astype(np.float32) * freq
    b = np.abs(pos[..., None]).astype(np.float64) * np.spacing(freq) + np.spacing(np.abs(ang))
    b = b + 2.0 ** -23
    return np.concatenate([b, b], axis=-1)


@pytest.mark.parametrize("d", [64, 2048])
def test_sinusoidal_positions(d):
    rng = np.random.default_rng(d)
    pos = _positions(rng)[None]
    want = np.asarray(jcommon.sinusoidal_positions(jnp.asarray(pos), d))
    got = common.sinusoidal_positions(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, pos.shape[1], d)
    diff = np.abs(got.numpy() - want)
    assert np.all(diff <= _sinusoidal_bound(pos, d)), float(diff.max())
    # Sin first: position 0 is [0, ..., 0, 1, ..., 1].
    np.testing.assert_array_equal(got[0, 0].numpy(), np.r_[np.zeros(d // 2), np.ones(d // 2)])


def test_sinusoidal_positions_per_row_offsets():
    """A (B, 1) offset broadcast over arange(S): row b at offset o_b gives
    the table rows o_b .. o_b + S - 1, as one call at those positions."""
    d, S = 64, 9
    off = np.asarray([[0], [17], [32759]], np.int32)
    pos = np.arange(S, dtype=np.int32)[None, :] + off
    want = np.asarray(jcommon.sinusoidal_positions(jnp.asarray(pos), d))
    got = common.sinusoidal_positions(torch.arange(S)[None, :] + torch.from_numpy(off), d)
    assert np.all(np.abs(got.numpy() - want) <= _sinusoidal_bound(pos, d))
    for b in range(3):
        torch.testing.assert_close(
            got[b], common.sinusoidal_positions(torch.from_numpy(pos[b]), d), rtol=0, atol=0)


def _mrope_inputs(rng, hd, dtype, B=2, S=13, H=3):
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    streams = np.stack([rng.integers(0, 5000, (B, S)) for _ in range(3)]).astype(np.int32)
    assert not (np.array_equal(streams[0], streams[1]) or np.array_equal(streams[1], streams[2]))
    tx = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return tx, jx, streams


@pytest.mark.parametrize("sections,hd", [((4, 2, 2), 16), ((16, 24, 24), 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_apply_mrope_distinct_streams(sections, hd, dtype):
    rng = np.random.default_rng(hd)
    tx, jx, streams = _mrope_inputs(rng, hd, dtype)
    want = np.asarray(jcommon.apply_mrope(jx, jnp.asarray(streams), sections, 1e6)
                      .astype(jnp.float32))
    got = common.apply_mrope(tx, torch.from_numpy(streams), sections, 1e6)
    assert got.dtype == dtype
    got = got.float().numpy()
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got, want)
    else:
        x1, x2 = np.split(tx.numpy(), 2, axis=-1)
        mag = np.abs(x1) + np.abs(x2)
        bound = 4 * np.spacing(np.concatenate([mag, mag], axis=-1))
        assert np.all(np.abs(got - want) <= bound)
    # The streams matter: each one alone (three equal streams) rotates
    # some channel section differently.
    for i in range(3):
        alone = common.apply_mrope(tx, torch.from_numpy(np.stack([streams[i]] * 3)), sections,
                                   1e6).float().numpy()
        assert not np.array_equal(alone, got)


@pytest.mark.parametrize("sections,hd", [((4, 2, 2), 16), ((16, 24, 24), 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_apply_mrope_equal_streams_is_rope_bitwise(sections, hd, dtype):
    rng = np.random.default_rng(7)
    tx, _, streams = _mrope_inputs(rng, hd, dtype)
    pos = torch.from_numpy(streams[0])
    got = common.apply_mrope(tx, pos[None].expand(3, *pos.shape), sections, 1e6)
    assert torch.equal(got, common.apply_rope(tx, pos, 1e6))


def test_apply_mrope_rejects_bad_sections():
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        common.apply_mrope(torch.zeros(1, 2, 1, 16), torch.zeros(3, 1, 2), (4, 2, 1), 1e6)


# --- embed_inputs -----------------------------------------------------------------------
def _cfgs(arch, compute_dtype):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(configs.get_smoke_config(arch), compute_dtype=compute_dtype)
    return jcfg, tcfg


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", ["int", "rows"])
def test_embed_inputs_sinusoidal(compute_dtype, offset):
    """musicgen: the embedding rows plus the sinusoidal table at
    ``arange(S) + offset``, the table cast to the compute dtype first."""
    jcfg, tcfg = _cfgs("musicgen-large", compute_dtype)
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((tcfg.vocab_size, tcfg.d_model)) * 0.02).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab_size, (3, 6)).astype(np.int32)
    off_np = 11 if offset == "int" else np.asarray([[0], [300], [32700]], np.int32)
    off_t = off_np if offset == "int" else torch.from_numpy(off_np)
    want = np.asarray(jlm.embed_inputs({"embed": {"w": jnp.asarray(w)}},
                                       {"tokens": jnp.asarray(toks)}, jcfg, offset=off_np)
                      .astype(jnp.float32))
    got = lm.embed_inputs({"embed": {"w": torch.from_numpy(w)}}, {"tokens": torch.from_numpy(toks)},
                          tcfg, offset=off_t)
    assert got.dtype == tcfg.cdtype and tuple(got.shape) == (3, 6, tcfg.d_model)
    pos = np.arange(6, dtype=np.int32)[None, :] + off_np
    table = common.sinusoidal_positions(torch.arange(6)[None, :] + off_t, tcfg.d_model)
    # The order: the table is rounded to the compute dtype, then added.
    rows = torch.from_numpy(w).to(tcfg.cdtype)[torch.from_numpy(toks).long()]
    assert torch.equal(got, rows + table.to(tcfg.cdtype))
    bound = _sinusoidal_bound(pos, tcfg.d_model)
    one_ulp = (BF16_SPACING * np.abs(want) if compute_dtype == "bfloat16"
               else np.spacing(np.abs(want)))
    assert np.all(np.abs(got.float().numpy() - want) <= bound + one_ulp)


def test_embed_inputs_external_embeds_and_tokens_bitwise():
    """qwen2-vl takes ``embeds`` cast to the compute dtype (no table, no
    gather); a RoPE token model gathers its embedding rows."""
    rng = np.random.default_rng(4)
    for arch in ("qwen2-vl-72b", "qwen2.5-3b"):
        jcfg, tcfg = _cfgs(arch, "bfloat16")
        if tcfg.external_embed:
            e = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
            jbatch, tbatch, params = {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}, {}
            jparams = {}
        else:
            w = (rng.standard_normal((tcfg.vocab_size, tcfg.d_model)) * 0.02).astype(np.float32)
            toks = rng.integers(0, tcfg.vocab_size, (2, 5)).astype(np.int32)
            jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
            jparams, params = {"embed": {"w": jnp.asarray(w)}}, {"embed": {"w": torch.from_numpy(w)}}
        want = np.asarray(jlm.embed_inputs(jparams, jbatch, jcfg, offset=7).astype(jnp.float32))
        got = lm.embed_inputs(params, tbatch, tcfg, offset=7)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
