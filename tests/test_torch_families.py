"""The last two families against the JAX reference, on the CPU:
musicgen-large (sinusoidal positions added to the embeddings, LayerNorm,
gelu) and qwen2-vl-72b (M-RoPE over external embeddings).

Parameters are the reference's own ``lm.init`` trees for the smoke
configs (qwen2-vl's has no ``embed``: its inputs are embeddings),
carried across by ``bridge.params_from_numpy``; inputs are drawn from a
numpy seed.

* ``prefill`` then ``decode_step`` (scalar positions, then per-row
  positions) give the reference's logits within 1e-5 with a float32
  cache, and within ``test_torch_lm.py``'s BF16_CACHE_TOL (1e-3) with
  the config's bfloat16 cache, for the reason given there.  qwen2-vl runs
  on text-image-text ``position_ids`` whose three streams differ over
  the image (``smoke.vlm_position_ids``), fed through the batch as the
  reference takes them, and decodes with embeddings and (3, B, 1) ids.
* musicgen's paged programs: a prefix prefill, then a burst over the
  reused prefix and a tail that starts off the page grid, then decode
  steps through the block tables; each paged entry must pass its offset
  to the sinusoidal table, or every logit after position 0 is wrong.
* musicgen through the port's ``Scheduler`` against the JAX Scheduler:
  tokens, ``RequestResult`` fields and ``ServeStats`` equal over a trace
  with prefix hits and chunks of 3 over pages of 8 (every chunk after the
  first starts mid-page), and under an int8 ``dcim_numerics``; each
  served token is the port Engine's teacher-forced argmax with a 1e-4
  top-2 margin (``test_torch_serve.py``'s rule).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro import configs as jconfigs
from repro.core.precision import get as jget
from repro.models import lm as jlm
from repro.sim.functional import DCIMMacroSim as JSim
from repro_torch import bridge, configs, smoke
from repro_torch.core.precision import get as tget
from repro_torch.models import lm
from repro_torch.serve import Engine
from repro_torch.sim.functional import DCIMMacroSim as TSim

from test_torch_serve_tenants import (STAT_FIELDS, _assert_margins, _both, _model, _prompt,
                                      _served)

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=1e-3, atol=1e-3)}      # test_torch_lm.py's BF16_CACHE_TOL
MUSIC, VLM = "musicgen-large", "qwen2-vl-72b"
VLM_SIZES = smoke.VlmSizes(batch=2, text0=3, grid=(2, 3), text1=4, n_decode=3)
_jprefill = jax.jit(jlm.prefill, static_argnums=(2,), static_argnames=("max_len",))
_jdecode = jax.jit(jlm.decode_step, static_argnums=(4,))
_jprefill_paged = jax.jit(jlm.prefill_paged, static_argnums=(2, 8, 9))
_jdecode_paged = jax.jit(jlm.decode_step_paged, static_argnums=(5,))


@functools.lru_cache(maxsize=None)
def _family(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), attn_backend="xla")
    tcfg = configs.get_smoke_config(arch)
    params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(3), jcfg))
    return jcfg, tcfg, params, bridge.params_from_numpy(params, "cpu")


def _close(got, want, cache_dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOLS[cache_dtype])


@pytest.mark.parametrize("arch", [MUSIC, VLM])
def test_init_layout_matches_reference(arch):
    _, tcfg, params, _ = _family(arch)
    ours = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes_j = jax.tree.map(lambda a: (a.shape, a.dtype.name), params)
    shapes_t = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), ours,
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert shapes_t == shapes_j
    assert ("embed" in ours) == (arch == MUSIC)
    if arch == MUSIC:                         # LayerNorm: scale and bias
        assert set(ours["blocks"][0]["ln1"]) == {"scale", "bias"}


def _inputs(arch, tcfg, rng, B, S):
    """(jax batch, torch batch) of S positions: tokens, or embeddings with
    text-image-text M-RoPE ids."""
    if arch == MUSIC:
        toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
        return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    e = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    ids = np.ascontiguousarray(np.broadcast_to(smoke.vlm_position_ids(VLM_SIZES)[:, None, :S],
                                               (3, B, S)))
    return ({"embeds": jnp.asarray(e), "position_ids": jnp.asarray(ids)},
            {"embeds": torch.from_numpy(e), "position_ids": torch.from_numpy(ids)})


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [MUSIC, VLM])
def test_prefill_and_decode_logits(arch, cache_dtype):
    """Prefill two rows, two decode steps at a shared position, one at
    per-row positions; for qwen2-vl each step feeds an embedding and the
    next M-RoPE ids of the layout (per-row: each row's own)."""
    jcfg, tcfg, params, tparams = _family(arch)
    jcfg = dataclasses.replace(jcfg, cache_dtype=cache_dtype)
    tcfg = dataclasses.replace(tcfg, cache_dtype=cache_dtype)
    rng = np.random.default_rng(1)
    P = VLM_SIZES.prompt
    ids = smoke.vlm_position_ids(VLM_SIZES)
    if arch == VLM:
        assert not np.array_equal(ids[0, :P], ids[1, :P])      # the streams differ
        assert not np.array_equal(ids[1, :P], ids[2, :P])
    jb, tb = _inputs(arch, tcfg, rng, 2, P)
    jc, jlog = _jprefill(params, jb, jcfg, max_len=24)
    tc, tlog = lm.prefill(tparams, tb, tcfg, max_len=24)
    _close(tlog, jlog, cache_dtype)
    for pos in (P, P + 1, np.asarray([P + 2, P + 7], np.int32)):
        jb, tb = _inputs(arch, tcfg, rng, 2, 1)
        if arch == VLM:
            # The rows' next M-RoPE ids: the layout's next text position
            # (per row when the rows sit at different lengths).
            rows = np.broadcast_to(np.asarray(pos) - P, (2,)) + ids[0, P - 1] + 1
            nxt = np.ascontiguousarray(np.broadcast_to(rows[None, :, None], (3, 2, 1)),
                                       dtype=np.int32)
            jb["position_ids"], tb["position_ids"] = jnp.asarray(nxt), torch.from_numpy(nxt)
        jp, tp = (jnp.asarray(pos), torch.from_numpy(pos)) if isinstance(pos, np.ndarray) \
            else (pos, pos)
        jlog, jc = _jdecode(params, jb, jp, jc, jcfg)
        tlog, tc = lm.decode_step(tparams, tb, tp, tc, tcfg)
        _close(tlog, jlog, cache_dtype)


def test_vlm_decode_without_position_ids_takes_equal_streams():
    """With no ``position_ids`` M-RoPE falls back to three equal streams at
    the decode position, as the reference's ``_positions`` does."""
    jcfg, tcfg, params, tparams = _family(VLM)
    rng = np.random.default_rng(2)
    jb, tb = _inputs(VLM, tcfg, rng, 2, 5)
    del jb["position_ids"], tb["position_ids"]
    jc, jlog = _jprefill(params, jb, jcfg, max_len=12)
    tc, tlog = lm.prefill(tparams, tb, tcfg, max_len=12)
    _close(tlog, jlog, "float32")
    jb, tb = _inputs(VLM, tcfg, rng, 2, 1)
    del jb["position_ids"], tb["position_ids"]
    jlog, _ = _jdecode(params, jb, 5, jc, jcfg)
    tlog, _ = lm.decode_step(tparams, tb, 5, tc, tcfg)
    _close(tlog, jlog, "float32")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_music_paged_programs(cache_dtype):
    """A 10-token prefix prefill into pages of 4, then a burst: row 0 over
    the reused 8-token prefix (its tail starting at absolute position 8),
    row 1 a 3-token prompt with no context; then decode steps through the
    block tables at positions 13 and 3, with an inactive slot."""
    jcfg, tcfg, params, tparams = _family(MUSIC)
    jcfg = dataclasses.replace(jcfg, cache_dtype=cache_dtype)
    tcfg = dataclasses.replace(tcfg, cache_dtype=cache_dtype)
    V = tcfg.vocab_size
    page, nb, n_pages = 4, 6, 16
    rng = np.random.default_rng(4)
    bt = np.zeros((3, nb), np.int32)
    bt[0] = [1, 2, 3, 4, 5, 6]
    bt[1] = [7, 8, 9, 10, 11, 12]                 # slot 2 stays all-garbage
    pools = [jlm.init_paged_pool(jcfg, 3, n_pages, page),
             lm.init_paged_pool(tcfg, 3, n_pages, page, "cpu")]

    def both_prefill(tokens, bt_rows, ctx, tv, use_context):
        args = (bt_rows, np.arange(len(ctx), dtype=np.int32), np.asarray(ctx, np.int32),
                np.asarray(tv, np.int32))
        pools[0], jl = _jprefill_paged(params, {"tokens": jnp.asarray(tokens)}, jcfg, pools[0],
                                       *map(jnp.asarray, args), page, use_context)
        pools[1], tl = lm.prefill_paged(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg,
                                        pools[1], *map(torch.from_numpy, args), page,
                                        use_context)
        _close(tl, jl, cache_dtype)

    prefix = rng.integers(0, V, 10).astype(np.int32)
    both_prefill(prefix[None], bt[:1], [0], [10], False)
    tails = np.zeros((2, 5), np.int32)
    tails[0] = rng.integers(0, V, 5)
    tails[1, :3] = rng.integers(0, V, 3)
    both_prefill(tails, bt[:2], [8, 0], [5, 3], True)
    pos = np.asarray([13, 3, 0], np.int32)
    for _ in range(3):
        cur = rng.integers(0, V, (3, 1)).astype(np.int32)
        jl, pools[0] = _jdecode_paged(params, {"tokens": jnp.asarray(cur)}, jnp.asarray(pos),
                                      pools[0], jnp.asarray(bt), jcfg)
        tl, pools[1] = lm.decode_step_paged(tparams, {"tokens": torch.from_numpy(cur)},
                                            torch.from_numpy(pos), pools[1],
                                            torch.from_numpy(bt), tcfg)
        _close(tl[:2], jl[:2], cache_dtype)        # slot 2 decodes junk on the garbage page
        pos[:2] += 1


# --- musicgen through the Scheduler -----------------------------------------------------
def _music_trace(pkg, cfg, params, chunk):
    """A 19-token system prompt (two full pages of 8 and 3 tokens more)
    shared by three requests, one arriving after the first two finished
    filling, and a lone short prompt; ``chunk`` tokens a prefill tick."""
    rng = np.random.default_rng(21)
    V = cfg.vocab_size
    system = _prompt(rng, 19, V)
    sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=48, page_size=8,
                          prefill_chunk=chunk)
    reqs = [pkg.Request(prompt=np.concatenate([system, _prompt(rng, 2 + i, V)]), n_tokens=4,
                        rid=i, arrival=a) for i, a in enumerate([0, 0, 9])]
    reqs.append(pkg.Request(prompt=_prompt(rng, 5, V), n_tokens=3, rid=3, arrival=2))
    return _served(sched, sched.serve(reqs))


@pytest.mark.parametrize("chunk", [None, 3])
def test_music_scheduler_matches_reference(chunk):
    """Tokens, ``RequestResult`` fields, ``ServeStats`` and compile counts
    equal to the JAX Scheduler's; a later request hits the shared pages,
    and with chunks of 3 every chunk after the first starts mid-page."""
    model = _model(MUSIC)
    out = _both(model, _music_trace, chunk=chunk)
    st = out["stats"]
    assert st.prefix_reuse_active and out["results"][2].prefix_hit_tokens == 16
    assert (st.prefill_chunks > 8) if chunk else (st.prefill_chunks == 0)
    _assert_margins(model, out["results"], 48)


def test_music_scheduler_matches_reference_under_int8_dcim_numerics():
    """Two prompts of one bucket's length in one burst, their projections
    through an int8 macro (the per-tensor activation scale spans the
    batch, so the Engine's teacher forcing batches them the same way)."""
    model = _model(MUSIC)
    kw = dict(N=64, H=64, L=8, k=4)

    def scenario(pkg, cfg, params, sim):
        rng = np.random.default_rng(1)
        sched = pkg.Scheduler(cfg, params, max_slots=2, max_len=32, page_size=8, dcim_sim=sim)
        reqs = [pkg.Request(prompt=_prompt(rng, 8, cfg.vocab_size), n_tokens=3, rid=i)
                for i in range(2)]
        return _served(sched, sched.serve(reqs))

    jout = scenario(*model.side("jax"), JSim(jget("int8"), **kw))
    tout = scenario(*model.side("torch"), TSim(tget("int8"), **kw))
    for j, t in zip(jout["results"], tout["results"]):
        np.testing.assert_array_equal(t.tokens, j.tokens)
    for f in STAT_FIELDS:
        assert getattr(tout["stats"], f) == getattr(jout["stats"], f), f
    assert tout["stats"].prefill_batches == 1
    eng = Engine(model.tcfg, model.tparams, max_len=32, dcim_sim=TSim(tget("int8"), **kw))
    logits = eng.teacher_force([r.tokens[:r.prompt_len] for r in tout["results"]],
                               [r.generated for r in tout["results"]])
    for r, lg in zip(tout["results"], logits):
        top2 = torch.topk(lg, 2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) >= 1e-4, f"rid {r.rid}: near-tie"
        np.testing.assert_array_equal(torch.argmax(lg, dim=-1).numpy(), r.generated)
