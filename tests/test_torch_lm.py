"""The port's LM (dense-GQA and SSM families) against the JAX reference,
on the CPU.

Parameters are the reference's own ``lm.init`` tree for the smoke
qwen2.5-3b config (its zero q/k/v biases replaced by draws from a numpy
seed, so the bias path counts), carried across by
``bridge.params_from_numpy``.  Both packages then run the same tokens
through ``prefill``, ``decode_step`` (scalar and per-row positions),
``prefill_paged`` (with and without a reused context) and
``decode_step_paged``, and the logits must agree to RTOL = ATOL = 1e-5 with a float32 KV
cache: both sides compute in float32, in different summation orders
(XLA's scanned einsums against torch's matmuls; the reference's flash
prefill and masked softmax against the port's).  With the config's own
bfloat16 cache the bound is BF16_CACHE_TOL: each K/V row is rounded to
bfloat16 on its way into the cache, and two float32 values 1e-7 apart
round one bfloat16 ulp (2^-8 relative) apart when they straddle a
rounding boundary, so a later step reads context that differs by up to
4e-3 relative in a few elements.  The KV caches and pools are held to
the logits' bound, widened in bfloat16 by one bfloat16 ulp (rtol 2^-7)
for the rounding itself; ``page_write_indices`` is bitwise.  ``bridge``
carries a bfloat16 tree bit for bit.

The SSM family (falcon-mamba-7b smoke, both ``ssm_impl`` values) is held
to the same bounds through ``prefill`` / ``decode_step`` and through the
paged programs: a burst prefill whose padding rows write the garbage
slot, then decode steps over all slots with one inactive, whose junk
update of its own state row must be the reference's too.
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
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.serve import Engine as JEngine
from repro_torch import bridge, configs
from repro_torch.models import common, lm
from repro_torch.serve import Engine

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=1e-3, atol=1e-3)}      # BF16_CACHE_TOL
# One compiled program per shape is quicker here than op-by-op dispatch.
_jprefill = jax.jit(jlm.prefill, static_argnums=(2,), static_argnames=("max_len",))
_jdecode = jax.jit(jlm.decode_step, static_argnums=(4,))
_jprefill_paged = jax.jit(jlm.prefill_paged, static_argnums=(2, 8, 9))
_jdecode_paged = jax.jit(jlm.decode_step_paged, static_argnums=(5,))
CACHE_TOLS = {"float32": TOLS["float32"], "bfloat16": dict(rtol=2.0 ** -7, atol=1e-3)}
ARCH = "qwen2.5-3b"
VOCAB = 512


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_smoke_config(ARCH)
    tcfg = configs.get_smoke_config(ARCH)
    params = _tree_np(jlm.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    for name in ("wq", "wk", "wv"):
        b = params["blocks"][0]["mixer"][name]["b"]
        params["blocks"][0]["mixer"][name]["b"] = (
            rng.standard_normal(b.shape) * 0.1).astype(np.float32)
    return jcfg, tcfg, params, bridge.params_from_numpy(params, "cpu")


def _close(got: torch.Tensor, want, cache_dtype="float32", tols=TOLS) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **tols[cache_dtype])


def _close_caches(got, want, cache_dtype, tols=CACHE_TOLS) -> None:
    leaves = [c[k] for c in got for k in sorted(c)]     # jax.tree.leaves' order
    assert len(leaves) == len(jax.tree.leaves(want))
    for t, a in zip(leaves, jax.tree.leaves(want)):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(a, np.float32),
                                   **tols[cache_dtype])


def test_bridge_carries_bfloat16_bitwise(model):
    # lm.init draws in float32 and casts to param_dtype, so this is the
    # tree lm.init gives for param_dtype="bfloat16".
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), model[2])
    got = bridge.params_from_numpy(params, "cpu")
    flat_j = jax.tree.leaves(params)
    flat_t = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(flat_j) == len(flat_t) > 0
    for a, t in zip(flat_j, flat_t):
        assert a.dtype.name == "bfloat16" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                      a.view(np.uint16))


def test_init_layout_matches_reference(model):
    _, tcfg, params, _ = model
    gen = torch.Generator().manual_seed(0)
    ours = lm.init(tcfg, gen, "cpu")
    shapes_j = jax.tree.map(lambda a: (a.shape, a.dtype.name), params)
    shapes_t = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), ours,
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert shapes_t == shapes_j
    # Scales: dense N(0, 1/d_in), embedding N(0, 0.02^2).
    w = ours["blocks"][0]["ffn"]["w_down"]["w"]
    assert abs(float(w.std()) * np.sqrt(tcfg.d_ff) - 1.0) < 0.05
    assert abs(float(ours["embed"]["w"].std()) / 0.02 - 1.0) < 0.05


def _prefill_and_decode(model, cache_dtype, tols=TOLS, cache_tols=CACHE_TOLS):
    """Prefill two prompts, two decode steps at a shared scalar position,
    then one at per-row positions: logits and caches as the reference's."""
    jcfg, tcfg, params, tparams = model
    jcfg = dataclasses.replace(jcfg, cache_dtype=cache_dtype)
    tcfg = dataclasses.replace(tcfg, cache_dtype=cache_dtype)
    close = lambda got, want: _close(got, want, cache_dtype, tols)  # noqa: E731
    rng = np.random.default_rng(1)
    toks = rng.integers(0, VOCAB, (2, 11)).astype(np.int32)
    max_len = 24
    jc, jlog = _jprefill(params, {"tokens": jnp.asarray(toks)}, jcfg, max_len=max_len)
    tc, tlog = lm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg, max_len=max_len)
    close(tlog, jlog)
    _close_caches(tc, jc, cache_dtype)
    for t in range(2):
        nxt = rng.integers(0, VOCAB, (2, 1)).astype(np.int32)
        jlog, jc = _jdecode(params, {"tokens": jnp.asarray(nxt)}, 11 + t, jc, jcfg)
        tlog, tc = lm.decode_step(tparams, {"tokens": torch.from_numpy(nxt)}, 11 + t, tc, tcfg)
        close(tlog, jlog)
    pos = np.asarray([13, 20], np.int32)
    nxt = rng.integers(0, VOCAB, (2, 1)).astype(np.int32)
    jlog, jc = _jdecode(params, {"tokens": jnp.asarray(nxt)}, jnp.asarray(pos), jc, jcfg)
    tlog, tc = lm.decode_step(tparams, {"tokens": torch.from_numpy(nxt)}, torch.from_numpy(pos),
                              tc, tcfg)
    close(tlog, jlog)
    _close_caches(tc, jc, cache_dtype, cache_tols)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits(model, cache_dtype):
    _prefill_and_decode(model, cache_dtype)


def test_prefill_with_valid_len(model):
    jcfg, tcfg, params, tparams = model
    toks = np.random.default_rng(2).integers(0, VOCAB, (1, 16)).astype(np.int32)
    _, jlog = _jprefill(params, {"tokens": jnp.asarray(toks)}, jcfg, max_len=16,
                          valid_len=jnp.asarray(9, jnp.int32))
    _, tlog = lm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg, max_len=16,
                         valid_len=9)
    _close(tlog, jlog)


def _paged_programs(model, cache_dtype):
    """A prefix prefill into pages, then a burst of two tails (one over
    the reused prefix, one without), then decode steps through the block
    tables, with an inactive all-garbage slot."""
    jcfg, tcfg, params, tparams = model
    jcfg = dataclasses.replace(jcfg, cache_dtype=cache_dtype)
    tcfg = dataclasses.replace(tcfg, cache_dtype=cache_dtype)
    close = lambda got, want: _close(got, want, cache_dtype)  # noqa: E731
    page, nb, n_pages = 4, 6, 16
    rng = np.random.default_rng(4)
    bt = np.zeros((3, nb), np.int32)
    bt[0] = [1, 2, 3, 4, 5, 6]
    bt[1] = [7, 8, 9, 10, 11, 12]                 # slot 2 stays all-garbage
    jpool = jlm.init_paged_pool(jcfg, 3, n_pages, page)
    tpool = lm.init_paged_pool(tcfg, 3, n_pages, page, "cpu")

    def both_prefill(tokens, bt_rows, ctx, tv, use_context):
        nonlocal jpool, tpool
        args = (bt_rows, np.arange(len(ctx), dtype=np.int32), np.asarray(ctx, np.int32),
                np.asarray(tv, np.int32))
        jpool, jl = _jprefill_paged(params, {"tokens": jnp.asarray(tokens)}, jcfg, jpool,
                                      *map(jnp.asarray, args), page, use_context)
        tpool, tl = lm.prefill_paged(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg,
                                     tpool, *map(torch.from_numpy, args), page, use_context)
        close(tl, jl)

    prefix = rng.integers(0, VOCAB, 8).astype(np.int32)
    both_prefill(np.concatenate([prefix, [0, 0]])[None].astype(np.int32), bt[:1], [0], [8],
                 False)
    # Row 0 reuses the 8-token prefix (2 pages) and prefills 5 more; row 1
    # has no context and a 3-token tail (right-padded).
    tails = np.zeros((2, 5), np.int32)
    tails[0] = rng.integers(0, VOCAB, 5)
    tails[1, :3] = rng.integers(0, VOCAB, 3)
    both_prefill(tails, bt[:2], [8, 0], [5, 3], True)
    _close_caches(tpool, jpool, cache_dtype)

    pos = np.asarray([13, 3, 0], np.int32)
    for _ in range(3):
        cur = rng.integers(0, VOCAB, (3, 1)).astype(np.int32)
        jl, jpool = _jdecode_paged(params, {"tokens": jnp.asarray(cur)}, jnp.asarray(pos),
                                          jpool, jnp.asarray(bt), jcfg)
        tl, tpool = lm.decode_step_paged(tparams, {"tokens": torch.from_numpy(cur)},
                                         torch.from_numpy(pos), tpool, torch.from_numpy(bt),
                                         tcfg)
        close(tl, jl)
        pos[:2] += 1
    _close_caches(tpool, jpool, cache_dtype)
    assert lm.pool_nbytes(tpool) == jlm.pool_nbytes(jpool)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_paged_programs(model, cache_dtype):
    _paged_programs(model, cache_dtype)


def test_page_write_indices_bitwise():
    rng = np.random.default_rng(5)
    bt = rng.integers(1, 40, (3, 4)).astype(np.int32)
    ctx = np.asarray([0, 5, 11], np.int32)
    tv = np.asarray([7, 2, 0], np.int32)
    jpg, jrw = jcommon.page_write_indices(jnp.asarray(bt), jnp.asarray(ctx), jnp.asarray(tv),
                                          8, 4)
    tpg, trw = common.page_write_indices(torch.from_numpy(bt), torch.from_numpy(ctx),
                                         torch.from_numpy(tv), 8, 4)
    np.testing.assert_array_equal(tpg.numpy(), np.asarray(jpg))
    np.testing.assert_array_equal(trw.numpy(), np.asarray(jrw))


def test_unported_families_raise():
    # No family is left unported: musicgen (sinusoidal positions) and
    # qwen2-vl (M-RoPE over external embeddings) were the last, and the
    # guard that refused them is gone.  Every architecture's smoke config
    # initialises, prefills and decodes to finite logits of its vocabulary.
    assert not hasattr(lm, "check_supported")
    assert len(configs.ARCH_NAMES) == 10
    for arch in configs.ARCH_NAMES:
        cfg = configs.get_smoke_config(arch)
        params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        if cfg.external_embed:
            batch = {"embeds": torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                                           .manual_seed(1))}
            step = {"embeds": batch["embeds"][:, -1:]}
        else:
            batch = {"tokens": torch.arange(10, dtype=torch.int32).reshape(2, 5)}
            step = {"tokens": batch["tokens"][:, -1:]}
        caches, logits = lm.prefill(params, batch, cfg, max_len=8)
        logits2, _ = lm.decode_step(params, step, 5, caches, cfg)
        for lg in (logits, logits2):
            assert tuple(lg.shape) == (2, 1, cfg.vocab_size), arch
            assert torch.isfinite(lg).all(), arch


# --- the MLA and MoE families --------------------------------------------------------
# deepseek-v3 (MLA + MoE with a shared expert, MTP head in the reference
# tree), moonshot (GQA + MoE), jamba (mamba + GQA, MoE on odd layers),
# on their smoke configs, the reference's attention on backend "xla".
MOE_ARCHS = ("deepseek-v3-671b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b")
# jamba's smoke stack is 8 layers deep (the others 2), and the float32
# differences grow with depth: 2.3e-5 at its second decode step, 7e-6 of
# the top logit (~3.4), with either ssm_impl.
DEEP_TOLS = {"float32": dict(rtol=1e-4, atol=1e-4)}


@functools.lru_cache(maxsize=None)
def _family(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), attn_backend="xla")
    tcfg = configs.get_smoke_config(arch)
    params = _tree_np(jlm.init(jax.random.PRNGKey(2), jcfg))
    return jcfg, tcfg, params, bridge.params_from_numpy(params, "cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_families_init_layout(arch):
    _, tcfg, params, _ = _family(arch)
    ours = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu")   # the MTP head included
    shapes_j = jax.tree.map(lambda a: (a.shape, a.dtype.name), params)
    shapes_t = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), ours,
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert shapes_t == shapes_j
    assert ("mtp" in params) == ("mtp" in ours) == (arch == "deepseek-v3-671b")


def test_bridge_carries_a_deepseek_tree():
    """A bfloat16 body, a float32 router and the MTP subtree, bit for bit;
    the serving functions take the tree with its unused MTP head."""
    jcfg, tcfg, _, _ = _family("deepseek-v3-671b")
    params = _tree_np(jlm.init(jax.random.PRNGKey(5),
                               dataclasses.replace(jcfg, param_dtype="bfloat16")))
    got = bridge.params_from_numpy(params, "cpu")
    flat_j = jax.tree.leaves(params)
    flat_t = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(flat_j) == len(flat_t) and "mtp" in got
    for a, t in zip(flat_j, flat_t):
        assert tuple(t.shape) == a.shape and str(t.dtype).split(".")[1] == a.dtype.name
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          a.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    assert got["blocks"][0]["ffn"]["router"]["w"].dtype == torch.float32
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    _, logits = lm.prefill(got, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, tcfg)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_families_prefill_and_decode_logits(arch):
    deep = arch == "jamba-v0.1-52b"
    _prefill_and_decode(_family(arch), "float32", *((DEEP_TOLS, DEEP_TOLS) if deep else ()))


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_mla_prefill_and_decode_logits_bf16_cache(cache_dtype):
    _prefill_and_decode(_family("deepseek-v3-671b"), cache_dtype)


@pytest.mark.parametrize("arch,cache_dtype", [("deepseek-v3-671b", "float32"),
                                              ("deepseek-v3-671b", "bfloat16"),
                                              ("moonshot-v1-16b-a3b", "float32")])
def test_moe_families_paged_programs(arch, cache_dtype):
    _paged_programs(_family(arch), cache_dtype)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_families_engine_greedy_tokens(arch):
    jcfg, tcfg, params, tparams = _family(arch)
    prompts = np.random.default_rng(9).integers(0, VOCAB, (2, 7)).astype(np.int32)
    want = JEngine(jcfg, params, max_len=24).generate(prompts, n_tokens=6)
    got = Engine(tcfg, tparams, max_len=24).generate(prompts, n_tokens=6)
    np.testing.assert_array_equal(got.tokens, want.tokens)


# --- the other dense families --------------------------------------------------------
# phi4-mini (the tied head: logits through the embedding's transpose),
# mistral-nemo and qwen2.5-14b, on their smoke configs.
DENSE_ARCHS = ("phi4-mini-3.8b", "mistral-nemo-12b", "qwen2.5-14b")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_families_prefill_and_decode_logits(arch, cache_dtype):
    model = _family(arch)
    assert ("head" not in model[2]) == (arch == "phi4-mini-3.8b")
    _prefill_and_decode(model, cache_dtype)


# --- the SSM family -------------------------------------------------------------------
SSM_ARCH = "falcon-mamba-7b"


@pytest.fixture(scope="module")
def ssm_model():
    jcfg = jconfigs.get_smoke_config(SSM_ARCH)
    tcfg = configs.get_smoke_config(SSM_ARCH)
    params = _tree_np(jlm.init(jax.random.PRNGKey(1), jcfg))
    return jcfg, tcfg, params, bridge.params_from_numpy(params, "cpu")


def test_ssm_init_layout_matches_reference(ssm_model):
    _, tcfg, params, _ = ssm_model
    ours = lm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes_j = jax.tree.map(lambda a: (a.shape, a.dtype.name), params)
    shapes_t = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), ours,
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert shapes_t == shapes_j
    mixer = ours["blocks"][0]["mixer"]
    # log(1..N) in float32; XLA's CPU log is one ulp (6e-8) off on some.
    np.testing.assert_allclose(mixer["A_log"].numpy(), params["blocks"][0]["mixer"]["A_log"],
                               rtol=2.4e-7, atol=0)
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)


@pytest.mark.parametrize("impl,cache_dtype", [("pallas", "float32"), ("assoc", "float32"),
                                              ("pallas", "bfloat16")])
def test_ssm_prefill_and_decode_logits(ssm_model, impl, cache_dtype):
    jcfg, tcfg, params, tparams = ssm_model
    jcfg = dataclasses.replace(jcfg, ssm_impl=impl, cache_dtype=cache_dtype)
    tcfg = dataclasses.replace(tcfg, ssm_impl=impl, cache_dtype=cache_dtype)
    close = lambda got, want: _close(got, want, cache_dtype)  # noqa: E731
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jc, jlog = _jprefill(params, {"tokens": jnp.asarray(toks)}, jcfg, max_len=24)
    tc, tlog = lm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg, max_len=24)
    close(tlog, jlog)
    _close_caches(tc, jc, cache_dtype)
    for t in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.asarray([11 + t, 13 + t], np.int32)
        jlog, jc = _jdecode(params, {"tokens": jnp.asarray(nxt)}, jnp.asarray(pos), jc, jcfg)
        tlog, tc = lm.decode_step(tparams, {"tokens": torch.from_numpy(nxt)},
                                  torch.from_numpy(pos), tc, tcfg)
        close(tlog, jlog)
    _close_caches(tc, jc, cache_dtype)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_ssm_paged_programs(ssm_model, cache_dtype):
    """A burst of two real prompts and two padding rows (tail_valid 0, the
    garbage slot 3), then decode steps over the 3 slots with slot 2
    inactive: logits, every state row (the garbage slot and the inactive
    slot's junk included) and the pool size as the reference's."""
    jcfg, tcfg, params, tparams = ssm_model
    jcfg = dataclasses.replace(jcfg, cache_dtype=cache_dtype)
    tcfg = dataclasses.replace(tcfg, cache_dtype=cache_dtype)
    close = lambda got, want: _close(got, want, cache_dtype)  # noqa: E731
    page, nb, n_pages, n_slots = 4, 4, 9, 3
    rng = np.random.default_rng(8)
    jpool = jlm.init_paged_pool(jcfg, n_slots, n_pages, page)
    tpool = lm.init_paged_pool(tcfg, n_slots, n_pages, page, "cpu")
    tokens = np.zeros((4, 8), np.int32)
    tokens[0] = rng.integers(0, jcfg.vocab_size, 8)
    tokens[1, :5] = rng.integers(0, jcfg.vocab_size, 5)
    bt = np.zeros((4, nb), np.int32)
    bt[0], bt[1] = [1, 2, 3, 4], [5, 6, 7, 8]
    args = (bt, np.asarray([0, 1, n_slots, n_slots], np.int32), np.zeros(4, np.int32),
            np.asarray([8, 5, 0, 0], np.int32))
    jpool, jl = _jprefill_paged(params, {"tokens": jnp.asarray(tokens)}, jcfg, jpool,
                                *map(jnp.asarray, args), page, False)
    tpool, tl = lm.prefill_paged(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg, tpool,
                                 *map(torch.from_numpy, args), page, False)
    close(tl[:2], np.asarray(jl)[:2])
    _close_caches(tpool, jpool, cache_dtype)

    pos = np.asarray([8, 5, 0], np.int32)
    dbt = np.concatenate([bt[:2], np.zeros((1, nb), np.int32)])
    for _ in range(3):
        cur = rng.integers(0, jcfg.vocab_size, (3, 1)).astype(np.int32)
        jl, jpool = _jdecode_paged(params, {"tokens": jnp.asarray(cur)}, jnp.asarray(pos),
                                   jpool, jnp.asarray(dbt), jcfg)
        tl, tpool = lm.decode_step_paged(tparams, {"tokens": torch.from_numpy(cur)},
                                         torch.from_numpy(pos), tpool, torch.from_numpy(dbt),
                                         tcfg)
        close(tl, jl)
        pos[:2] += 1
    _close_caches(tpool, jpool, cache_dtype)
    assert lm.pool_nbytes(tpool) == jlm.pool_nbytes(jpool)
