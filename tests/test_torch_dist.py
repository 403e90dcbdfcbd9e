"""``repro_torch.dist.sharding`` against ``repro.dist.sharding``, on the
CPU with no process group.

The reference's placement rules are pure functions of axis names and
sizes, so they resolve on a ``jax.sharding.AbstractMesh`` (no devices).
The port resolves them on plain ``{axis: size}`` meshes.  For every leaf
of the ten architectures' parameter trees (the port's own smoke-size
trees, and the reference's full-size shape trees from ``jax.eval_shape``)
and of their paged pools, on five meshes, the port's spec equals the
reference's ``MeshContext(AbstractMesh(...), rules).spec(...)`` through
``logical_for_path`` (training), ``serve_logical_for_path`` (serving)
and ``_pool_logical`` (the pool), and its placements say the same.  The
reference's unit properties follow as parametrised cases: the longest
divisible prefix, each axis once, a rank mismatch raising, unknown
logical names replicating, ``use_mesh`` nesting and popping on an
exception.  Then ``local_shard`` cuts the block each rank's coordinates
name.

Training's state and batch layouts: every leaf of the reference's
TrainState (AdamW with the int8 compression's error tree, 8-bit AdamW,
Adafactor; ``jax.eval_shape`` of ``train_step.init_state``, smoke and
full size) and of its train, prefill and decode batches against the
reference's ``launch.dryrun`` rules.  That module cannot be imported in
a test worker (its first lines force 512 host devices on jax), so its
suffix rules (``_MOMENT_SUFFIX``, ``_FACTORED_ROW`` / ``_COL``,
``_QUANT``) and ``_BATCH_LOGICAL`` are restated here over the
reference's own ``logical_for_path``.
"""
import re

import jax
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.dist import sharding as jshd
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.optim import get_optimizer as jget_optimizer
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.optim import get_optimizer
from repro_torch.train.train_step import state_shapes

MESHES = {
    "model2": {"model": 2},
    "model4": {"model": 4},
    "model8": {"model": 8},
    "data2_model4": {"data": 2, "model": 4},
    "pod2_data2_model2": {"pod": 2, "data": 2, "model": 2},
}
POOL = dict(n_slots=3, n_pages=9, page_size=8)


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _jax_paths(tree):
    return [(jshd._path_str(p), tuple(leaf.shape))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _meta(pairs):
    """The reference's (path, shape) pairs as a port tree of meta tensors."""
    tree = {}
    for path, shape in pairs:
        node, keys = tree, path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(shape, device="meta")
    return tree


@pytest.fixture(scope="module")
def trees():
    """Per arch: [(kind, port tree, the reference's (path, shape) pairs)]
    for the smoke params (the port's own init), the full-size params and
    the smoke and full-size pools."""
    out = {}
    for name in configs.ARCH_NAMES:
        rows = []
        for size, jcfg, cfg in (("smoke", jconfigs.get_smoke_config(name),
                                 configs.get_smoke_config(name)),
                                ("full", jconfigs.get_config(name), configs.get_config(name))):
            ref = _jax_paths(jax.eval_shape(lambda k: jlm.init(k, jcfg), jax.random.PRNGKey(0)))
            if size == "smoke":
                g = torch.Generator("cpu")
                g.manual_seed(0)
                port = lm.init(cfg, g, "cpu")
            else:
                port = _meta(ref)
            rows.append((f"{size}-params", port, ref))
            ref_pool = _jax_paths(jax.eval_shape(
                lambda: jlm.init_paged_pool(jcfg, POOL["n_slots"], POOL["n_pages"],
                                            POOL["page_size"])))
            port_pool = lm.init_paged_pool(cfg, POOL["n_slots"], POOL["n_pages"],
                                           POOL["page_size"], "meta")
            rows.append((f"{size}-pool", port_pool, ref_pool))
        out[name] = rows
    return out


def _check_placements(ctx, ls):
    for a, pl in zip(ctx.axis_names, ls.placements):
        dims = [d for d, e in enumerate(ls.spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        assert pl == (Shard(dims[0]) if dims else Replicate())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_specs_equal_the_reference_leaf_for_leaf(trees, name, mesh):
    sizes = MESHES[mesh]
    am = _abstract(sizes)
    jtrain, jserve = jshd.MeshContext(am), jshd.serving_context(am)
    ctx = shd.MeshContext(sizes)
    n_sharded = 0
    for kind, port, ref in trees[name]:
        port_paths = [(p, tuple(t.shape)) for p, t in shd.tree_paths(port)]
        assert port_paths == ref, (name, kind)
        if kind.endswith("pool"):
            tables = [(shd.serve_pool_sharding_tree(port, sizes),
                       lambda p, shape: jserve.spec(jshd._pool_logical(
                           [jax.tree_util.DictKey(p.split("/")[-1])], len(shape)), shape))]
        else:
            tables = [(shd.param_sharding_tree(port, sizes),
                       lambda p, shape: jtrain.spec(jshd.logical_for_path(p, len(shape)), shape)),
                      (shd.serve_param_sharding_tree(port, sizes),
                       lambda p, shape: jserve.spec(jshd.serve_logical_for_path(p, len(shape)),
                                                    shape))]
        for tree, want in tables:
            got = dict(shd.tree_paths(tree))
            for path, shape in ref:
                ls = got[path]
                assert ls.spec == tuple(want(path, shape)), (name, kind, path, ls.spec)
                _check_placements(ctx, ls)
                n_sharded += any(e is not None for e in ls.spec)
    assert n_sharded > 0


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_serving_rules_shard_output_dims_only(trees, name):
    """Every serving spec leaves a dense weight's contracted dim, the MLA
    factors, every Mamba parameter, the embedding and ``wo`` whole."""
    for kind, port, _ in trees[name]:
        if not kind.endswith("params"):
            continue
        for path, t in shd.tree_paths(port):
            logical = shd.serve_logical_for_path(path, t.dim())
            if path.endswith("/w") and t.dim() >= 2:
                assert logical[-2] is None, (path, logical)
            if path.endswith(("wo/w", "q_a/w", "q_b/w", "kv_a/w", "kv_b/w", "embed/w",
                              "in_proj/w", "out_proj/w", "x_proj/w", "dt_proj/w")):
                assert logical == (None,) * t.dim(), (path, logical)


# --------------------------- the reference's unit properties ----------------------
PREFIX_CASES = [(16, ("pod", "data")), (4, ("pod",)), (6, ("pod",)), (3, None),
                (8, ("pod", "data"))]


@pytest.mark.parametrize("dim,want", PREFIX_CASES)
def test_longest_divisible_prefix(dim, want):
    sizes = {"pod": 2, "data": 4, "model": 2}
    ctx = shd.MeshContext(sizes, {"batch": ("pod", "data")})
    jctx = jshd.MeshContext(_abstract(sizes), {"batch": ("pod", "data")})
    assert ctx.axes_for("batch", dim) == want == jctx.axes_for("batch", dim)


SPEC_CASES = [
    ({"a": ("model",), "b": ("model",)}, ("a", "b"), (4, 4)),          # each axis once
    ({}, ("batch", "heads", "ff"), (4, 8, 16)),                          # empty rules
    (None, ("no_such_axis",), (4,)),                                     # unknown name
    ({"batch": ("pod", "data")}, ("batch",), (4,)),                      # axis off the mesh
    ({"ff": ("model",)}, ("ff", None), (8, 3)),
    ({"kv_heads": ("model",), "hd": ("model",)}, (None, "kv_heads", "hd"), (2, 3, 128)),
    (None, ("batch", "heads", None), (6, 8, 5)),
]


@pytest.mark.parametrize("mesh", ["model4", "data2_model4"])
@pytest.mark.parametrize("case", range(len(SPEC_CASES)))
def test_spec_cases_equal_the_reference(case, mesh):
    rules, logical, shape = SPEC_CASES[case]
    sizes = MESHES[mesh]
    got = shd.MeshContext(sizes, rules).spec(logical, shape)
    assert got == tuple(jshd.MeshContext(_abstract(sizes), rules).spec(logical, shape))


def test_each_axis_used_once_and_unknown_replicates():
    ctx = shd.MeshContext({"data": 2, "model": 4}, {"a": ("model",), "b": ("model",)})
    assert ctx.spec(("a", "b"), (4, 4)) == ("model", None)
    assert shd.MeshContext({"model": 2}).spec(("no_such_axis",), (4,)) == (None,)


@pytest.mark.parametrize("logical,shape", [(("batch",), (4, 4)), (("batch", None, None), (4, 4))])
def test_rank_mismatch_raises(logical, shape):
    with pytest.raises(ValueError, match="rank mismatch"):
        shd.MeshContext({"data": 2, "model": 2}).spec(logical, shape)


@pytest.mark.parametrize("path,ndim,want", [
    ("blocks/mixer/wq/b", 1, (None,)),
    ("ln_f/bias", 1, (None,)),
    ("embed/w", 4, (None,) * 4),
    ("blocks/ffn/router/w", 2, ("fsdp", None)),
    ("blocks/mixer/out_proj/w", 3, (None, "tp", "fsdp")),
    ("blocks/0/ffn/w_gate/m", 3, (None, None, None)),
    ("blocks/ffn/w_up", 4, (None, "experts", None, "fsdp")),
])
def test_logical_for_path_edges(path, ndim, want):
    assert shd.logical_for_path(path, ndim) == want == jshd.logical_for_path(path, ndim)


def test_use_mesh_nesting_restores():
    assert shd.current() is None
    with shd.use_mesh({"model": 2}) as outer:
        assert shd.current() is outer
        with shd.use_mesh(shd.MeshContext({"model": 2}, {})) as inner:
            assert shd.current() is inner
        assert shd.current() is outer
    assert shd.current() is None


def test_use_mesh_pops_on_exception():
    with pytest.raises(RuntimeError):
        with shd.use_mesh({"model": 2}):
            raise RuntimeError("boom")
    assert shd.current() is None


def test_repl_act_without_a_mesh():
    """No context: the identity at full width; a narrower dim raises,
    since nothing could gather it."""
    x = torch.ones(2, 3)
    assert shd.repl_act(x, -1, 3) is x
    with pytest.raises(RuntimeError):
        shd.repl_act(x, -1, 6)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_local_shard_blocks_tile_the_leaf(mesh):
    """Each rank's block of a leaf, cut at its coordinates, tiles the leaf
    in the order the spec names (the first axis outermost)."""
    sizes = MESHES[mesh]
    t = torch.arange(16 * 8 * 3, dtype=torch.float32).reshape(16, 8, 3)
    rules = {"batch": ("pod", "data"), "ff": ("model",)}
    spec = shd.MeshContext(sizes, rules).spec(("batch", "ff", None), t.shape)
    coords = [dict(zip(sizes, c)) for c in np.ndindex(*sizes.values())]
    blocks = {}
    for c in coords:
        ctx = shd.MeshContext(sizes, rules, coords=c)
        b = ctx.local_shard(t, spec)
        assert tuple(b.shape) == ctx.local_shape(spec, t.shape)
        key = tuple(ctx._split(e)[1] for e in spec)
        assert blocks.setdefault(key, b).equal(b)
    rows = [[blocks[(i, j, 0)] for j in range(8 // blocks[(0, 0, 0)].shape[1])]
            for i in range(16 // blocks[(0, 0, 0)].shape[0])]
    assert torch.equal(torch.cat([torch.cat(r, 1) for r in rows], 0), t)


def test_production_mesh_description():
    assert make_production_mesh() == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
    ctx = shd.MeshContext(make_production_mesh(multi_pod=True))
    assert ctx.rules["batch"] == ("pod", "data")
    am = _abstract(make_production_mesh(multi_pod=True))
    cfg = configs.get_config("qwen2.5-3b")
    shape = (cfg.d_model, cfg.vocab_size)
    assert ctx.spec(("fsdp", "vocab"), shape) == tuple(
        jshd.MeshContext(am).spec(("fsdp", "vocab"), shape))


def test_holds_shard_tells_blocks_from_whole_leaves():
    """The blocks ``shard_tree`` cut, and a layer's view of one, are
    shards under their serving context; a replicated leaf, a copy of a
    block, and any leaf outside the context are not."""
    ctx = shd.serving_context({"model": 2})
    tree = {"wq": {"w": torch.zeros(2, 4, 8)}, "wo": {"w": torch.zeros(2, 8, 4)}}
    local = shd.shard_tree(tree, shd.serve_param_sharding_tree(tree, ctx), ctx)
    wq, wo = local["wq"]["w"], local["wo"]["w"]
    assert tuple(wq.shape) == (2, 4, 4) and wo is tree["wo"]["w"]
    with shd.use_mesh(ctx):
        assert shd.is_shard(wq) and shd.is_shard(torch.unbind(wq, 0)[1])
        assert not shd.is_shard(wo) and not shd.is_shard(wo[0])
        assert not shd.is_shard(wq.clone())
    assert not shd.is_shard(wq)


# ------------------------ training's state and batch layouts -----------------------
# The reference's ``launch.dryrun`` rules, restated (see the module docstring).
_J_MOMENT = re.compile(r"/(m|v|err)$")
_J_ROW = re.compile(r"/vr$")
_J_COL = re.compile(r"/vc$")
_J_QUANT = re.compile(r"/(m_q|m_s|v_q|v_s)$")
_J_BATCH = {"tokens": ("batch", None), "targets": ("batch", None),
            "loss_mask": ("batch", None), "embeds": ("batch", "seq_sp", None),
            "position_ids": (None, "batch", None)}


def _ref_state_spec(jctx, path, shape):
    """``repro.launch.dryrun.state_shardings``'s spec of one leaf."""
    ndim = len(shape)
    if _J_QUANT.search(path):
        return tuple(jctx.spec((None,) * ndim, shape))
    base, transform = path, None
    if _J_ROW.search(path):
        base, transform = _J_ROW.sub("", path), "row"
    elif _J_COL.search(path):
        base, transform = _J_COL.sub("", path), "col"
    elif _J_MOMENT.search(path):
        base = _J_MOMENT.sub("", path)
    base = base.replace("/mu/", "/params/")
    logical = jshd.logical_for_path(base, ndim if transform is None else ndim + 1)
    if transform == "row":
        logical = logical[:-1]
    elif transform == "col":
        logical = logical[:-2] + logical[-1:]
    if len(logical) != ndim:
        logical = (None,) * ndim
    return tuple(jctx.spec(logical, shape))


STATE_OPTS = [("adamw", "int8"), ("adamw8bit", None), ("adafactor", None)]
# One architecture a family: dense GQA with biases, MLA + MoE + MTP, SSM,
# the hybrid, external embeddings.
STATE_ARCHS = ["qwen2.5-3b", "deepseek-v3-671b", "falcon-mamba-7b", "jamba-v0.1-52b",
               "qwen2-vl-72b"]


@pytest.mark.parametrize("opt,gc", STATE_OPTS)
@pytest.mark.parametrize("name", STATE_ARCHS)
def test_state_specs_equal_the_reference_leaf_for_leaf(name, opt, gc):
    """Every TrainState leaf's spec on a two- and a three-axis mesh (the
    parameters' own specs are held on all five above), at smoke size and,
    for Adafactor, whose moments factor only past 128 wide, at full size;
    every optimizer suffix and the int8 error tree reached."""
    seen = set()
    sizes_of = [(jconfigs.get_smoke_config(name), configs.get_smoke_config(name))]
    if opt == "adafactor":
        sizes_of.append((jconfigs.get_config(name), configs.get_config(name)))
    for jcfg, cfg in sizes_of:
        ref = _jax_paths(jax.eval_shape(
            lambda k: jts.init_state(k, jcfg, jget_optimizer(opt, 1e-3), gc),
            jax.random.PRNGKey(0)))
        port = state_shapes(cfg, get_optimizer(opt, 1e-3), gc)
        assert [(p, tuple(t.shape)) for p, t in shd.tree_paths(port)] == ref
        for sizes in (MESHES["data2_model4"], MESHES["pod2_data2_model2"]):
            jctx = jshd.MeshContext(_abstract(sizes))
            got = dict(shd.tree_paths(shd.state_sharding_tree(port, sizes)))
            for path, shape in ref:
                assert got[path].spec == _ref_state_spec(jctx, path, shape), (name, path)
                _check_placements(shd.MeshContext(sizes), got[path])
                seen.add(path.rsplit("/", 1)[-1] if path.startswith("opt/") else
                         path.split("/", 1)[0])
    want = {"adamw": {"m", "v", "err", "params"}, "adamw8bit": {"m_q", "m_s", "v_q", "v_s"},
            "adafactor": {"vr", "vc", "v"}}[opt]
    assert want <= seen, seen


@pytest.mark.parametrize("kind,batch,seq", [("train", 256, 4096), ("train", 3, 16),
                                            ("prefill", 32, 64), ("decode", 128, 64)])
@pytest.mark.parametrize("name", ["qwen2.5-3b", "qwen2-vl-72b", "musicgen-large"])
def test_batch_specs_equal_the_reference(name, kind, batch, seq):
    """The batch's leaves by key (tokens / embeds, M-RoPE's position ids,
    targets), a batch the data axes do not divide replicating."""
    cfg, jcfg = configs.get_smoke_config(name), jconfigs.get_smoke_config(name)
    fake = specs.batch_struct(cfg, kind, batch, seq)
    ref = jspecs.batch_struct(jcfg, kind, batch, seq)
    assert sorted(fake) == sorted(ref)
    for sizes in list(MESHES.values()) + [make_production_mesh(multi_pod=True)]:
        jctx = jshd.MeshContext(_abstract(sizes))
        got = shd.batch_sharding_tree(fake, sizes)
        for k, leaf in ref.items():
            logical = _J_BATCH.get(k, (None,) * len(leaf.shape))
            assert got[k].spec == tuple(jctx.spec(logical, leaf.shape)), (name, k, sizes)


def test_state_layout_cuts_each_rank_its_block():
    """``bridge.train_state_from_numpy(mesh=)`` cuts every leaf to the
    local shape of its spec at the rank's coordinates, and the blocks of
    all ranks tile the leaf."""
    from repro_torch import bridge

    cfg = configs.get_smoke_config("qwen2.5-3b")
    g = torch.Generator("cpu")
    g.manual_seed(0)
    whole = {"params": lm.init(cfg, g, "cpu")}
    opt = get_optimizer("adamw", 1e-3)
    whole["opt"] = opt.init(whole["params"])
    whole["step"] = torch.zeros((), dtype=torch.int32)
    arrays = shd.map_tree(lambda p, t: t.numpy(), whole)
    sizes = {"data": 2, "model": 2}
    tiles = {}
    for c in np.ndindex(2, 2):
        ctx = shd.MeshContext(sizes, coords=dict(zip(sizes, c)))
        got = bridge.train_state_from_numpy(arrays, "cpu", mesh=ctx)
        sh = shd.state_sharding_tree(whole, ctx)
        for (p, t), (_, ls), (_, w) in zip(shd.tree_paths(got), shd.tree_paths(sh),
                                           shd.tree_paths(whole)):
            assert tuple(t.shape) == ctx.local_shape(ls.spec, w.shape), p
            assert torch.equal(t, ctx.block(w, ls.spec)), p
            tiles.setdefault(p, set()).add(tuple(ctx._split(e)[1] for e in ls.spec))
    # The embedding's vocab over "model", its width over "data"; a norm whole.
    assert len(tiles["params/embed/w"]) == 4 and len(tiles["params/ln_f/scale"]) == 1
