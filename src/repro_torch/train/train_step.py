"""Train-step factory: loss -> grads -> optimizer, run eagerly.

The TrainState is a plain nested dict, the reference's layout (so a
checkpoint of either package restores into the other):
  {"params": ..., "opt": {"mu": ..., "step"}, "step": int32[, "err": the
  int8 compression's error-feedback tree]}
A step updates the state's tensors in place and returns the same dict.

With ``mesh=`` the step is one rank of the reference's sharded training
(FSDP, ``dist.fsdp``): the state holds this rank's blocks of every leaf
under ``dist.sharding.state_sharding_tree`` (``init_state(mesh=)``,
``shard_state``, ``bridge.train_state_from_numpy(mesh=)``), the step
takes the global batch and computes on this rank's rows, and its result
is the unsharded step's on the whole batch.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..analysis.scopes import precision_island
from .. import device as _device
from ..dist.fsdp import TrainContext, local_batch
from ..dist.sharding import (
    leaf_at,
    map_tree,
    state_sharding_tree,
    tree_paths,
    use_mesh,
)
from ..models import lm
from ..models.config import LMConfig
from ..optim import get_optimizer
from ..optim.adamw import Transform
from ..optim.grad_compress import compress_decompress, init_error_state
from ..spans import span
from ..tree import flatten, unflatten


def state_shapes(cfg: LMConfig, opt: Transform, grad_compression: Optional[str] = None):
    """The whole TrainState's leaves as meta tensors: the shapes a
    sharded layout is resolved on."""
    params = lm.init(cfg, torch.Generator("cpu"), "meta")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    if grad_compression == "int8":
        state["err"] = init_error_state(params)
    return state


def train_context(mesh, cfg: LMConfig, counter=None) -> TrainContext:
    """``mesh`` (a ``DeviceMesh``, ``{axis: size}`` or a ``TrainContext``)
    as the :class:`TrainContext` of ``cfg``'s step."""
    if isinstance(mesh, TrainContext):
        return mesh
    return TrainContext(mesh, lm.init(cfg, torch.Generator("cpu"), "meta"), counter=counter)


def shard_state(state, shardings):
    """This rank's blocks of a whole TrainState (``shardings``: its
    ``state_sharding_tree``)."""
    def one(path, t):
        ls = leaf_at(shardings, path)
        return ls.ctx.local_shard(t, ls.spec)

    return map_tree(one, state)


def init_state(generator: torch.Generator, cfg: LMConfig, opt: Transform,
               grad_compression: Optional[str] = None, device="cuda", mesh=None):
    """A fresh TrainState: ``lm.init`` drawn by ``generator`` (which lives
    on ``device``), the optimizer's zero state, step 0.  With ``mesh``
    this rank's blocks of it: the whole parameters are drawn (the same
    draws as without a mesh), cut and freed, and each leaf's optimizer
    state is made whole and cut one leaf at a time."""
    dev = _device.resolve(device)
    params = lm.init(cfg, generator, dev)
    if mesh is None:
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if grad_compression == "int8":
            state["err"] = init_error_state(params)
        return state
    ctx = train_context(mesh, cfg)
    shapes = state_shapes(cfg, opt, grad_compression)
    sh = state_sharding_tree(shapes, ctx)
    flat, tdef = flatten(params)
    del params
    paths = [p for p, _ in tree_paths(sh["params"])]
    blocks, mu = [], []
    for i, path in enumerate(paths):
        p, flat[i] = flat[i], None
        mu.append({k: ctx.local_shard(t, leaf_at(sh["opt"]["mu"], f"{path}/{k}").spec)
                   for k, t in opt.init(p)["mu"].items()})
        blocks.append(ctx.local_shard(p, leaf_at(sh["params"], path).spec))
        del p
    state = {"params": unflatten(tdef, blocks),
             "opt": {"mu": unflatten(tdef, mu),
                     "step": torch.zeros((), dtype=torch.int32, device=dev)},
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if grad_compression == "int8":
        state["err"] = map_tree(lambda p, t: torch.zeros(
            ctx.local_shape(leaf_at(sh["err"], p).spec, t.shape), dtype=torch.float32,
            device=dev), shapes["err"])
    return state


def _resolver():
    """``device.resolve`` for a step's params' device, once a device: a
    step may get params moved to the card by hand, never resolved."""
    seen = set()

    def at(dev):
        if dev not in seen:
            _device.resolve(dev)
            seen.add(dev)
        return dev

    return at


def _on_device(batch, dev):
    return {k: (torch.from_numpy(np.asarray(v)).to(dev) if not torch.is_tensor(v) else v.to(dev))
            for k, v in batch.items()}


def make_train_step(cfg: LMConfig, opt: Transform, grad_compression: Optional[str] = None,
                    grad_clip: float = 1.0, mesh=None) -> Callable:
    """Returns step(state, batch) -> (state, metrics): the gradients of
    ``lm.loss_fn`` by autograd (in the parameters' dtype); with
    ``grad_compression="int8"`` each passed through ``compress_decompress``
    with the state's error feedback; all scaled so their global f32 norm
    is at most ``grad_clip``; then ``opt.apply``.  ``batch`` holds numpy
    arrays or tensors, moved to the parameters' device.  Metrics: the
    loss's ("ce", "aux"[, "mtp"], "loss") and the pre-clip "grad_norm",
    0-d f32 tensors.  The optimizer's part runs in the profiler range
    "train_optimizer" (``spans.span``).

    ``mesh`` (a ``DeviceMesh`` of ("data", "model") axes, or any mesh
    ``train_context`` takes): one rank's FSDP step on a state of its
    blocks and the global batch (module docstring).  The gradients reach
    the optimizer as blocks summed over the data ranks; the compression
    and the non-elementwise optimizers (8-bit AdamW's 256-wide blocks,
    Adafactor's row and column means) run on each leaf gathered whole,
    one leaf at a time, and keep the rank's blocks; the norm counts every
    element once.  Every rank's metrics are the global step's."""
    if mesh is not None:
        return _sharded_step(cfg, opt, grad_compression, grad_clip, train_context(mesh, cfg))
    resolved = _resolver()

    def step(state, batch):
        flat_p, tdef = flatten(state["params"])
        batch = _on_device(batch, resolved(flat_p[0].device))
        loss, metrics, grads = _loss_and_grads(state["params"], batch, cfg)
        with torch.no_grad(), span("train_optimizer"), \
                precision_island("optimizer"):
            if grad_compression == "int8":
                flat_e, _ = flatten(state["err"])
                for i, e in enumerate(flat_e):
                    grads[i], new_e = compress_decompress(grads[i], e)
                    e.copy_(new_e)
            # Global-norm clipping, accumulated in f32 leaf by leaf.
            gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32, copy=True).square_())
                                   for g in grads))
            _clip(grads, gnorm, grad_clip)
            opt.apply(unflatten(tdef, grads), state["opt"], state["params"])
            del grads
            state["step"].add_(1)
        metrics["grad_norm"] = gnorm
        return state, metrics

    return step


def _loss_and_grads(params, batch, cfg: LMConfig):
    """(loss, detached metrics, the gradient of every parameter leaf, in
    flatten order): zeros for a leaf the loss never reads (an MTP head
    beside external embeddings), as jax.grad gives it."""
    flat_p, tdef = flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat_p]
    with torch.enable_grad():
        loss, metrics = lm.loss_fn(unflatten(tdef, leaves), batch, cfg)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    del leaves
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat_p)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _clip(grads, gnorm, grad_clip: float) -> None:
    scale = torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    for i, g in enumerate(grads):
        # Out of place: autograd may hand two leaves one tensor.
        grads[i] = g * scale.to(g.dtype)


def _sharded_step(cfg: LMConfig, opt: Transform, grad_compression: Optional[str],
                  grad_clip: float, ctx: TrainContext) -> Callable:
    """``make_train_step(mesh=)``'s step on ``ctx``."""
    sh = state_sharding_tree(state_shapes(cfg, opt, grad_compression), ctx)
    p_specs = [ls.spec for _, ls in tree_paths(sh["params"])]
    s_specs = [{k: ls.spec for k, ls in m.items()}
               for m in flatten(sh["opt"]["mu"], upto=flatten(sh["params"])[1])[0]]

    resolved = _resolver()

    def whole(t, spec):
        return ctx.gather_block(t, spec)

    def step(state, batch):
        flat_p, tdef = flatten(state["params"])
        dev = resolved(flat_p[0].device)
        with use_mesh(ctx):
            rows = local_batch(_on_device(batch, dev), ctx)
            loss, metrics, grads = _loss_and_grads(state["params"], rows, cfg)
        with torch.no_grad(), span("train_optimizer"), \
                precision_island("optimizer"):
            if grad_compression == "int8":
                flat_e, _ = flatten(state["err"])
                for i, (e, spec) in enumerate(zip(flat_e, p_specs)):
                    deq, new_e = compress_decompress(whole(grads[i], spec), whole(e, spec))
                    grads[i] = ctx.block(deq, spec).clone()
                    e.copy_(ctx.block(new_e, spec))
            local = torch.zeros((), dtype=torch.float32, device=dev)
            for g, spec in zip(grads, p_specs):
                if ctx.counts_once(spec):
                    local = local + torch.sum(g.to(torch.float32, copy=True).square_())
            gnorm = torch.sqrt(ctx.sum_over(local, ctx.axis_names))
            _clip(grads, gnorm, grad_clip)
            st = state["opt"]
            t = st["step"] + 1
            lr_t = opt.lr(t)
            flat_s, _ = flatten(st["mu"], upto=tdef)
            for i, (g, s, p) in enumerate(zip(grads, flat_s, flat_p)):
                grads[i] = None
                if opt.elementwise:
                    opt.apply_leaf(g, s, p, t, lr_t)
                    continue
                spec = p_specs[i]
                pw = whole(p, spec)
                sw = {k: whole(v, s_specs[i][k]) for k, v in s.items()}
                opt.apply_leaf(whole(g, spec), sw, pw, t, lr_t)
                if pw is not p:
                    p.copy_(ctx.block(pw, spec))
                for k, v in s.items():
                    if sw[k] is not v:
                        v.copy_(ctx.block(sw[k], s_specs[i][k]))
            st["step"].copy_(t)
            state["step"].add_(1)
        metrics["grad_norm"] = gnorm
        return state, metrics

    return step


def build(cfg: LMConfig, optimizer: str = "adamw", lr=3e-4,
          grad_compression: Optional[str] = None, seed: int = 0, device="cuda", **opt_kw):
    """(a fresh TrainState drawn from ``seed`` on ``device``, its step
    function)."""
    dev = _device.resolve(device)
    opt = get_optimizer(optimizer, lr, **opt_kw)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = init_state(gen, cfg, opt, grad_compression, dev)
    return state, make_train_step(cfg, opt, grad_compression)


# ------------------------------ lint contract --------------------------------
from ..analysis.registry import Built, DonationUnit, Replay, register_contract  # noqa: E402


@register_contract(
    "train.train_step",
    checks=("donation", "transfers", "recompile", "precision"),
    description="train step at a smoke config with bf16 params/compute: the TrainState "
                "(params, moments, counters) updated in place leaf for leaf, repeated "
                "same-shape steps on one call signature, a step with no implicit transfer "
                "and no host sync, and the recorded step (forward, backward, optimizer) "
                "satisfying the bf16 policy — f32 only inside the declared islands "
                "(norm/rope/attn/logits/xent and the optimizer's f32 moments), every "
                "low-precision product accumulating at f32",
)
def _build_train_step_contract(device) -> Built:
    import dataclasses

    from ..analysis.op_trace import canonical_signature, record
    from ..analysis.registry import PrecisionPolicy
    from ..configs import get_smoke_config

    # bf16 params + compute (f32 optimizer moments over bf16 weights):
    # the config the widening audit has teeth at, since every f32 region
    # must then be a declared island.
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    opt = get_optimizer("adamw", 1e-3)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_state(gen, cfg, opt, device=device)
    step = make_train_step(cfg, opt)
    B, S = 2, 16

    def batch_of(seed: int):
        toks = torch.randint(0, cfg.vocab_size, (B, S),
                             generator=torch.Generator().manual_seed(seed),
                             dtype=torch.int32).to(device)
        return {"tokens": toks, "targets": torch.roll(toks, -1, 1),
                "loss_mask": torch.ones((B, S), dtype=torch.float32, device=device)}

    # Replay: two same-shape steps on the state they update.
    signatures = []
    for i in range(2):
        batch = batch_of(i)
        signatures.append(("train_step", canonical_signature((state, batch))))
        step(state, batch)
    hot_batch = batch_of(2)

    def hot():
        return step(state, hot_batch)

    return Built(
        donation=[DonationUnit("train_step", hot, lambda: state)],
        hot=hot, hot_label="train_step call", sync_budget=0,
        replay=Replay(signatures=signatures, max_programs={"train_step": 1}),
        programs=[("train_step", record(hot))],
        precision=PrecisionPolicy(compute_dtype=cfg.compute_dtype),
    )
