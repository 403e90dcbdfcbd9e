"""Train-step factory: loss -> grads -> optimizer, run eagerly.

The TrainState is a plain nested dict, the reference's layout (so a
checkpoint of either package restores into the other):
  {"params": ..., "opt": {"mu": ..., "step"}, "step": int32[, "err": the
  int8 compression's error-feedback tree]}
A step updates the state's tensors in place and returns the same dict.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve
from ..models import lm
from ..models.config import LMConfig
from ..optim import get_optimizer
from ..optim.adamw import Transform
from ..optim.grad_compress import compress_decompress, init_error_state
from ..tree import flatten, unflatten


def init_state(generator: torch.Generator, cfg: LMConfig, opt: Transform,
               grad_compression: Optional[str] = None, device="cuda"):
    """A fresh TrainState: ``lm.init`` drawn by ``generator`` (which lives
    on ``device``), the optimizer's zero state, step 0."""
    dev = resolve(device)
    params = lm.init(cfg, generator, dev)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if grad_compression == "int8":
        state["err"] = init_error_state(params)
    return state


def _on_device(batch, dev):
    return {k: (torch.from_numpy(np.asarray(v)).to(dev) if not torch.is_tensor(v) else v.to(dev))
            for k, v in batch.items()}


def make_train_step(cfg: LMConfig, opt: Transform, grad_compression: Optional[str] = None,
                    grad_clip: float = 1.0) -> Callable:
    """Returns step(state, batch) -> (state, metrics): the gradients of
    ``lm.loss_fn`` by autograd (in the parameters' dtype); with
    ``grad_compression="int8"`` each passed through ``compress_decompress``
    with the state's error feedback; all scaled so their global f32 norm
    is at most ``grad_clip``; then ``opt.apply``.  ``batch`` holds numpy
    arrays or tensors, moved to the parameters' device.  Metrics: the
    loss's ("ce", "aux"[, "mtp"], "loss") and the pre-clip "grad_norm",
    0-d f32 tensors.  The forward and the optimizer's part run in the
    profiler ranges "train_forward" and "train_optimizer"."""

    def step(state, batch):
        flat_p, tdef = flatten(state["params"])
        batch = _on_device(batch, flat_p[0].device)
        leaves = [p.detach().requires_grad_() for p in flat_p]
        with torch.enable_grad():
            with torch.profiler.record_function("train_forward"):
                loss, metrics = lm.loss_fn(unflatten(tdef, leaves), batch, cfg)
            grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        del leaves
        with torch.no_grad(), torch.profiler.record_function("train_optimizer"):
            # A leaf the loss never reads (an MTP head beside external
            # embeddings) gets zeros, as jax.grad gives it.
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat_p)]
            if grad_compression == "int8":
                flat_e, _ = flatten(state["err"])
                for i, e in enumerate(flat_e):
                    grads[i], new_e = compress_decompress(grads[i], e)
                    e.copy_(new_e)
            # Global-norm clipping, accumulated in f32 leaf by leaf.
            gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32, copy=True).square_())
                                   for g in grads))
            scale = torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
            for i, g in enumerate(grads):
                # Out of place: autograd may hand two leaves one tensor.
                grads[i] = g * scale.to(g.dtype)
            opt.apply(unflatten(tdef, grads), state["opt"], state["params"])
            del grads
            state["step"].add_(1)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return state, metrics

    return step


def build(cfg: LMConfig, optimizer: str = "adamw", lr=3e-4,
          grad_compression: Optional[str] = None, seed: int = 0, device="cuda", **opt_kw):
    """(a fresh TrainState drawn from ``seed`` on ``device``, its step
    function)."""
    dev = resolve(device)
    opt = get_optimizer(optimizer, lr, **opt_kw)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = init_state(gen, cfg, opt, grad_compression, dev)
    return state, make_train_step(cfg, opt, grad_compression)
