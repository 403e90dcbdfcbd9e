"""Training cells: a closed loop of the port's train step
(``train.train_step.make_train_step``) on one state.

Set-up draws the weights on the card, keeps a host copy of them, builds
the step and the AdamW state, and drives that one state through the
mix's first ``setup_steps`` steps through the window's own call and
feed, reading what the reference will follow: each step's loss, the
first gradient as the optimizer got it (AdamW's first moment after one
step is (1 - b1) g), and the change of every parameter after the last
set-up step.  The window then runs whole steps on the same state until
``seconds`` have passed; its rate is the tokens of every step it ran
over all of its time.  A traced run profiles one step in the window's
middle.

After the window the peak memory is read, the program's state is freed
and the plain reference runs the same set-up steps in float32 from the
host copy, on the same batches.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import torch

from . import spec, traffic, weights
from . import trace as tr


class Run:
    def __init__(self, cell, w, seconds):
        self.cell, self.widths, self.seconds = cell, w, seconds
        self.kind = "train"


def lr_schedule(lr: dict):
    """``lr(step)`` as a float: linear warm-up to ``peak`` over ``warmup``
    steps, then a cosine to a tenth of it at ``total`` (the program's
    ``cosine_warmup``, worked out again)."""
    if lr["schedule"] != "cosine_warmup":
        raise ValueError(f"unknown schedule {lr['schedule']!r}")
    peak, warm, total = float(lr["peak"]), int(lr["warmup"]), int(lr["total"])

    def at(step: int) -> float:
        if step < warm:
            return peak * step / max(warm, 1)
        frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
        return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * frac)))

    return at


def program_step(cfg, mix):
    from repro_torch.optim import cosine_warmup, get_optimizer
    from repro_torch.train.train_step import make_train_step

    o, lr = mix["optimizer"], mix["lr"]
    opt = get_optimizer(o["name"], cosine_warmup(lr["peak"], lr["warmup"], lr["total"]),
                        b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"])
    return opt, make_train_step(cfg, opt, grad_clip=mix["grad_clip"])


def run(cell, seed: int, seconds: float, trace: bool, device, t_process: float,
        make_step=program_step) -> Run:
    cfg = spec.program_config(cell.config)
    w = spec.widths(cell.config)
    mix = cell.traffic
    params = weights.draw(cfg, seed, device)
    p0 = {k: v.to("cpu", copy=True) for k, v in weights.leaves(params)}
    opt, step_fn = make_step(cfg, mix)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    batch = lambda k: traffic.train_batch(mix, seed, k, w["vocab"], device)
    losses, g1, change = [], {}, {}
    b1 = mix["optimizer"]["b1"]
    n_setup = int(mix["setup_steps"])
    for k in range(1, n_setup + 1):
        state, m = step_fn(state, batch(k))
        losses.append(float(m["loss"]))
        if k == 1:
            g1 = {p: float(torch.linalg.vector_norm(mu["m"].float())) / (1 - b1)
                  for p, mu in _moments(state, params)}
    for p, t in weights.leaves(state["params"]):
        change[p] = float(torch.linalg.vector_norm(t.float() - p0[p].to(device).float()))
    _sync(device)

    tokens_per_step = mix["batch"] * mix["seq"]
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    k, steps = n_setup, 0
    prof, span, traced_s = None, 0.0, 0.0
    while True:
        k += 1
        b = batch(k)
        if trace and prof is None and time.perf_counter() - t0 >= 0.4 * seconds:
            prof = tr.profiler()
            prof.start()
            ta = time.perf_counter()
            state, _ = step_fn(state, b)
            _sync(device)
            span = time.perf_counter() - ta
            prof.stop()
            traced_s = time.perf_counter() - ta
        else:
            state, _ = step_fn(state, b)
            _sync(device)
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    r = Run(cell, w, seconds)
    r.setup_s, r.steps, r.window_s = setup_s, steps, t1 - t0
    r.tokens_per_step = tokens_per_step
    r.steps_untraced = steps - (prof is not None)
    r.window_untraced_s = r.window_s - traced_s
    r.attempted, r.failed = steps, 0
    r.trace = None if prof is None else tr.read(prof, span, range_names=("train_optimizer",))
    r.peak_bytes = int(peak)
    r.program = {"loss": losses, "g1": g1, "change": change}
    del state, params, step_fn, opt, prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    r.reference = reference_steps(cell, w, p0, batch, n_setup, device)
    r.checks = compare(r.program, r.reference, cell.data["limits"])
    return r


def _moments(state, params):
    mu = weights.by_path(state["opt"]["mu"])
    for p, _ in weights.leaves(params):
        yield p, {"m": mu[p + "/m"]}


def reference_steps(cell, w, p0: Dict[str, torch.Tensor], batch, n_steps: int, device,
                    linear=None) -> dict:
    """The set-up steps again in the plain reference: float32 products
    without TF32, the loss's gradient by autograd, the global norm clipped
    to ``grad_clip``, AdamW in float32, each parameter stored back in the
    configuration's bfloat16 (the type its weights are kept in)."""
    ref = spec.reference(cell.config)
    mix = cell.traffic
    o = mix["optimizer"]
    lr_at = lr_schedule(mix["lr"])
    kw = {} if linear is None else {"linear": linear}
    keep = {p: t.dtype for p, t in p0.items()}
    P = {p: t.to(device=device, dtype=torch.float32, copy=True).requires_grad_()
         for p, t in p0.items()}
    M = {p: torch.zeros_like(t) for p, t in P.items()}
    V = {p: torch.zeros_like(t) for p, t in P.items()}
    losses, g1 = [], {}
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for k in range(1, n_steps + 1):
            names = list(P)
            loss = ref.loss(P, batch(k), w, **kw)
            grads = torch.autograd.grad(loss, [P[n] for n in names])
            losses.append(float(loss.detach()))
            norm = math.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2 for g in grads))
            scale = min(1.0, mix["grad_clip"] / max(norm, 1e-9))
            lr = lr_at(k)
            with torch.no_grad():
                for n, g in zip(names, grads):
                    if k == 1:
                        g1[n] = scale * float(torch.linalg.vector_norm(g))
                    for sl in _pieces(g):
                        gs = g[sl] * scale
                        m, v, p = M[n][sl], V[n][sl], P[n][sl]
                        m.mul_(o["b1"]).add_(gs, alpha=1 - o["b1"])
                        v.mul_(o["b2"]).addcmul_(gs, gs, value=1 - o["b2"])
                        upd = (m / (1 - o["b1"] ** k)) / ((v / (1 - o["b2"] ** k)).sqrt_()
                                                          + o["eps"])
                        upd.add_(p, alpha=o["weight_decay"]).mul_(-lr)
                        p.copy_((p + upd).to(keep[n]).float())
            del grads
        with torch.no_grad():
            change = {p: float(torch.linalg.vector_norm(P[p] - p0[p].to(device).float()))
                      for p in P}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return {"loss": losses, "g1": g1, "change": change}


def _pieces(t: torch.Tensor, elems: int = 1 << 26):
    """Slices of ``t`` along its leading axis of at most ``elems`` elements,
    so the update's float32 temporaries stay small."""
    if t.dim() == 0 or t.numel() <= elems:
        return [...]
    rows = max(1, elems // (t.numel() // t.shape[0]))
    return [slice(r, r + rows) for r in range(0, t.shape[0], rows)]


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], leaves: List[str]) -> Dict:
    """Per leaf |got - want| over the larger of want and the median leaf's
    want: the worst, and where."""
    med = sorted(want[p] for p in leaves)[len(leaves) // 2]
    gaps = {p: abs(got[p] - want[p]) / max(want[p], med) for p in leaves}
    worst = max(gaps, key=gaps.get)
    return {"value": gaps[worst], "leaf": worst}


def compare(prog: dict, ref: dict, limits: dict) -> Dict[str, dict]:
    """The numbers that decide ``correct``: the worst step's loss gap, the
    worst leaf's gap of first-gradient norms, and the worst leaf's gap of
    parameter-change norms over the leaves the reference's first gradient
    moves (a leaf whose gradient is under a thousandth of the median
    leaf's moves under Adam by round-off alone)."""
    loss = max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"]))
    leaves = sorted(ref["g1"])
    g_med = sorted(ref["g1"][p] for p in leaves)[len(leaves) // 2]
    moved = [p for p in leaves if ref["g1"][p] >= 1e-3 * g_med]
    g = leaf_gaps(prog["g1"], ref["g1"], leaves)
    c = leaf_gaps(prog["change"], ref["change"], moved)
    return {"loss_gap": {"value": loss, "limit": limits["loss_gap"]},
            "grad_gap": {"value": g["value"], "limit": limits["grad_gap"], "leaf": g["leaf"]},
            "change_gap": {"value": c["value"], "limit": limits["change_gap"],
                           "leaf": c["leaf"]}}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
