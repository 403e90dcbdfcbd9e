"""Mixture-of-Experts FFN: a float32 top-k router over the experts'
SwiGLUs, plus the always-on shared experts (DeepSeek-V3), and the
load-balancing aux loss (Switch/GShard) on both paths.

Inference (``training=False``) is the reference's drop-free branch
(``repro/models/moe.py``): every expert on every token, the top-k gates
combining their outputs; per-token math only, so a token's output does
not depend on the batch it is served in.  Its expert products are plain
einsums there, not ``dense``, so they do not go through the
``set_mvm_impl`` hook here either; the router and the shared experts do.
Running all E experts does E / top_k times the routed work: a decode
step reads every expert's weights.  Tokens are taken in chunks whose
(E, t, F) and (E, t, D) intermediates fit ``CHUNK_BYTES``; the math is
per token, so the chunking changes nothing.

Under an exact serving mesh (``dist.sharding``) a rank holds a block of
the expert banks (of their d_ff where the experts do not divide over
the mesh): it runs its experts on every token and gathers their outputs
over the experts (their d_ff before ``w_down``), so the gates combine
the same (E, t, D) as on one device, summed in the same order.

Training (``training=True``) is the reference's GShard capacity
dispatch: tokens in groups of ``group_size`` (of 1 for decode-shaped
input), C = ceil(Tg * top_k / E * capacity_factor) slots an expert a
group, slots handed out in token order for the first choice, then the
second, and so on; a choice past its expert's capacity is dropped.  The
reference moves tokens into slots and back by one-hot einsums; here a
gather into the (E, G, C, D) slots and a weighted sum of each token's
top_k slot outputs compute the same sums (each slot holds at most one
token).  Under a sharded train step (``dist.fsdp``) Tg and C are the
global program's whatever rows a rank holds, and the aux loss's means
run over every rank's tokens.

A check that holds one path's routing to another's installs a hook with
``routing``; callers that know whose tokens a model call carries label
its rows with ``label_rows`` (a no-op while no hook is installed).  The
hook sees each MoE layer's top-k choice with those labels and may return
other expert indices, whose gates are then taken from the same router
probabilities.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..dist.fsdp import batch_block, batch_split, data_ranks, data_sum, gather_rows
from ..dist.sharding import repl_act
from .common import dense, dense_init, ffn_apply, ffn_init

# Byte budget of one token chunk's expert intermediates: the gate/up
# products (E, t, F) and the expert outputs (E, t, D).  At deepseek-v3's
# E 256, F 2048, D 7168 in bf16 a token costs 5.8 MB, so t = 279.
CHUNK_BYTES = 3 << 29

# The routing hook, fn(ids (R,), positions (R, S), layer, idx (R * S, k))
# -> None or other indices (R * S, k), and the labels of the model call in
# flight: [row ids, positions, MoE layers routed so far].  Row id < 0 or
# position < 0 marks a padding token.  Read at call time.
_ROUTING = None
_LABELS = None


@contextlib.contextmanager
def routing(fn):
    """Install ``fn`` as the routing hook for the block."""
    global _ROUTING
    prev, _ROUTING = _ROUTING, fn
    try:
        yield
    finally:
        _ROUTING = prev


@contextlib.contextmanager
def label_rows(ids, positions):
    """Label the rows of the model call in the block: ``ids`` (R,) whose
    tokens each row carries, ``positions`` (R, S) their absolute
    positions.  Free while no routing hook is installed."""
    global _LABELS
    if _ROUTING is None:
        yield
        return
    prev = _LABELS
    _LABELS = [np.asarray(ids, np.int64), np.asarray(positions, np.int64), 0]
    try:
        yield
    finally:
        _LABELS = prev


def moe_init(gen, cfg, dtype, device, lead=()):
    """router (D, E) in float32; w_gate, w_up (E, D, F) N(0, 1/D); w_down
    (E, F, D) N(0, 1/F); ``shared`` a SwiGLU of width F * n_shared.  Drawn
    one (d_in, d_out) matrix at a time; ``lead`` stacks layers."""
    m = cfg.moe
    D, E, Fd = cfg.d_model, m.n_experts, m.d_ff
    experts = (*lead, E)
    p = {
        "router": dense_init(gen, D, E, torch.float32, device, lead=lead),
        "w_gate": dense_init(gen, D, Fd, dtype, device, lead=experts)["w"],
        "w_up": dense_init(gen, D, Fd, dtype, device, lead=experts)["w"],
        "w_down": dense_init(gen, Fd, D, dtype, device, lead=experts)["w"],
    }
    if m.n_shared:
        p["shared"] = ffn_init(gen, D, Fd * m.n_shared, "swiglu", dtype, device, lead=lead)
    return p


def _group_size(T: int, group_size: int) -> int:
    """The largest size <= ``group_size`` that divides ``T`` tokens."""
    tg = min(group_size, T)
    while T % tg:
        tg -= 1
    return tg


def _group(x, group_size: int):
    """(B, S, D) -> (G, Tg, D) dispatch groups of the largest size <=
    ``group_size`` that divides B * S, and Tg: the token groups of the
    capacity dispatch.  The inference path needs none: its math is per
    token."""
    B, S, D = x.shape
    tg = _group_size(B * S, group_size)
    return x.reshape(B * S // tg, tg, D), tg


def route(p, xt, cfg):
    """The float32 router over tokens xt (T, D): softmax probabilities
    (T, E), the top-k gates renormalised with a 1e-9 floor (T, k) and
    their expert indices (T, k), which a routing hook may replace."""
    probs = torch.softmax(dense(p["router"], xt.float()), dim=-1)
    gate_vals, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    if _ROUTING is not None and _LABELS is not None:
        ids, pos, layer = _LABELS
        _LABELS[2] += 1
        n = pos.size                     # a lone token runs as a pair: the copy follows
        forced = _ROUTING(ids, pos, layer, idx[:n])
        if forced is not None:
            idx = forced.repeat(idx.shape[0] // n, 1)
            gate_vals = probs.gather(1, idx)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, idx


def moe_apply(p, x, cfg, training: bool = False):
    """x (B, S, D) -> (y (B, S, D) in x's dtype, the load-balancing aux
    loss).  ``training=False``: drop-free, each token's top-k gates
    weight every expert's SwiGLU output, the gates rounded to the
    experts' dtype, as the reference combines them.  ``training=True``:
    the capacity dispatch (``_capacity_apply``)."""
    m = cfg.moe
    B, S, D = x.shape
    E = m.n_experts
    if training:
        return _capacity_apply(p, x, cfg)
    xt = x.reshape(B * S, D)
    # A lone token runs as a pair (itself twice) and the copy is dropped:
    # a one-row product takes the matrix-vector path, whose sums are
    # ordered differently from a matrix product's, and a token's output
    # must not depend on how many tokens share its call.
    lone = xt.shape[0] == 1
    if lone:
        xt = torch.cat([xt, xt])
    probs, gate_vals, idx = route(p, xt, cfg)
    aux = _aux_loss(probs, idx, E)
    gates = torch.zeros_like(probs).scatter_(1, idx, gate_vals).to(x.dtype)

    w_gate, w_up, w_down = _expert_weights(p, x.dtype)
    El = w_gate.shape[0]                  # this rank's experts (all E off a mesh)
    per_token = E * (2 * m.d_ff + D) * x.element_size()
    t = max(1, CHUNK_BYTES // per_token)
    y = torch.empty_like(xt)
    with torch.profiler.record_function("moe_experts"):
        for t0 in range(0, xt.shape[0], t):
            xc = xt[t0:t0 + t]
            xe = xc.unsqueeze(0).expand(El, *xc.shape)                     # (El, t, D), a view
            h = F.silu(torch.bmm(xe, w_gate)).mul_(torch.bmm(xe, w_up))    # (El, t, F)
            ye = torch.bmm(repl_act(h, -1, w_down.shape[1]), w_down)       # (El, t, D)
            ye = repl_act(ye, 0, E)                                        # (E, t, D)
            y[t0:t0 + t] = torch.einsum("te,etd->td", gates[t0:t0 + t], ye)
    if m.n_shared:
        y = y + ffn_apply(p["shared"], xt, "swiglu")
    return y[:1 if lone else None].reshape(B, S, D), aux


def _aux_loss(probs, idx, E: int):
    """E * sum_e (share of tokens whose first choice is e) * (mean router
    probability of e); under a sharded train step both means are over
    every data rank's tokens."""
    onehot = F.one_hot(idx[:, 0], E).float()
    n = data_ranks()
    if n == 1:
        return E * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
    T = probs.shape[0] * n
    return E * torch.sum(data_sum(onehot.sum(dim=0)) / T * (data_sum(probs.sum(dim=0)) / T))


def _expert_weights(p, dtype):
    return tuple(p[k] if p[k].dtype == dtype else p[k].to(dtype)
                 for k in ("w_gate", "w_up", "w_down"))


def _capacity_apply(p, x, cfg):
    """The training path: GShard capacity dispatch over token groups
    (see the module docstring).  Returns (y (B, S, D), aux).

    Under a sharded train step x holds one block of the global batch's
    rows, whose tokens start at global token ``off``: the groups are the
    global program's, and where one straddles two ranks' rows, the
    routing of its other tokens is gathered (``fsdp.gather_rows``) to
    hand out its slots; each rank dispatches and combines its own
    tokens."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    T = B * S
    xt = x.reshape(T, D)
    # Decode-shaped input: each token its own group, so no row can take
    # another's capacity slot.
    tg = _group_size(T * batch_split(), 1 if S == 1 else m.group_size)
    off = batch_block() * T
    g0, g1 = off // tg, -(-(off + T) // tg)                 # the groups these tokens touch
    G = g1 - g0
    C = max(int(math.ceil(tg * k / E * m.capacity_factor)), 1)
    probs, gate_vals, idx = route(p, xt, cfg)
    aux = _aux_loss(probs, idx, E)

    # Slot of each (token, choice): the tokens of the group routed to the
    # same expert before it, counting every earlier choice's tokens,
    # dropped ones included (the reference's bookkeeping).
    grouped = idx
    if off % tg or T % tg:
        grouped = gather_rows(idx)[g0 * tg:g1 * tg]
    grouped = grouped.reshape(G, tg, k)
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    slots = []
    for kk in range(k):
        onehot = F.one_hot(grouped[..., kk], E)                             # (G, Tg, E)
        before = counts[:, None, :] + torch.cumsum(onehot, dim=1) - onehot
        slots.append(torch.sum(before * onehot, dim=-1))                    # (G, Tg)
        counts = counts + onehot.sum(dim=1)
    slot = torch.stack(slots, dim=-1).reshape(G * tg, k)[off - g0 * tg:off - g0 * tg + T]
    keep = slot < C
    grp = (torch.arange(T, device=x.device) + off) // tg - g0
    flat = (idx * G + grp[:, None]) * C + torch.where(keep, slot, 0)        # into (E, G, C)

    # Dispatch: each kept (token, choice) copied into its slot; empty
    # slots stay zero.  A dropped one goes to a spare row past the slots,
    # so that no shape depends on the routing.
    n_slots = E * G * C
    dest = torch.where(keep, flat, n_slots).reshape(T * k)
    src = xt[:, None, :].expand(T, k, D).reshape(T * k, D)
    xe = xt.new_zeros((n_slots + 1, D)).index_put_((dest,), src)[:n_slots]
    w_gate, w_up, w_down = _expert_weights(p, x.dtype)
    xe = xe.reshape(E, G * C, D)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)                 # (E, G*C, F)
    ye = torch.bmm(h, w_down).reshape(E * G * C, D)
    # Combine: each token's kept slots weighted by their gates (f32, then
    # rounded to the experts' dtype, as the reference's combine tensor),
    # summed with f32 accumulation.
    w = (gate_vals * keep).to(ye.dtype).reshape(T, 1, k)
    y = torch.bmm(w, ye[flat]).reshape(B, S, D)
    if m.n_shared:
        y = y + ffn_apply(p["shared"], x, "swiglu")
    return y, aux
