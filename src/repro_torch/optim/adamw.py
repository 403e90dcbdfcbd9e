"""AdamW with optional 8-bit moments: m and v kept as int8 codes with one
float32 scale per block of 256 values (4x less optimizer memory).  The
arithmetic is the reference's, step for step, in float32."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..analysis.scopes import in_island
from ..tree import flatten, unflatten

_BLOCK = 256
# ``apply`` takes an elementwise rule's leaves in pieces of at most this
# many elements along their leading axis, so its f32 temporaries stay
# small: a stacked (36, 2048, 11008) weight is 811 M elements, 3.2 GB a
# temporary in f32.
CHUNK_ELEMS = 1 << 26


class Transform(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]      # (grads, state, params) -> (updates, state)
    apply: Callable[..., Any]       # (grads, state, params) -> state; params in place
    # One leaf of ``apply``: (g, its moments dict, p, step, lr_t), p and
    # the moments written in place; a sharded step calls it on its blocks
    # where ``elementwise`` (each element's update depends on that element
    # alone), else on the gathered leaf.
    apply_leaf: Callable[..., None]
    elementwise: bool
    lr: Callable[[Any], Any]        # step -> learning rate


def _q8(x: torch.Tensor):
    """x -> (int8 codes (n_blocks, 256), f32 scales (n_blocks, 1)):
    scale = max |block| / 127 + 1e-12, codes round(x / scale) clipped to
    +-127 (the tail block zero-padded)."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8(q, scale, shape):
    n = 1
    for d in shape:
        n *= d
    return (q.to(torch.float32) * scale).reshape(-1)[:n].reshape(shape)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, quantize_moments: bool = False) -> Transform:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def one(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if quantize_moments:
                qm, sm = _q8(z)
                qv, sv = _q8(z)
                return {"m_q": qm, "m_s": sm, "v_q": qv, "v_s": sv}
            return {"m": z, "v": torch.zeros_like(z)}

        leaves, tdef = flatten(params)
        dev = leaves[0].device if leaves else None
        return {"mu": unflatten(tdef, [one(p) for p in leaves]),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @in_island("optimizer")
    def one(g, s, p, step, lr_t):
        """(the f32 update of one leaf, its new moments); float32 moments
        are updated in place."""
        g = g.to(torch.float32)
        if quantize_moments:
            m = _dq8(s["m_q"], s["m_s"], g.shape)
            v = _dq8(s["v_q"], s["v_s"], g.shape)
        else:
            m, v = s["m"], s["v"]
        m = m.mul_(b1).add_(g * (1 - b1))
        v = v.mul_(b2).add_(g * (1 - b2) * g)
        t = step.to(torch.float32)
        mhat = m / (1 - torch.pow(b1, t))
        vhat = v / (1 - torch.pow(b2, t))
        upd = -lr_t * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(torch.float32))
        if quantize_moments:
            (qm, sm), (qv, sv) = _q8(m), _q8(v)
            return upd, {"m_q": qm, "m_s": sm, "v_q": qv, "v_s": sv}
        return upd, {"m": m, "v": v}

    return _transform(init, one, lr_fn, elementwise=not quantize_moments)


def _pieces(p: torch.Tensor):
    """Indices cutting ``p`` along its leading axis into pieces of at most
    ``CHUNK_ELEMS`` elements (whole rows of it); ``[...]`` when it is
    small."""
    if p.dim() == 0 or p.numel() <= CHUNK_ELEMS:
        return [...]
    rows = max(1, CHUNK_ELEMS // (p.numel() // p.shape[0]))
    return [slice(r, r + rows) for r in range(0, p.shape[0], rows)]


def _transform(init, one, lr_fn, elementwise: bool = False) -> Transform:
    """A Transform from ``init`` and the per-leaf rule ``one(g, s, p, step,
    lr_t) -> (update, new moments)``, which may write the moments it is
    given in place.  ``update`` hands it copies and gathers the updates
    into a tree, leaving its arguments as they were; ``apply`` adds each
    update into its parameter as soon as it is made and leaves the new
    moments in the state's own tensors; an ``elementwise`` rule (each
    element's update depends on that element alone) is applied in
    ``_pieces``, which changes no bit."""
    def leaves(grads, state, params):
        step = state["step"] + 1
        flat_g, tdef = flatten(grads)
        flat_s, _ = flatten(state["mu"], upto=tdef)
        flat_p, _ = flatten(params)
        return step, lr_fn(step), flat_g, flat_s, flat_p, tdef

    @torch.no_grad()
    def update(grads, state, params):
        step, lr_t, flat_g, flat_s, flat_p, tdef = leaves(grads, state, params)
        outs = [one(g, {k: t.clone() for k, t in s.items()}, p, step, lr_t)
                for g, s, p in zip(flat_g, flat_s, flat_p)]
        return (unflatten(tdef, [o[0] for o in outs]),
                {"mu": unflatten(tdef, [o[1] for o in outs]), "step": step})

    @torch.no_grad()
    @in_island("optimizer")
    def apply_leaf(g, s, p, step, lr_t):
        for sl in (_pieces(p) if elementwise else [...]):
            part = s if sl is ... else {k: t[sl] for k, t in s.items()}
            u, new = one(g[sl], part, p[sl], step, lr_t)
            p[sl] = (p[sl].to(torch.float32) + u).to(p.dtype)
            for k, t in new.items():
                if t is not part[k]:
                    part[k].copy_(t)

    @torch.no_grad()
    def apply(grads, state, params):
        step, lr_t, flat_g, flat_s, flat_p, _ = leaves(grads, state, params)
        for g, s, p in zip(flat_g, flat_s, flat_p):
            apply_leaf(g, s, p, step, lr_t)
        state["step"].copy_(step)
        return state

    return Transform(init, update, apply, apply_leaf, elementwise, lr_fn)


@torch.no_grad()
@in_island("optimizer")
def apply_updates(params, updates):
    """A new tree: each parameter plus its f32 update, cast back to the
    parameter's dtype."""
    flat_p, tdef = flatten(params)
    flat_u, _ = flatten(updates)
    return unflatten(tdef, [(p.to(torch.float32) + u).to(p.dtype)
                            for p, u in zip(flat_p, flat_u)])
