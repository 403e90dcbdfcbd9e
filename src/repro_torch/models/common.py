"""Shared model building blocks: dense projections, norms, rotary
positions, FFNs and init helpers.

Plain functions on tensors over plain dict parameter trees, in the
reference's layout (a dense ``w`` is (d_in, d_out)), so
``bridge.params_from_numpy`` carries ``repro.models.lm.init`` trees over
unchanged.  The reference's f32 "precision islands" (norms, rope,
logits) are kept as explicit upcasts here, each inside its declared
``precision_island`` (``analysis.scopes``, re-exported here with
``named_call`` and the decorator ``in_island``), which the contract lint
reads.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..analysis.scopes import in_island, named_call, precision_island  # noqa: F401
from ..dist.fsdp import data_ranks, data_sum
from ..dist.sharding import is_shard, repl_act, shard_offset


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               bias: bool = False, scale=None, lead=()):
    """``w`` (*lead, d_in, d_out) ~ N(0, 1) * scale (1/sqrt(d_in) by
    default), drawn in f32 on ``device`` from ``gen`` one (d_in, d_out)
    matrix at a time and cast to ``dtype``; ``b`` zeros.  ``lead`` is the
    reference's stacked layer-group axis."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.empty((*lead, d_in, d_out), dtype=dtype, device=device)
    if w.device.type == "meta":         # shapes only (a layout's full shapes)
        return {"w": w, **({"b": torch.empty((*lead, d_out), dtype=dtype, device=device)}
                           if bias else {})}
    for m in w.view(-1, d_in, d_out):
        m.copy_(torch.randn((d_in, d_out), generator=gen, device=device,
                            dtype=torch.float32).mul_(scale))
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


# Pluggable matmul for every ``dense`` of the model stack.
# ``sim.functional.dcim_numerics`` installs a DCIM macro simulator here so
# serving (Engine / Scheduler) runs its projections with the generated
# macro's numerics; ``None`` is the plain float path.  Read at call time.
_MVM_IMPL = None


def set_mvm_impl(fn):
    """Install ``fn(x, w) -> y`` as the dense matmul; returns the previous
    implementation (for restore-on-exit context managers).  Under a
    serving mesh a weight that is this rank's block of columns is passed
    as ``fn(x, w, shard=True)``."""
    global _MVM_IMPL
    prev = _MVM_IMPL
    _MVM_IMPL = fn
    return prev


@in_island("dense")
def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) [+ b], in x's dtype.  The float
    path accumulates in f32 and rounds once to x's dtype, as the
    reference's ``preferred_element_type=f32`` product does: the CPU's
    bf16 products accumulate in f32, and on the card ``device.resolve``
    turns cuBLAS's reduced-precision reduction off.  Under a serving mesh
    ``w`` may be this rank's block of output columns; a bias wider than
    the output (biases replicate) adds this rank's columns of it."""
    w = p["w"] if p["w"].dtype == x.dtype else p["w"].to(x.dtype)
    if _MVM_IMPL is None:
        y = torch.matmul(x, w)
    else:
        y = (_MVM_IMPL(x, w, shard=True) if is_shard(p["w"]) else _MVM_IMPL(x, w)).to(x.dtype)
    if "b" in p:
        b, n = p["b"], y.shape[-1]
        if b.shape[-1] != n:
            b = b.narrow(-1, shard_offset(n, b.shape[-1]), n)
        y = y + b.to(x.dtype)
    return y


def last_valid_hidden(h: torch.Tensor, valid_len=None) -> torch.Tensor:
    """The hidden state of the last real token per row: h (B, S, D);
    ``valid_len`` None (index S-1), an int (all rows), or a (B,) tensor
    of per-row lengths (rows with 0 clamp to index 0: junk the caller
    ignores).  Returns (B, 1, D)."""
    if valid_len is None:
        return h[:, -1:]
    B = h.shape[0]
    if isinstance(valid_len, int):
        idx = torch.full((B,), max(valid_len - 1, 0), dtype=torch.long, device=h.device)
    else:
        idx = torch.clamp_min(valid_len.to(torch.long) - 1, 0)
    return h[torch.arange(B, device=h.device), idx].unsqueeze(1)


def page_write_indices(block_tables, ctx_len, tail_valid, T: int, page_size: int):
    """(page, row) scatter indices for writing T tail positions into a
    paged KV pool: position t of row b lands at global position
    ``ctx_len[b] + t``, i.e. page ``block_tables[b, g // page_size]``, row
    ``g % page_size``.  Positions at or past ``tail_valid`` (bucket
    right-padding) go to the garbage page 0.  Returns two (B, T) int32
    tensors (page_idx, row_idx)."""
    t = torch.arange(T, dtype=torch.int32, device=block_tables.device)
    gpos = ctx_len[:, None].to(torch.int32) + t[None, :]
    in_tail = t[None, :] < tail_valid[:, None]
    nb = block_tables.shape[1]
    # Clamp only the index used for the lookup: pad positions may run
    # past the table (the reference's gather clamps the same way) and are
    # sent to the garbage page below.
    slot_idx = torch.clamp(torch.div(gpos, page_size, rounding_mode="floor"), max=nb - 1)
    pg = torch.gather(block_tables.to(torch.int64), 1, slot_idx.to(torch.int64))
    pg = torch.where(in_tail, pg, 0)
    rw = torch.where(in_tail, gpos % page_size, 0)
    return pg.to(torch.int32), rw.to(torch.int32)


# --- norms ------------------------------------------------------------------
def norm_init(d: int, kind: str, dtype, device, lead=()):
    p = {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}
    if kind != "rms":
        p["bias"] = torch.zeros((*lead, d), dtype=dtype, device=device)
    return p


@in_island("norm")
def norm_apply(p, x: torch.Tensor, kind: str, eps: float = 1e-5) -> torch.Tensor:
    """RMS or layer norm, computed in f32 and cast back to x's dtype."""
    xf = x.to(torch.float32)
    if kind == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# --- rotary positions -----------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # theta stays a Python scalar: a tensor made from it on the card would
    # be a host-to-device copy, which synchronises the host with the
    # stream at every call (twice a layer).
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


@in_island("rope")
def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, n_heads, head_dim); positions broadcastable to (..., S).
    Rotates the two halves of the head dim, in f32."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                           # (hd/2,)
    ang = positions[..., None].to(torch.float32) * inv               # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                               # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@in_island("rope")
def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections, theta: float) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: x (..., S, n_heads, head_dim); positions
    (3, ..., S), the temporal, height and width streams.  The hd/2 rotary
    channels are cut into ``sections`` (summing to hd/2), channel c taking
    stream ``repeat(arange(3), sections)[c]``; the rotation is
    ``apply_rope``'s, on the two halves of the head dim, in f32."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to head_dim/2 = {hd // 2}")
    inv = rope_freqs(hd, theta, x.device)                           # (hd/2,)
    # Stream i repeated over its section's channels: no index tensor, so
    # nothing is copied from the host on the card.
    pos = positions.to(torch.float32)
    pos_c = torch.cat([pos[i][..., None].expand(*pos.shape[1:], n)
                       for i, n in enumerate(sections)], dim=-1)   # (..., S, hd/2)
    ang = pos_c * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """MusicGen's fixed sinusoidal embeddings, f32: positions (..., S) ->
    (..., S, d_model), ``[sin, cos]`` of position x exp(-ln(10^4) i / half)
    for i < half = d_model // 2."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --- feed-forward -----------------------------------------------------------------
def ffn_init(gen, d_model: int, d_ff: int, act: str, dtype, device, bias: bool = False,
             lead=()):
    """w_up, [w_gate,] w_down, as the reference lays them out."""
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype, device, bias, lead=lead)}
    if act == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device, bias, lead=lead)
    p["w_down"] = dense_init(gen, d_ff, d_model, dtype, device, bias, lead=lead)
    return p


def ffn_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    up = dense(p["w_up"], x)
    if act == "swiglu":
        h = F.silu(dense(p["w_gate"], x)) * up
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(act)
    # Exact serving gathers the ff dim before the w_down contraction.
    return dense(p["w_down"], repl_act(h, -1, p["w_down"]["w"].shape[-2]))


# --- loss ---------------------------------------------------------------------------
def softmax_xent_chunked(logits_fn, h: torch.Tensor, targets: torch.Tensor,
                         mask: Optional[torch.Tensor], chunk: int = 0) -> torch.Tensor:
    """Mean cross-entropy over a vocabulary too wide for the full (B, S, V)
    logits: ``logits_fn`` maps (B, C, D) hidden states to (B, C, V) f32
    logits, taken ``chunk`` positions at a time (the whole sequence when
    ``chunk <= 0``, ``S % chunk != 0`` or ``S == chunk``, as the
    reference takes it).  Each chunk runs under ``checkpoint``, so its
    logits are freed once its loss is taken and made again in the
    backward; the chunks' sums add in order, as the reference's scan
    adds them.  ``mask`` (B, S) weights each position (None: all 1).
    Under a sharded train step the sum and the mask count are summed over
    the data ranks before the division (``dist.fsdp.data_sum``)."""
    B, S, _ = h.shape
    if chunk <= 0 or S % chunk != 0 or S == chunk:
        tot, cnt = _xent(logits_fn(h), targets, mask)
    else:
        def one(hc, tc, mc):
            return _xent(logits_fn(hc), tc, mc)

        tot = cnt = 0.0
        for c0 in range(0, S, chunk):
            sl = slice(c0, c0 + chunk)
            mc = None if mask is None else mask[:, sl]
            t, c = checkpoint(one, h[:, sl], targets[:, sl], mc, use_reentrant=False)
            tot, cnt = tot + t, cnt + c
    if data_ranks() > 1:
        # A sharded train step's rows are one block of the batch: the
        # mean is over every rank's positions.
        tot, cnt = data_sum(torch.stack([tot, cnt])).unbind(0)
    return tot / torch.clamp_min(cnt, 1.0)


@in_island("xent")
def _xent(logits: torch.Tensor, targets: torch.Tensor, mask: Optional[torch.Tensor]):
    """(sum of the masked negative log-likelihoods, sum of the mask) over
    (..., V) logits, in f32."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, targets.long()[..., None])[..., 0]
    mask = torch.ones_like(nll) if mask is None else mask.float()
    return torch.sum(nll * mask), torch.sum(mask)
