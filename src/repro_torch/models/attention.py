"""GQA and MLA attention: the chunked-flash prefill, monolithic and paged
decode, and the paged [reused prefix ; causal tail] prefill.

Layouts as in the reference: activations (B, S, H, hd); monolithic caches
(B, S_max, Hk, hd); paged pools (n_pages, page, Hk, hd) addressed by a
(B, nb) int32 block table, page 0 being the garbage page.  The paged
paths run their attention core through ``kernels.ops`` (K4
``paged_decode_gqa``, K5 ``prefix_prefill``): the hand-written kernel
for CUDA tensors, its plain version (``decode_attention`` /
``prefix_attention`` over gathered pages) for CPU tensors.

MLA (DeepSeek-V3) keeps the compressed cache: c_kv (.., r) and k_rope
(.., dr) rows instead of per-head K/V.  The prefill paths reconstruct
per-head K/V through ``kv_b``; decode absorbs ``w_uk`` into the query
and attends in the c_kv space (``mla_attend_core``; K6
``paged_decode_mla`` through a paged pool), then up-projects with
``w_uv`` in float32.

Caches are updated in place: the reference's programs donate the pool
and rebind it, so an in-place write is the same effect without a copy.
The functions still return the cache, as the reference's do.

Under an exact serving mesh (``dist.sharding``) a rank holds the GQA
projections' columns of its block of heads: the head counts are taken
from the local widths, never from ``cfg``.  The rules shard columns, so
a block that splits a head is gathered to whole heads.  Where the kv
heads do not divide over the mesh they replicate while the q heads
shard, and the kernels pair q head h with kv head h // (Hq / Hk) of
their operands' shapes: ``_kv_for_q`` hands the attention core the kv
head of this rank's q heads (a contiguous copy, as the kernels take
dense pointers).  The heads are gathered before ``wo``; MLA replicates
whole.
"""
from __future__ import annotations

import math

import torch

from ..dist.sharding import repl_act, shard_offset
from ..kernels import ops as kops
from ..kernels.ref import (  # noqa: F401  (re-export)
    NEG_INF,
    decode_attention,
    gather_pages,
    mla_attend_core,
    prefix_attention,
)
from .common import (
    apply_mrope,
    apply_rope,
    dense,
    dense_init,
    in_island,
    norm_apply,
    norm_init,
    precision_island,
)


@in_island("attn")
def flash_attention(q, k, v, q_offset: int = 0, kv_valid=None, causal: bool = True,
                    q_chunk: int = 512, kv_chunk: int = 512) -> torch.Tensor:
    """Chunked attention with an online softmax: q (B, Sq, H, hd), k/v
    (B, Sk, Hk, hd[v]) -> (B, Sq, H, hdv) in v's dtype.  Causal masking
    puts q[0] at ``q_offset``; ``kv_valid`` masks key positions at or
    past it.  KV chunks past a q chunk's causal diagonal contribute
    nothing and are skipped.  Plain tensor ops, so autograd takes its
    gradient (the training forwards); the backward keeps every chunk
    pair's f32 scores and probabilities, which ``cfg.remat`` bounds to
    one layer group's."""
    B, Sq, H, hd = q.shape
    _, Sk, Hk, hdv = v.shape
    G = H // Hk
    qs = q * (1.0 / math.sqrt(hd))
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    dev = q.device
    kpos_all = torch.arange(Sk, device=dev)
    out = torch.empty((B, Sq, H, hdv), dtype=v.dtype, device=dev)
    for q0 in range(0, Sq, q_chunk):
        q1 = min(Sq, q0 + q_chunk)
        qn = q1 - q0
        qc = qs[:, q0:q1].reshape(B, qn, Hk, G, hd).float()
        qpos = q_offset + torch.arange(q0, q1, device=dev)
        m = torch.full((B, Hk, G, qn), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hk, G, qn), dtype=torch.float32, device=dev)
        o = torch.zeros((B, qn, Hk, G, hdv), dtype=torch.float32, device=dev)
        k_hi = min(Sk, q_offset + q1) if causal else Sk
        for k0 in range(0, max(k_hi, 1), kv_chunk):
            k1 = min(Sk, k0 + kv_chunk)
            s = torch.einsum("bqhgd,bchd->bhgqc", qc, k[:, k0:k1].float())
            kpos = kpos_all[k0:k1]
            mask = torch.ones((qn, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if kv_valid is not None:
                mask &= kpos[None, :] < kv_valid
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # Fully masked rows have s == m_new == NEG_INF: re-mask so
            # exp(0) == 1 cannot leak into l and o.
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            vc = v[:, k0:k1]
            pv = torch.einsum("bhgqc,bchd->bqhgd", p.to(vc.dtype).float(), vc.float())
            o = o * alpha.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        denom = torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]
        out[:, q0:q1] = (o / denom).reshape(B, qn, H, hdv).to(v.dtype)
    return out


def _positions(cfg, B: int, S: int, offset, position_ids=None, device=None):
    """The positions a rotation takes: ``position_ids`` when given, else
    ``arange(S) + offset`` (an int, or a (B, 1) tensor) as (B, S), or as
    three equal (3, B, S) streams for ``mrope``."""
    if position_ids is not None:
        return position_ids
    pos = torch.arange(S, device=device)[None, :] + offset
    if cfg.pos == "mrope":
        return pos[None].expand(3, B, S)
    return pos.expand(B, S)


def gqa_init(gen, cfg, dtype, device, lead=()):
    """wq, wk, wv (with ``cfg.qkv_bias``), wo; ``lead`` stacks layers."""
    hd = cfg.hd
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype, device, cfg.qkv_bias, lead=lead),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv * hd, dtype, device, cfg.qkv_bias, lead=lead),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv * hd, dtype, device, cfg.qkv_bias, lead=lead),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype, device, False, lead=lead),
    }


def gqa_qkv(p, x, cfg, offset=0, position_ids=None):
    """Projections, then RoPE or M-RoPE at ``_positions`` (``offset`` an
    int or a (B, 1) tensor of per-row offsets); sinusoidal positions were
    added to the embeddings, so q and k are not rotated."""
    B, S, _ = x.shape
    hd = cfg.hd

    def heads(name, n):
        # A block of columns that splits a head (the rules shard by
        # columns) is gathered to whole heads first.
        y = dense(p[name], x)
        if y.shape[-1] % hd:
            y = repl_act(y, -1, n * hd)
        return y.reshape(B, S, -1, hd)

    q = heads("wq", cfg.n_heads)
    k = heads("wk", cfg.n_kv)
    v = heads("wv", cfg.n_kv)
    pos = _positions(cfg, B, S, offset, position_ids, x.device)
    if cfg.pos == "rope":
        q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)
    elif cfg.pos == "mrope":
        q = apply_mrope(q, pos, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, pos, cfg.mrope_sections, cfg.rope_theta)
    return q, k, v


def _kv_for_q(cfg, n_q: int, *kvs):
    """The kv heads (dim -2) of ``kvs`` that this rank's ``n_q`` q heads
    attend: all of them unless the q heads are a block of ``cfg.n_heads``
    over all kv heads (the divisibility fallback: the kv heads do not
    divide over the mesh).  Then n_kv < tp for every power-of-two tp and
    the architectures' kv head counts, so the block lies inside one kv
    group and gets that kv head, contiguous; a block across groups
    raises."""
    if n_q == cfg.n_heads or kvs[0].shape[-2] != cfg.n_kv:
        return kvs
    G = cfg.n_heads // cfg.n_kv
    h0 = shard_offset(n_q, cfg.n_heads)
    if h0 // G != (h0 + n_q - 1) // G:
        raise NotImplementedError(f"q heads {h0}..{h0 + n_q - 1} span kv groups of {G}")
    return tuple(t.narrow(-2, h0 // G, 1).contiguous() for t in kvs)


def _wo(p, o, cfg, x):
    """The output projection of the attention output o (B, S, H, hdv),
    its heads gathered first under a serving mesh (after the cast to
    x's dtype, which halves the bytes a bf16 model moves)."""
    B, S = o.shape[:2]
    o = repl_act(o.to(x.dtype), 2, cfg.n_heads)
    return dense(p["wo"], o.reshape(B, S, -1))


def gqa_apply_train(p, x, cfg, position_ids=None):
    """The forward over a whole sequence (the loss's, and the Engine's
    prefill): returns y and the (k, v) to cache."""
    q, k, v = gqa_qkv(p, x, cfg, 0, position_ids)
    o = flash_attention(q, *_kv_for_q(cfg, q.shape[2], k, v), causal=True,
                        q_chunk=cfg.attn_chunk_q, kv_chunk=cfg.attn_chunk_kv)
    return _wo(p, o, cfg, x), (k, v)


def gqa_apply_decode(p, x, cfg, cache, pos, position_ids=None):
    """cache: dict(k=(B, S_max, Hk, hd), v=...), written in place at
    ``pos`` (an int, or a (B,) tensor of per-row positions); x (B, 1, D)."""
    B = x.shape[0]
    per_row = torch.is_tensor(pos) and pos.dim() == 1
    q, k, v = gqa_qkv(p, x, cfg, pos[:, None] if per_row else pos, position_ids)
    if per_row:
        rows = torch.arange(B, device=x.device)
        cache["k"][rows, pos.long()] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos.long()] = v[:, 0].to(cache["v"].dtype)
    else:
        cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
    o = decode_attention(q, *_kv_for_q(cfg, q.shape[2], cache["k"], cache["v"]), pos)
    return _wo(p, o, cfg, x), cache


def gqa_apply_decode_paged(p, x, cfg, cache, block_table, pos):
    """Slot decode through a paged pool (written in place): the new K/V
    row goes to page ``block_table[b, pos // page]`` row ``pos % page``
    (a page the slot owns alone), then K4 attends the slot's pages
    through the block table.  ``pos`` is the (B,) int32 length vector."""
    B = x.shape[0]
    q, k, v = gqa_qkv(p, x, cfg, pos[:, None])
    page = cache["k"].shape[1]
    rows = torch.arange(B, device=x.device)
    pg = block_table[rows, torch.div(pos, page, rounding_mode="floor").long()].long()
    rw = (pos % page).long()
    cache["k"][pg, rw] = k[:, 0].to(cache["k"].dtype)
    cache["v"][pg, rw] = v[:, 0].to(cache["v"].dtype)
    o = kops.paged_decode_gqa(q, *_kv_for_q(cfg, q.shape[2], cache["k"], cache["v"]),
                              block_table, pos)
    return _wo(p, o, cfg, x), cache


def gqa_apply_prefix(p, x, cfg, cache, block_table, ctx_len, wr_pg, wr_rw,
                     use_context: bool = True):
    """Paged (burst) prefill of tail tokens over an optional reused
    prefix: queries at positions ``ctx_len[b] + t``, K5 attends the
    gathered context pages (valid where ``j < ctx_len``) and the tail
    causally, then the tail K/V goes to the slot's pages at
    ``(wr_pg, wr_rw)`` (pads to the garbage page).  The context is read
    before the write, as the reference reads the pre-write pool.
    ``use_context=False`` leaves the context out (L = 0)."""
    q, k, v = gqa_qkv(p, x, cfg, ctx_len[:, None])
    if use_context:
        with precision_island("attn"):
            k_ctx, v_ctx = _kv_for_q(cfg, q.shape[2],
                                     gather_pages(cache["k"], block_table).to(k.dtype),
                                     gather_pages(cache["v"], block_table).to(v.dtype))
    else:
        k_ctx = v_ctx = None
    o = kops.prefix_prefill(q, k_ctx, v_ctx, *_kv_for_q(cfg, q.shape[2], k, v), ctx_len)
    pg, rw = wr_pg.long(), wr_rw.long()
    cache["k"][pg, rw] = k.to(cache["k"].dtype)
    cache["v"][pg, rw] = v.to(cache["v"].dtype)
    return _wo(p, o, cfg, x), cache


# ================================= MLA =======================================
def mla_init(gen, cfg, dtype, device, lead=()):
    """q_a, q_norm, q_b, kv_a, kv_norm, kv_b, wo; ``lead`` stacks layers."""
    m = cfg.mla
    H = cfg.n_heads
    return {
        "q_a": dense_init(gen, cfg.d_model, m.q_lora_rank, dtype, device, lead=lead),
        "q_norm": norm_init(m.q_lora_rank, "rms", dtype, device, lead),
        "q_b": dense_init(gen, m.q_lora_rank, H * (m.qk_nope_dim + m.qk_rope_dim), dtype,
                          device, lead=lead),
        "kv_a": dense_init(gen, cfg.d_model, m.kv_lora_rank + m.qk_rope_dim, dtype, device,
                           lead=lead),
        "kv_norm": norm_init(m.kv_lora_rank, "rms", dtype, device, lead),
        "kv_b": dense_init(gen, m.kv_lora_rank, H * (m.qk_nope_dim + m.v_head_dim), dtype,
                           device, lead=lead),
        "wo": dense_init(gen, H * m.v_head_dim, cfg.d_model, dtype, device, lead=lead),
    }


def _mla_q(p, x, cfg, offset):
    """(q_nope, q_rope) (B, S, H, nope|rope), rope at ``arange(S) + offset``."""
    m = cfg.mla
    B, S, _ = x.shape
    cq = norm_apply(p["q_norm"], dense(p["q_a"], x), "rms")
    q = dense(p["q_b"], cq).reshape(B, S, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, _positions(cfg, B, S, offset, device=x.device),
                              cfg.rope_theta)


def _mla_ckv(p, x, cfg, offset):
    """The compressed cache rows: c_kv (B, S, r) normed, k_rope (B, S, dr)."""
    m = cfg.mla
    B, S, _ = x.shape
    a = dense(p["kv_a"], x)
    c_kv, k_rope = torch.split(a, [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c_kv = norm_apply(p["kv_norm"], c_kv, "rms")
    k_rope = apply_rope(k_rope[:, :, None, :], _positions(cfg, B, S, offset, device=x.device),
                        cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_kv(p, cfg, c_kv, k_rope):
    """Per-head K (nope ; rope) and V reconstructed through ``kv_b``."""
    m = cfg.mla
    B, S, _ = c_kv.shape
    H = cfg.n_heads
    kvb = dense(p["kv_b"], c_kv).reshape(B, S, H, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = torch.split(kvb, [m.qk_nope_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_dim)], dim=-1)
    return k, v


def mla_apply_train(p, x, cfg):
    """The forward over a whole sequence (the loss's, and the Engine's
    prefill): per-head K/V reconstructed from the compressed rows, chunked-flash
    attention over (nope ; rope) keys.  Returns y and the (c_kv, k_rope)
    to cache."""
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, cfg, 0)
    c_kv, k_rope = _mla_ckv(p, x, cfg, 0)
    k, v = _mla_kv(p, cfg, c_kv, k_rope)
    o = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=True,
                        q_chunk=cfg.attn_chunk_q, kv_chunk=cfg.attn_chunk_kv)
    return dense(p["wo"], o.reshape(B, S, -1).to(x.dtype)), (c_kv, k_rope)


def _mla_absorb_weights(p, cfg):
    """``kv_b`` split into w_uk (r, H, nope) and w_uv (r, H, v) views."""
    m = cfg.mla
    w = p["kv_b"]["w"].reshape(m.kv_lora_rank, cfg.n_heads, m.qk_nope_dim + m.v_head_dim)
    return w[:, :, :m.qk_nope_dim], w[:, :, m.qk_nope_dim:]


@in_island("attn")
def _mla_absorb_q(p, cfg, q_nope):
    """Absorb ``w_uk`` into the nope queries: the (B, q, H, r) float32
    absorbed queries, the post-sum score scale 1/sqrt(nope + rope), and
    ``w_uv`` for the caller's up-projection."""
    m = cfg.mla
    w_uk, w_uv = _mla_absorb_weights(p, cfg)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_uk.float())
    return q_abs, 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim), w_uv


def _mla_up(ctx, w_uv):
    """The context (B, q, H, r) up-projected by w_uv (r, H, v), in f32."""
    return torch.einsum("bqhr,rhd->bqhd", ctx, w_uv.float())


def mla_apply_decode(p, x, cfg, cache, pos):
    """Absorbed MLA decode against a monolithic compressed cache
    dict(c_kv=(B, S_max, r), k_rope=(B, S_max, dr)), written in place at
    ``pos`` (an int, or a (B,) tensor of per-row positions); x (B, 1, D)."""
    B = x.shape[0]
    per_row = torch.is_tensor(pos) and pos.dim() == 1
    off = pos[:, None] if per_row else pos
    q_nope, q_rope = _mla_q(p, x, cfg, off)
    c_new, kr_new = _mla_ckv(p, x, cfg, off)
    rows = torch.arange(B, device=x.device) if per_row else slice(None)
    at = pos.long() if per_row else pos
    cache["c_kv"][rows, at] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][rows, at] = kr_new[:, 0].to(cache["k_rope"].dtype)
    q_abs, scale, w_uv = _mla_absorb_q(p, cfg, q_nope)
    ctx = mla_attend_core(q_abs, q_rope, cache["c_kv"], cache["k_rope"], pos, scale)
    o = _mla_up(ctx, w_uv)
    return dense(p["wo"], o.reshape(B, 1, -1).to(x.dtype)), cache


def mla_apply_decode_paged(p, x, cfg, cache, block_table, pos):
    """Absorbed MLA decode through a paged compressed cache (pages
    (n_pages, page, r) / (n_pages, page, dr), written in place): the new
    row goes to page ``block_table[b, pos // page]`` row ``pos % page``,
    then K6 attends the slot's pages through the block table.  ``pos``
    is the (B,) int32 length vector."""
    B = x.shape[0]
    q_nope, q_rope = _mla_q(p, x, cfg, pos[:, None])
    c_new, kr_new = _mla_ckv(p, x, cfg, pos[:, None])
    page = cache["c_kv"].shape[1]
    rows = torch.arange(B, device=x.device)
    pg = block_table[rows, torch.div(pos, page, rounding_mode="floor").long()].long()
    rw = (pos % page).long()
    cache["c_kv"][pg, rw] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][pg, rw] = kr_new[:, 0].to(cache["k_rope"].dtype)
    with precision_island("attn"):
        q_abs, scale, w_uv = _mla_absorb_q(p, cfg, q_nope)
        ctx = kops.paged_decode_mla(q_abs.contiguous(), q_rope.contiguous(), cache["c_kv"],
                                    cache["k_rope"], block_table, pos, scale)
        o = _mla_up(ctx, w_uv)
    return dense(p["wo"], o.reshape(B, 1, -1).to(x.dtype)), cache


def mla_apply_prefix(p, x, cfg, cache, block_table, ctx_len, wr_pg, wr_rw,
                     use_context: bool = True):
    """Paged (burst) MLA prefill over an optional reused prefix: per-head
    K/V are reconstructed through ``kv_b`` for the gathered context pages
    and the tail together (one projection, as the reference's), then K5
    attends [context ; causal tail] (context column j valid where
    ``j < ctx_len``); the tail's compressed rows go to the slot's pages at
    ``(wr_pg, wr_rw)`` (pads to the garbage page).  The context is read
    before the write.  ``use_context=False`` leaves the context out."""
    B, T, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, cfg, ctx_len[:, None])
    c_kv, k_rope = _mla_ckv(p, x, cfg, ctx_len[:, None])
    if use_context:
        with precision_island("attn"):
            c_all = torch.cat([gather_pages(cache["c_kv"], block_table).to(c_kv.dtype), c_kv],
                              dim=1)
            kr_all = torch.cat([gather_pages(cache["k_rope"], block_table).to(k_rope.dtype),
                                k_rope], dim=1)
    else:
        c_all, kr_all = c_kv, k_rope
    L = c_all.shape[1] - T
    k, v = _mla_kv(p, cfg, c_all, kr_all)
    ctx_kv = (k[:, :L].contiguous(), v[:, :L].contiguous()) if L else (None, None)
    o = kops.prefix_prefill(torch.cat([q_nope, q_rope], dim=-1), *ctx_kv,
                            k[:, L:].contiguous(), v[:, L:].contiguous(), ctx_len)
    pg, rw = wr_pg.long(), wr_rw.long()
    cache["c_kv"][pg, rw] = c_kv.to(cache["c_kv"].dtype)
    cache["k_rope"][pg, rw] = k_rope.to(cache["k_rope"].dtype)
    return dense(p["wo"], o.reshape(B, T, -1).to(x.dtype)), cache
