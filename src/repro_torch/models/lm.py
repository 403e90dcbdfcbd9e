"""LM assembly for the dense-GQA family: Embed -> blocks -> Norm -> Head,
with the prefill / decode entry points of the monolithic cache and the
paged pool.

Parameters keep the reference's layout, so a ``repro.models.lm.init``
tree carries over through ``bridge.params_from_numpy``: ``blocks`` is a
list (one entry per position of ``cfg.scan_period()``) of dicts whose
leaves stack the layer groups on a leading axis.  The reference scans
over that axis; here a Python loop walks the groups (``torch.unbind``
gives every group's views at once).

Caches: ``init_cache`` / ``prefill`` / ``decode_step`` /
``insert_cache_slot`` for monolithic per-slot regions (the Engine), and
``init_paged_pool`` / ``prefill_paged`` / ``decode_step_paged`` for the
paged pool, where attention K/V live in shared pages named by per-slot
block tables and page 0 is the garbage page (the Scheduler).  Caches and
pools are written in place and returned, as the reference returns its
donated pool.

The MLA, MoE, SSM, sinusoidal/mrope and external-embedding branches
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..device import resolve
from . import attention as attn
from .common import (
    dense,
    dense_init,
    ffn_apply,
    ffn_init,
    last_valid_hidden,
    norm_apply,
    norm_init,
    page_write_indices,
)
from .config import DTYPES, LMConfig


def check_supported(cfg: LMConfig) -> None:
    """Raise for the parts of the LM family this port does not run yet."""
    period = cfg.scan_period()
    for i in range(period):
        mk, fk = cfg.mixer_kind(i), cfg.ffn_of(i)
        if mk == "mla":
            raise NotImplementedError(f"{cfg.name}: MLA waits for ROADMAP §1 item 11.2 (K6)")
        if mk == "mamba":
            raise NotImplementedError(
                f"{cfg.name}: SSM layers wait for ROADMAP §1 item 11.4 (K7)")
        if fk == "moe":
            raise NotImplementedError(f"{cfg.name}: MoE waits for ROADMAP §1 item 11.3")
    if cfg.pos != "rope" or cfg.external_embed:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.pos} positions / external embeddings wait for "
            f"ROADMAP §1 item 11.5")
    if cfg.mtp:
        raise NotImplementedError(f"{cfg.name}: the MTP head waits for training (item 13)")


def _cache_dtype(cfg: LMConfig):
    return DTYPES[cfg.cache_dtype]


# ------------------------------- init ---------------------------------------
def init(cfg: LMConfig, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Random parameters in the reference's layout and scales: dense
    weights N(0, 1/d_in), the embedding N(0, 0.02^2), norms ones, biases
    zeros, in ``cfg.param_dtype``; drawn by ``generator``, which must live
    on ``device``.  The draws do not reproduce the reference's bits."""
    cfg.validate()
    check_supported(cfg)
    dev = resolve(device)
    dt = cfg.pdtype
    period = cfg.scan_period()
    lead = (cfg.n_layers // period,)
    blocks = []
    for _ in range(period):
        blocks.append({
            "ln1": norm_init(cfg.d_model, cfg.norm, dt, dev, lead),
            "mixer": attn.gqa_init(generator, cfg, dt, dev, lead),
            "ln2": norm_init(cfg.d_model, cfg.norm, dt, dev, lead),
            "ffn": ffn_init(generator, cfg.d_model, cfg.d_ff, cfg.act, dt, dev, lead=lead),
        })
    params: Dict[str, Any] = {"blocks": blocks, "ln_f": norm_init(cfg.d_model, cfg.norm, dt, dev)}
    params["embed"] = dense_init(generator, cfg.vocab_size, cfg.d_model, dt, dev, scale=0.02)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dt, dev)
    return params


def _unstack(tree, n: int) -> List[Any]:
    """A tree whose leaves stack n groups on axis 0 -> n trees of views."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][i] for k in subs} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _layers(params, caches, cfg: LMConfig):
    """(block params, cache views or None) for every layer, in order."""
    period = cfg.scan_period()
    groups = cfg.n_layers // period
    bp = [_unstack(params["blocks"][i], groups) for i in range(period)]
    cv = None if caches is None else [_unstack(caches[i], groups) for i in range(period)]
    return [(bp[i][g], None if cv is None else cv[i][g])
            for g in range(groups) for i in range(period)]


# ------------------------------- blocks ---------------------------------------
def _apply_ffn(bp, x, cfg: LMConfig):
    return x + ffn_apply(bp["ffn"], norm_apply(bp["ln2"], x, cfg.norm), cfg.act)


# ------------------------------ embedding -------------------------------------
def embed_inputs(params, batch: Dict[str, Any], cfg: LMConfig) -> torch.Tensor:
    w = params["embed"]["w"]
    return w.to(cfg.cdtype)[batch["tokens"].long()]


def _head_logits(params, h, cfg: LMConfig) -> torch.Tensor:
    """Logits in h's dtype (the reference's head dense does the same)."""
    if cfg.tie_embeddings:
        return torch.matmul(h, params["embed"]["w"].to(h.dtype).t())
    return dense(params["head"], h)


# ------------------------------- forward --------------------------------------
def forward_hidden(params, x, cfg: LMConfig, collect_cache: bool = False):
    """The eval forward of the block stack: returns (h, per-layer (k, v)
    when ``collect_cache``, else None)."""
    kv = []
    for bp, _ in _layers(params, None, cfg):
        y, c = attn.gqa_apply_train(bp["mixer"], norm_apply(bp["ln1"], x, cfg.norm), cfg)
        x = _apply_ffn(bp, x + y, cfg)
        if collect_cache:
            kv.append(c)
    return x, (kv if collect_cache else None)


# ----------------------------- caches / serving --------------------------------
def init_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda"):
    """Monolithic per-slot caches: per scan position a dict of
    (groups, batch, max_len, n_kv, hd) zeros in ``cfg.cache_dtype``."""
    check_supported(cfg)
    dev = resolve(device)
    period = cfg.scan_period()
    shape = (cfg.n_layers // period, batch, max_len, cfg.n_kv, cfg.hd)
    return tuple({"k": torch.zeros(shape, dtype=_cache_dtype(cfg), device=dev),
                  "v": torch.zeros(shape, dtype=_cache_dtype(cfg), device=dev)}
                 for _ in range(period))


def decode_step(params, inputs, pos, caches, cfg: LMConfig):
    """One decode step: inputs {"tokens": (B, 1)}; ``pos`` the current
    length (an int, or a (B,) tensor of per-row lengths) — the new token's
    K/V is written at ``pos``.  Returns ((B, 1, V) logits, caches)."""
    x = embed_inputs(params, inputs, cfg)
    for bp, cache in _layers(params, caches, cfg):
        y, _ = attn.gqa_apply_decode(bp["mixer"], norm_apply(bp["ln1"], x, cfg.norm), cfg,
                                     cache, pos)
        x = _apply_ffn(bp, x + y, cfg)
    h = norm_apply(params["ln_f"], x, cfg.norm)
    return _head_logits(params, h, cfg), caches


def prefill(params, batch, cfg: LMConfig, max_len: Optional[int] = None, valid_len=None):
    """Run whole prompts (B, S); returns (caches padded to max_len, (B, 1, V)
    logits at the last real token — index ``valid_len - 1`` when the
    prompt is right-padded, else S - 1).  Cache rows past ``valid_len``
    hold pad junk that decode overwrites before the mask exposes it."""
    x = embed_inputs(params, batch, cfg)
    B, S = x.shape[:2]
    h, kv = forward_hidden(params, x, cfg, collect_cache=True)
    h = norm_apply(params["ln_f"], h, cfg.norm)
    logits = _head_logits(params, last_valid_hidden(h, valid_len), cfg)
    caches = init_cache(cfg, B, max_len or S, x.device)
    for (_, cache), (k, v) in zip(_layers(params, caches, cfg), kv):
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    return caches, logits


def insert_cache_slot(pool, row_caches, slot: int):
    """Overwrite slot ``slot`` of a monolithic pool with a batch-of-1
    cache, in place: the WHOLE slot region is replaced, so nothing of the
    previous occupant survives."""
    for pool_leaves, new_leaves in zip(pool, row_caches):
        for name, leaf in pool_leaves.items():
            leaf[:, slot] = new_leaves[name][:, 0].to(leaf.dtype)
    return pool


def init_paged_pool(cfg: LMConfig, n_slots: int, n_pages: int, page_size: int,
                    device="cuda"):
    """Paged pool: per scan position a dict of (groups, n_pages, page_size,
    n_kv, hd) zero pages in ``cfg.cache_dtype``.  Page 0 is the garbage
    page, never allocated: it absorbs the writes of inactive decode slots
    and of burst-prefill padding.  (``n_slots`` sizes the reference's
    per-slot SSM state, which this family does not have.)"""
    check_supported(cfg)
    dev = resolve(device)
    period = cfg.scan_period()
    shape = (cfg.n_layers // period, n_pages, page_size, cfg.n_kv, cfg.hd)
    return tuple({"k": torch.zeros(shape, dtype=_cache_dtype(cfg), device=dev),
                  "v": torch.zeros(shape, dtype=_cache_dtype(cfg), device=dev)}
                 for _ in range(period))


def decode_step_paged(params, inputs, pos, pool, block_tables, cfg: LMConfig):
    """One decode step over all slots through the block tables ((B, nb)
    int32): ``pos`` is the (B,) int32 per-slot length vector.  Attention
    runs K4 on CUDA tensors.  Returns ((B, 1, V) logits, pool)."""
    x = embed_inputs(params, inputs, cfg)
    for bp, cache in _layers(params, pool, cfg):
        y, _ = attn.gqa_apply_decode_paged(
            bp["mixer"], norm_apply(bp["ln1"], x, cfg.norm), cfg, cache, block_tables, pos)
        x = _apply_ffn(bp, x + y, cfg)
    h = norm_apply(params["ln_f"], x, cfg.norm)
    return _head_logits(params, h, cfg), pool


def prefill_paged(params, batch, cfg: LMConfig, pool, block_tables, slots, ctx_len,
                  tail_valid, page_size: int, use_context: bool = True):
    """Batched burst prefill into the paged pool.  ``batch["tokens"]``
    (B, T) holds each admitted request's prompt tail (after its reused
    prefix) right-padded to the bucket T; per row ``ctx_len`` counts the
    reused prefix tokens, ``tail_valid`` the real tail tokens, and
    ``block_tables[b]`` names the slot's pages.  Attention runs K5 on CUDA
    tensors over [prefix pages ; causal tail]; the tail K/V goes to the
    slot's pages (pads to the garbage page).  ``slots`` places the
    reference's per-slot SSM state, which this family does not have.
    Returns (pool, (B, 1, V) logits at each row's last real token)."""
    tokens = batch["tokens"]
    T = tokens.shape[1]
    x = embed_inputs(params, batch, cfg)
    wr_pg, wr_rw = page_write_indices(block_tables, ctx_len, tail_valid, T, page_size)
    for bp, cache in _layers(params, pool, cfg):
        y, _ = attn.gqa_apply_prefix(
            bp["mixer"], norm_apply(bp["ln1"], x, cfg.norm), cfg, cache, block_tables,
            ctx_len, wr_pg, wr_rw, use_context)
        x = _apply_ffn(bp, x + y, cfg)
    h = norm_apply(params["ln_f"], x, cfg.norm)
    return pool, _head_logits(params, last_valid_hidden(h, tail_valid), cfg)


def pool_nbytes(pool) -> int:
    """Device footprint of a cache pool (paged or monolithic) in bytes."""
    return int(sum(leaf.numel() * leaf.element_size()
                   for leaves in pool for leaf in leaves.values()))
