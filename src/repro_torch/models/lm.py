"""LM assembly for every family of ``configs.archs`` (dense GQA, MLA,
MoE, SSM (Mamba-1), the hybrid, and the audio and VLM backbones):
Embed -> blocks -> Norm -> Head, with the training loss (``loss_fn``)
and the prefill / decode entry points of the monolithic cache and the
paged pool.

Positions: RoPE and M-RoPE rotate q and k inside attention (M-RoPE at the
batch's (3, B, S) ``position_ids`` where given, else at three equal
streams); sinusoidal positions are added to the embeddings at absolute
positions, so every entry point passes its offset to ``embed_inputs``
(the decode position, or a paged prefill's reused context length).  An
``external_embed`` backbone takes ``batch["embeds"]`` (B, S, D) in place
of tokens and has no ``embed`` table; the Scheduler serves token models
only, as the reference's does.

Parameters keep the reference's layout, so a ``repro.models.lm.init``
tree carries over through ``bridge.params_from_numpy``: ``blocks`` is a
list (one entry per position of ``cfg.scan_period()``) of dicts whose
leaves stack the layer groups on a leading axis.  The reference scans
over that axis; here a Python loop walks the groups (``torch.unbind``
gives every group's views at once).  With ``cfg.remat`` each group runs
under ``torch.utils.checkpoint`` while gradients are being recorded, as
the reference remats each scanned group.

Caches: ``init_cache`` / ``prefill`` / ``decode_step`` /
``insert_cache_slot`` for monolithic per-slot regions (the Engine), and
``init_paged_pool`` / ``prefill_paged`` / ``decode_step_paged`` for the
paged pool, where attention K/V (an MLA layer's compressed c_kv and
k_rope rows) live in shared pages named by per-slot block tables and
page 0 is the garbage page (the Scheduler).  SSM state
is O(1) in the sequence, so it stays per slot: (groups, n_slots + 1,
...) in the pool, where row ``n_slots`` is the garbage slot.  Caches and
pools are written in place and returned, as the reference returns its
donated pool.

MoE blocks run the capacity dispatch in ``forward_hidden(training=True)``
(the loss), the drop-free path everywhere else (``moe.moe_apply``).
DeepSeek-V3's depth-1 MTP head (``params["mtp"]``: proj, one block, ln)
feeds only ``loss_fn``; the serving functions ignore it.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve
from ..dist.fsdp import current_train, gather_params
from ..dist.sharding import current, local_pool, repl_act, use_mesh
from . import attention as attn
from . import mamba as ssm
from . import moe
from .common import (
    dense,
    dense_init,
    ffn_apply,
    ffn_init,
    in_island,
    last_valid_hidden,
    norm_apply,
    norm_init,
    page_write_indices,
    precision_island,
    sinusoidal_positions,
    softmax_xent_chunked,
)
from .config import DTYPES, LMConfig


def _cache_dtype(cfg: LMConfig):
    return DTYPES[cfg.cache_dtype]


# ------------------------------- init ---------------------------------------
def init(cfg: LMConfig, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Random parameters in the reference's layout and scales: dense
    weights N(0, 1/d_in), the embedding N(0, 0.02^2), norms ones, biases
    zeros, in ``cfg.param_dtype`` (the SSM's float32 leaves as
    ``mamba.mamba_init`` says, the MoE router float32); drawn by
    ``generator``, which must live on ``device``.  A block with
    ``ffn_kind == "none"`` has no ln2/ffn; an ``external_embed`` model no
    ``embed``.  With ``cfg.mtp`` the MTP head (proj (2D, D), one block of
    layer 0's kinds, ln) is drawn last, so every other leaf takes the
    same draws with the head or without it.  The draws do not reproduce
    the reference's bits."""
    cfg.validate()
    dev = resolve(device)
    dt = cfg.pdtype
    period = cfg.scan_period()
    lead = (cfg.n_layers // period,)
    blocks = [_init_block(generator, cfg, i, dev, lead) for i in range(period)]
    params: Dict[str, Any] = {"blocks": blocks, "ln_f": norm_init(cfg.d_model, cfg.norm, dt, dev)}
    if not cfg.external_embed:
        params["embed"] = dense_init(generator, cfg.vocab_size, cfg.d_model, dt, dev,
                                     scale=0.02)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dt, dev)
    if cfg.mtp:
        params["mtp"] = {
            "proj": dense_init(generator, 2 * cfg.d_model, cfg.d_model, dt, dev),
            "block": _init_block(generator, cfg, 0, dev, ()),
            "ln": norm_init(cfg.d_model, cfg.norm, dt, dev),
        }
    return params


def _init_block(generator, cfg: LMConfig, i: int, dev, lead) -> Dict[str, Any]:
    """The params of scan position ``i``'s block, layer groups stacked on
    ``lead``."""
    dt = cfg.pdtype
    mk, fk = cfg.mixer_kind(i), cfg.ffn_of(i)
    init_mixer = {"gqa": attn.gqa_init, "mla": attn.mla_init, "mamba": ssm.mamba_init}[mk]
    block = {"ln1": norm_init(cfg.d_model, cfg.norm, dt, dev, lead),
             "mixer": init_mixer(generator, cfg, dt, dev, lead)}
    if fk != "none":
        block["ln2"] = norm_init(cfg.d_model, cfg.norm, dt, dev, lead)
        block["ffn"] = (moe.moe_init(generator, cfg, dt, dev, lead) if fk == "moe" else
                        ffn_init(generator, cfg.d_model, cfg.d_ff, cfg.act, dt, dev, lead=lead))
    return block


def _unstack(tree, n: int) -> List[Any]:
    """A tree whose leaves stack n groups on axis 0 -> n trees of views."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][i] for k in subs} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _layers(params, caches, cfg: LMConfig):
    """(block params, cache views or None, mixer kind, ffn kind) for every
    layer, in order."""
    period = cfg.scan_period()
    groups = cfg.n_layers // period
    bp = [_unstack(params["blocks"][i], groups) for i in range(period)]
    cv = None if caches is None else [_unstack(caches[i], groups) for i in range(period)]
    kinds = [(cfg.mixer_kind(i), cfg.ffn_of(i)) for i in range(period)]
    return [(bp[i][g], None if cv is None else cv[i][g], *kinds[i])
            for g in range(groups) for i in range(period)]


# ------------------------------- blocks ---------------------------------------
def _apply_ffn(bp, x, cfg: LMConfig, fk: str, training: bool = False):
    """The FFN half of a block (none for ``ffn_kind == "none"``):
    returns (x + ffn(x), the MoE's aux loss or 0)."""
    if fk == "none":
        return x, 0.0
    h = norm_apply(bp["ln2"], x, cfg.norm)
    if fk == "moe":
        y, aux = moe.moe_apply(bp["ffn"], h, cfg, training=training)
        return x + y, aux
    return x + ffn_apply(bp["ffn"], h, cfg.act), 0.0


def _block_train(bp, x, cfg: LMConfig, mk: str, fk: str, position_ids=None,
                 training: bool = True, valid_len=None):
    """One block over a whole sequence: returns (x, its cacheables, the
    MoE's aux loss or 0).  ``training`` reaches the MoE (capacity
    dispatch) and the SSM (the associative scan, not K7)."""
    h = norm_apply(bp["ln1"], x, cfg.norm)
    if mk == "gqa":
        y, (k, v) = attn.gqa_apply_train(bp["mixer"], h, cfg, position_ids)
        c = {"k": k, "v": v}
    elif mk == "mla":
        y, (ckv, kr) = attn.mla_apply_train(bp["mixer"], h, cfg)
        c = {"c_kv": ckv, "k_rope": kr}
    else:
        y, c = ssm.mamba_mix(bp["mixer"], h, cfg, cfg.mamba_chunk, return_state=True,
                             training=training, valid_len=valid_len)
    x, aux = _apply_ffn(bp, x + y, cfg, fk, training)
    return x, c, aux


# ------------------------------ embedding -------------------------------------
def embed_inputs(params, batch: Dict[str, Any], cfg: LMConfig, offset=0) -> torch.Tensor:
    """(B, S, D) inputs in the compute dtype: ``batch["embeds"]`` for an
    ``external_embed`` model, else the embedding rows of
    ``batch["tokens"]``; for sinusoidal positions plus the table at
    ``arange(S) + offset`` (an int, or a (B, 1) tensor), cast to the
    compute dtype before the add, as the reference adds it."""
    if cfg.external_embed:
        x = batch["embeds"].to(cfg.cdtype)
    else:
        x = params["embed"]["w"].to(cfg.cdtype)[batch["tokens"].long()]
    if cfg.pos == "sinusoidal":
        pos = torch.arange(x.shape[1], device=x.device)[None, :] + offset
        x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    return x


@in_island("logits")
def head_logits(params, h, cfg: LMConfig) -> torch.Tensor:
    """Logits of final-normed hidden states h, in h's dtype (the
    reference's head dense does the same).  A vocab-sharded head's
    logits are gathered, so that sampling reads the same (B, S, V) on
    every rank."""
    if cfg.tie_embeddings:
        return torch.matmul(h, params["embed"]["w"].to(h.dtype).t())
    return repl_act(dense(params["head"], h), -1, cfg.vocab_size)


# ------------------------------- forward --------------------------------------
def forward_hidden(params, x, cfg: LMConfig, position_ids=None, collect_cache: bool = False,
                   training: bool = True, valid_len=None):
    """The forward of the block stack: returns (h, the per-layer
    cacheables when ``collect_cache``, else None, the sum of the MoE
    layers' aux losses) — {"k", "v"} for a GQA layer, {"c_kv", "k_rope"}
    for an MLA layer, the post-prompt {"h", "conv"} for an SSM layer.
    ``position_ids`` (M-RoPE's (3, B, S) streams) reach the GQA layers.
    ``training=True`` runs the MoE's capacity dispatch and the SSM's
    associative scan; ``training=False`` the drop-free MoE and, on CUDA
    tensors with ``cfg.ssm_impl == "pallas"``, K7.  ``valid_len`` marks
    trailing positions as right-padding for the SSM state (attention
    needs no mask: causality keeps right-pads out of every real
    position).  With ``cfg.remat``, while gradients are recorded, each
    layer group (one ``cfg.scan_period()`` of layers) runs under
    ``checkpoint``: only its input is kept, and the backward runs it
    again.  Under a sharded train step (``dist.fsdp``) ``params["blocks"]``
    holds the rank's blocks, and each group gathers its weights whole
    when it runs (``gather_params``)."""
    period = cfg.scan_period()
    layers = _layers(params, None, cfg)

    def group(x, g: int):
        caches, aux = [], 0.0
        for i, (bp, _, mk, fk) in enumerate(layers[g * period:(g + 1) * period]):
            bp = gather_params(bp, f"blocks/{i}")
            x, c, a = _block_train(bp, x, cfg, mk, fk, position_ids, training, valid_len)
            caches.append(c)
            aux = aux + a
        return x, (caches if collect_cache else None), aux

    remat = cfg.remat and torch.is_grad_enabled()
    # A sharded train step's recompute runs in the backward, on autograd's
    # thread: it gathers the group's weights again under the same context.
    train = current_train()
    ckw = {} if train is None else {
        "context_fn": lambda: (contextlib.nullcontext(), use_mesh(train))}
    caches, aux = [], 0.0
    for g in range(len(layers) // period):
        x, c, a = (checkpoint(group, x, g, use_reentrant=False, **ckw) if remat
                   else group(x, g))
        if collect_cache:
            caches.extend(c)
        aux = aux + a
    return x, (caches if collect_cache else None), aux


def loss_fn(params, batch: Dict[str, Any], cfg: LMConfig):
    """The training loss: the chunked cross-entropy of the head over the
    final-normed stack (``softmax_xent_chunked`` at ``cfg.loss_chunk``),
    plus ``aux_loss_weight`` x the MoE aux, plus for ``cfg.mtp`` (token
    models) ``mtp_weight`` x the depth-1 MTP loss: h_t joined with the
    embedding of token t+1, through ``mtp.proj``, one extra block and
    ``mtp.ln``, to the shared head predicting target t+1.  ``batch``:
    "tokens" (B, S) or "embeds" (B, S, D) with "position_ids", "targets"
    (B, S) and an optional "loss_mask" (B, S).  Returns (loss, metrics
    {"ce", "aux"[, "mtp"], "loss"}), all 0-d f32 tensors.  Under a sharded
    train step the batch is the rank's rows, the embedding is gathered
    before the stack and the final norm, head and MTP head after it, and
    the losses are the global batch's (``dist.fsdp``)."""
    if "embed" in params:
        params = {**params, "embed": gather_params(params["embed"], "embed")}
    x = embed_inputs(params, batch, cfg)
    h, _, aux = forward_hidden(params, x, cfg, batch.get("position_ids"))
    params = {**params, **{k: gather_params(params[k], k) for k in ("ln_f", "head", "mtp")
                           if k in params}}
    h = norm_apply(params["ln_f"], h, cfg.norm)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    targets, mask = batch["targets"], batch.get("loss_mask")

    def logits32(hh):
        with precision_island("logits"):
            return head_logits(params, hh, cfg).float()

    ce = softmax_xent_chunked(logits32, h, targets, mask, cfg.loss_chunk)
    metrics = {"ce": ce, "aux": aux}
    loss = ce + cfg.aux_loss_weight * aux
    if cfg.mtp and not cfg.external_embed:
        emb = params["embed"]["w"].to(h.dtype)[batch["tokens"][:, 1:].long()]
        z = dense(params["mtp"]["proj"], torch.cat([h[:, :-1], emb], dim=-1))
        z, _, _ = _block_train(params["mtp"]["block"], z, cfg, cfg.mixer_kind(0),
                               cfg.ffn_of(0))
        z = norm_apply(params["mtp"]["ln"], z, cfg.norm)
        mtp = softmax_xent_chunked(logits32, z, targets[:, 1:],
                                   None if mask is None else mask[:, 1:], cfg.loss_chunk)
        metrics["mtp"] = mtp
        loss = loss + cfg.mtp_weight * mtp
    metrics["loss"] = loss
    return loss, metrics


# ----------------------------- caches / serving --------------------------------
def _state_leaves(cfg: LMConfig, mk: str, groups: int, rows: int, seq: tuple, dev):
    """One scan position's cache leaves: K/V (groups, *seq, n_kv, hd) for
    a GQA layer, c_kv (groups, *seq, r) and k_rope (groups, *seq, dr) for
    an MLA layer, the SSM state {"h", "conv"} of ``rows`` rows for an SSM
    layer; zeros, in ``cfg.cache_dtype`` (h in float32)."""
    cdt = _cache_dtype(cfg)
    if mk == "gqa":
        shape = (groups, *seq, cfg.n_kv, cfg.hd)
        return {"k": torch.zeros(shape, dtype=cdt, device=dev),
                "v": torch.zeros(shape, dtype=cdt, device=dev)}
    if mk == "mla":
        m = cfg.mla
        return {"c_kv": torch.zeros((groups, *seq, m.kv_lora_rank), dtype=cdt, device=dev),
                "k_rope": torch.zeros((groups, *seq, m.qk_rope_dim), dtype=cdt, device=dev)}
    return ssm.mamba_cache_init(cfg, rows, _cache_dtype(cfg), dev, lead=(groups,))


def init_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda"):
    """Monolithic per-slot caches: per scan position a dict of
    (groups, batch, max_len, ...) zeros in ``cfg.cache_dtype`` (GQA K/V,
    MLA c_kv / k_rope), or the SSM state of ``batch`` rows."""
    dev = resolve(device)
    period = cfg.scan_period()
    groups = cfg.n_layers // period
    return tuple(_state_leaves(cfg, cfg.mixer_kind(i), groups, batch, (batch, max_len), dev)
                 for i in range(period))


def decode_step(params, inputs, pos, caches, cfg: LMConfig):
    """One decode step: inputs {"tokens": (B, 1)} or {"embeds": (B, 1, D)},
    with M-RoPE's {"position_ids": (3, B, 1)} where given; ``pos`` the
    current length (an int, or a (B,) tensor of per-row lengths) — the new
    token's K/V is written at ``pos``; an SSM layer's state advances one
    step.  Returns ((B, 1, V) logits, caches)."""
    per_row = torch.is_tensor(pos) and pos.dim() == 1
    x = embed_inputs(params, inputs, cfg, offset=pos[:, None] if per_row else pos)
    pos_ids = inputs.get("position_ids")
    for bp, cache, mk, fk in _layers(params, caches, cfg):
        h = norm_apply(bp["ln1"], x, cfg.norm)
        if mk == "gqa":
            y, _ = attn.gqa_apply_decode(bp["mixer"], h, cfg, cache, pos, pos_ids)
        elif mk == "mla":
            y, _ = attn.mla_apply_decode(bp["mixer"], h, cfg, cache, pos)
        else:
            y, new = ssm.mamba_step(bp["mixer"], h, cfg, cache)
            cache["h"].copy_(new["h"])
            cache["conv"].copy_(new["conv"])
        x, _ = _apply_ffn(bp, x + y, cfg, fk)
    h = norm_apply(params["ln_f"], x, cfg.norm)
    return head_logits(params, h, cfg), caches


def prefill(params, batch, cfg: LMConfig, max_len: Optional[int] = None, valid_len=None):
    """Run whole prompts (B, S); returns (caches padded to max_len, (B, 1, V)
    logits at the last real token — index ``valid_len - 1`` when the
    prompt is right-padded, else S - 1).  Cache rows past ``valid_len``
    hold pad junk that decode overwrites before the mask exposes it; an
    SSM layer's cache is its exact post-prompt state (pads are identity
    steps, see ``mamba.mamba_mix``).  ``batch`` holds "tokens" or
    "embeds", and M-RoPE's "position_ids" where given."""
    x = embed_inputs(params, batch, cfg)
    B, S = x.shape[:2]
    h, got, _ = forward_hidden(params, x, cfg, batch.get("position_ids"), collect_cache=True,
                               training=False, valid_len=valid_len)
    h = norm_apply(params["ln_f"], h, cfg.norm)
    logits = head_logits(params, last_valid_hidden(h, valid_len), cfg)
    caches = local_pool(lambda dev: init_cache(cfg, B, max_len or S, dev), x.device, current())
    for (_, cache, mk, _), c in zip(_layers(params, caches, cfg), got):
        if mk == "mamba":
            cache["h"].copy_(c["h"])
            cache["conv"].copy_(c["conv"])
        else:
            for name, leaf in cache.items():
                leaf[:, :S] = c[name].to(leaf.dtype)
    return caches, logits


def insert_cache_slot(pool, row_caches, slot: int):
    """Overwrite slot ``slot`` of a monolithic pool with a batch-of-1
    cache, in place: the WHOLE slot region is replaced (K/V rows, or the
    SSM state), so nothing of the previous occupant survives."""
    for pool_leaves, new_leaves in zip(pool, row_caches):
        for name, leaf in pool_leaves.items():
            leaf[:, slot] = new_leaves[name][:, 0].to(leaf.dtype)
    return pool


def init_paged_pool(cfg: LMConfig, n_slots: int, n_pages: int, page_size: int,
                    device="cuda"):
    """Paged pool: per scan position a dict of (groups, n_pages, page_size,
    ...) zero pages in ``cfg.cache_dtype`` (GQA K/V (.., n_kv, hd), MLA
    c_kv (.., r) / k_rope (.., dr)), or the SSM state of n_slots + 1
    rows.  Page 0 is the garbage page, never allocated: it absorbs the
    writes of inactive decode slots and of burst-prefill padding; SSM row
    ``n_slots`` is the garbage slot, which absorbs the state writes of
    burst-padding rows."""
    dev = resolve(device)
    period = cfg.scan_period()
    groups = cfg.n_layers // period
    return tuple(_state_leaves(cfg, cfg.mixer_kind(i), groups, n_slots + 1,
                               (n_pages, page_size), dev)
                 for i in range(period))


def decode_step_paged(params, inputs, pos, pool, block_tables, cfg: LMConfig):
    """One decode step over all slots through the block tables ((B, nb)
    int32): ``pos`` is the (B,) int32 per-slot length vector.  Attention
    runs K4 (GQA) or K6 (MLA) on CUDA tensors; an SSM layer advances rows
    [0, B) of its state (an inactive slot's row takes junk, which the next
    admission's prefill overwrites).  Returns ((B, 1, V) logits, pool)."""
    x = embed_inputs(params, inputs, cfg, offset=pos[:, None])
    B = x.shape[0]
    for bp, cache, mk, fk in _layers(params, pool, cfg):
        h = norm_apply(bp["ln1"], x, cfg.norm)
        if mk == "gqa":
            y, _ = attn.gqa_apply_decode_paged(bp["mixer"], h, cfg, cache, block_tables, pos)
        elif mk == "mla":
            y, _ = attn.mla_apply_decode_paged(bp["mixer"], h, cfg, cache, block_tables, pos)
        else:
            y, new = ssm.mamba_step(bp["mixer"], h, cfg,
                                    {"h": cache["h"][:B], "conv": cache["conv"][:B]})
            cache["h"][:B] = new["h"]
            cache["conv"][:B] = new["conv"]
        x, _ = _apply_ffn(bp, x + y, cfg, fk)
    h = norm_apply(params["ln_f"], x, cfg.norm)
    return head_logits(params, h, cfg), pool


def prefill_paged(params, batch, cfg: LMConfig, pool, block_tables, slots, ctx_len,
                  tail_valid, page_size: int, use_context: bool = True):
    """Batched burst prefill into the paged pool.  ``batch["tokens"]``
    (B, T) holds each admitted request's prompt tail (after its reused
    prefix) right-padded to the bucket T; per row ``ctx_len`` counts the
    reused prefix tokens, ``tail_valid`` the real tail tokens, and
    ``block_tables[b]`` names the slot's pages.  Tail token t sits at
    absolute position ``ctx_len + t`` (the rotation's, and the sinusoidal
    table's), so a chunk or a tail after a reused prefix computes what a
    whole prefill would there.  Attention runs K5 on CUDA
    tensors over [prefix pages ; causal tail] (an MLA layer over K/V
    reconstructed from its compressed pages); the tail's cache rows go to
    the slot's pages (pads to the garbage page).  An SSM layer runs the mix
    over the tail (K7 on CUDA tensors, per-row valid length
    ``tail_valid``) and writes its post-prompt state at ``slots`` (the
    garbage slot ``n_slots`` for burst padding).  Prefix reuse never
    applies to SSM layers: the Scheduler keeps ctx_len 0 for them.
    Returns (pool, (B, 1, V) logits at each row's last real token)."""
    T = batch["tokens"].shape[1]
    x = embed_inputs(params, batch, cfg, offset=ctx_len[:, None])
    wr_pg, wr_rw = page_write_indices(block_tables, ctx_len, tail_valid, T, page_size)
    rows = slots.long()
    for bp, cache, mk, fk in _layers(params, pool, cfg):
        h = norm_apply(bp["ln1"], x, cfg.norm)
        if mk != "mamba":
            apply_prefix = attn.gqa_apply_prefix if mk == "gqa" else attn.mla_apply_prefix
            y, _ = apply_prefix(bp["mixer"], h, cfg, cache, block_tables, ctx_len, wr_pg, wr_rw,
                                use_context)
        else:
            y, state = ssm.mamba_mix(bp["mixer"], h, cfg, cfg.mamba_chunk, return_state=True,
                                     training=False, valid_len=tail_valid)
            cache["h"][rows] = state["h"]
            cache["conv"][rows] = state["conv"].to(cache["conv"].dtype)
        x, _ = _apply_ffn(bp, x + y, cfg, fk)
    h = norm_apply(params["ln_f"], x, cfg.norm)
    return pool, head_logits(params, last_valid_hidden(h, tail_valid), cfg)


def pool_nbytes(pool) -> int:
    """Device footprint of a cache pool (paged or monolithic) in bytes."""
    return int(sum(leaf.numel() * leaf.element_size()
                   for leaves in pool for leaf in leaves.values()))


# ------------------------------ lint contract --------------------------------
from ..analysis.registry import Built, DonationUnit, register_contract  # noqa: E402


@register_contract(
    "lm.prefill_paged",
    checks=("donation", "transfers", "precision"),
    description="batched paged prefill at a smoke config: the pool must be written in "
                "place (no leaf replaced or copied whole), a call must run with no implicit "
                "transfer and no host sync, and the recorded program must satisfy the f32 "
                "precision policy (no f64, f32-accumulated products, widening only inside "
                "islands)",
)
def _build_prefill_paged_contract(device) -> Built:
    from ..analysis.op_trace import record
    from ..analysis.registry import PrecisionPolicy
    from ..configs import get_smoke_config

    cfg = get_smoke_config("qwen2.5-3b")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init(cfg, gen, device)
    n_slots, page_size, pages_per_slot = 2, 8, 4
    pool = init_paged_pool(cfg, n_slots, n_slots * pages_per_slot + 1, page_size, device)
    B, T = 2, 8
    tokens = torch.randint(1, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32).to(device)
    bt = (1 + torch.arange(B * pages_per_slot, dtype=torch.int32)).reshape(B, -1).to(device)
    slots = torch.arange(B, dtype=torch.int32).to(device)
    ctx_len = torch.zeros((B,), dtype=torch.int32, device=device)
    tail = torch.full((B,), T, dtype=torch.int32, device=device)

    @torch.no_grad()
    def call():
        return prefill_paged(params, {"tokens": tokens}, cfg, pool, bt, slots, ctx_len, tail,
                             page_size, False)

    call()                                  # warm
    return Built(
        donation=[DonationUnit("prefill_paged", call, lambda: pool)],
        hot=call, hot_label="prefill_paged call", sync_budget=0,
        programs=[("prefill_paged", record(call))],
        precision=PrecisionPolicy(compute_dtype=cfg.compute_dtype),
    )
