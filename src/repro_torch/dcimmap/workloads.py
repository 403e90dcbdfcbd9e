"""Per-architecture GEMM workload extraction.

Walks an LMConfig and enumerates every weight-stationary MVM the model
executes per token (QKV/O projections, dense FFN, per-expert FFN, Mamba
projections, embedding head), with its (K, N) shape, weight count, and
activation rate (MoE experts are active top_k/E of the time).  This is
the demand side the SEGA-DCIM explorer provisions macros for.

Non-MVM compute is explicitly recorded as NOT mappable to DCIM
(arch-applicability, DESIGN.md §4): attention score*V products
(activation x activation) and the Mamba selective-scan recurrence.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.models.config import LMConfig, ssm_dims


@dataclasses.dataclass
class GemmWorkload:
    name: str
    K: int                 # reduction dim
    N: int                 # output dim
    count: int             # instances (layers x experts ...)
    activation: float = 1.0  # fraction of tokens hitting each instance

    @property
    def weights(self) -> int:
        return self.K * self.N

    def macs_per_token(self) -> float:
        return self.K * self.N * self.count * self.activation


@dataclasses.dataclass
class ArchWorkload:
    arch: str
    gemms: List[GemmWorkload]
    unmappable: List[str]

    def total_weights(self) -> int:
        return sum(g.weights * g.count for g in self.gemms)

    def macs_per_token(self) -> float:
        return sum(g.macs_per_token() for g in self.gemms)


def extract(cfg: LMConfig) -> ArchWorkload:
    g: List[GemmWorkload] = []
    un: List[str] = []
    D = cfg.d_model
    hd = cfg.hd

    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.mixer_kind(i) in ("gqa", "mla"))
    n_mamba = cfg.n_layers - n_attn
    n_moe = sum(1 for i in range(cfg.n_layers) if cfg.ffn_of(i) == "moe")
    n_dense = sum(1 for i in range(cfg.n_layers) if cfg.ffn_of(i) == "dense")

    if n_attn:
        if cfg.attn_kind == "mla":
            m = cfg.mla
            g += [
                GemmWorkload("mla_q_a", D, m.q_lora_rank, n_attn),
                GemmWorkload("mla_q_b", m.q_lora_rank,
                             cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim), n_attn),
                GemmWorkload("mla_kv_a", D, m.kv_lora_rank + m.qk_rope_dim, n_attn),
                GemmWorkload("mla_kv_b", m.kv_lora_rank,
                             cfg.n_heads * (m.qk_nope_dim + m.v_head_dim), n_attn),
                GemmWorkload("attn_o", cfg.n_heads * m.v_head_dim, D, n_attn),
            ]
        else:
            g += [
                GemmWorkload("attn_q", D, cfg.n_heads * hd, n_attn),
                GemmWorkload("attn_k", D, cfg.n_kv * hd, n_attn),
                GemmWorkload("attn_v", D, cfg.n_kv * hd, n_attn),
                GemmWorkload("attn_o", cfg.n_heads * hd, D, n_attn),
            ]
        un.append("attention score x value products (activation-dynamic)")

    if n_mamba:
        d_inner, dt_rank = ssm_dims(cfg)
        s = cfg.ssm
        g += [
            GemmWorkload("mamba_in", D, 2 * d_inner, n_mamba),
            GemmWorkload("mamba_x_proj", d_inner, dt_rank + 2 * s.d_state, n_mamba),
            GemmWorkload("mamba_dt", dt_rank, d_inner, n_mamba),
            GemmWorkload("mamba_out", d_inner, D, n_mamba),
        ]
        un.append("mamba selective-scan recurrence (stateful, non-MVM)")

    if n_dense:
        mult = 3 if cfg.act == "swiglu" else 2
        if cfg.act == "swiglu":
            g += [
                GemmWorkload("ffn_gate", D, cfg.d_ff, n_dense),
                GemmWorkload("ffn_up", D, cfg.d_ff, n_dense),
                GemmWorkload("ffn_down", cfg.d_ff, D, n_dense),
            ]
        else:
            g += [
                GemmWorkload("ffn_up", D, cfg.d_ff, n_dense),
                GemmWorkload("ffn_down", cfg.d_ff, D, n_dense),
            ]
        del mult

    if n_moe:
        m = cfg.moe
        act = m.top_k / m.n_experts
        g += [
            GemmWorkload("moe_gate", D, m.d_ff, n_moe * m.n_experts, act),
            GemmWorkload("moe_up", D, m.d_ff, n_moe * m.n_experts, act),
            GemmWorkload("moe_down", m.d_ff, D, n_moe * m.n_experts, act),
        ]
        if m.n_shared:
            g += [
                GemmWorkload("moe_shared_gate", D, m.d_ff * m.n_shared, n_moe),
                GemmWorkload("moe_shared_up", D, m.d_ff * m.n_shared, n_moe),
                GemmWorkload("moe_shared_down", m.d_ff * m.n_shared, D, n_moe),
            ]
        g += [GemmWorkload("moe_router", D, m.n_experts, n_moe)]

    g += [GemmWorkload("lm_head", D, cfg.vocab_size, 1)]
    if not cfg.external_embed and not cfg.tie_embeddings:
        un.append("embedding lookup (gather, not MVM)")

    return ArchWorkload(arch=cfg.name, gemms=g, unmappable=un)
