"""LMConfig: one config dataclass covering all 10 assigned architectures
(dense / GQA / MLA / MoE / SSM / hybrid / external-embed backbones).

The sub-configs (``MLAConfig``, ``SSMConfig``, ``MoEConfig``) and
``ssm_dims`` live here as plain dataclasses/functions (the reference
keeps them beside its model modules), so the model modules and the
provisioning path (``dcimmap.extract``) import them from one place."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 -> d_model / 16


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden dim
    n_shared: int = 0            # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    group_size: int = 256        # tokens per dispatch group


def ssm_dims(cfg):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or max(cfg.d_model // 16, 1)
    return d_inner, dt_rank


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # positions / norms / activations
    qkv_bias: bool = False
    pos: str = "rope"                 # rope | mrope | sinusoidal
    rope_theta: float = 1_000_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    norm: str = "rms"                 # rms | ln
    act: str = "swiglu"               # swiglu | gelu

    # mixer structure
    attn_kind: str = "gqa"            # gqa | mla
    mixer: str = "attn"               # attn | mamba | hybrid
    hybrid_period: int = 8            # jamba: 1 attn : 7 mamba
    hybrid_attn_index: int = 4        # position of the attn layer in a period
    ffn_kind: str = "dense"           # dense | moe | none
    moe_every: int = 1                # MoE on layers i with i % moe_every == moe_offset
    moe_offset: int = 0

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    tie_embeddings: bool = False
    external_embed: bool = False      # vlm/audio stub: inputs are embeddings
    mtp: bool = False                 # DeepSeek multi-token prediction head
    mtp_weight: float = 0.3
    aux_loss_weight: float = 0.001

    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 512
    mamba_chunk: int = 128
    loss_chunk: int = 0               # 0: unchunked CE
    ssm_impl: str = "assoc"           # assoc | pallas (fused kernel, fwd-only)
    cache_dtype: str = "bfloat16"
    # Paged-attention implementation name, carried over from the reference
    # configs; the port's serving slice decides what it selects.
    attn_backend: str = "auto"

    @property
    def pdtype(self):
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return DTYPES[self.compute_dtype]

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    # --- per-layer kinds ------------------------------------------------------
    def mixer_kind(self, i: int) -> str:
        if self.mixer == "attn":
            return "mla" if self.attn_kind == "mla" else "gqa"
        if self.mixer == "mamba":
            return "mamba"
        if i % self.hybrid_period == self.hybrid_attn_index:
            return "mla" if self.attn_kind == "mla" else "gqa"
        return "mamba"

    def ffn_of(self, i: int) -> str:
        if self.ffn_kind == "none":
            return "none"
        if self.ffn_kind == "moe" and (i % self.moe_every == self.moe_offset):
            return "moe"
        return "dense"

    def layer_kinds(self):
        return [(self.mixer_kind(i), self.ffn_of(i)) for i in range(self.n_layers)]

    def scan_period(self) -> int:
        """Smallest period p such that layer kinds repeat with period p and
        p divides n_layers."""
        kinds = self.layer_kinds()
        for p in range(1, self.n_layers + 1):
            if self.n_layers % p:
                continue
            if all(kinds[i] == kinds[i % p] for i in range(self.n_layers)):
                return p
        return self.n_layers  # pragma: no cover

    def validate(self):
        assert self.d_model % self.n_heads == 0 or self.head_dim, self.name
        assert self.n_heads % max(self.n_kv, 1) == 0, "GQA group must divide"
        if self.mixer in ("mamba", "hybrid"):
            assert self.ssm is not None, "ssm config required"
        if self.ffn_kind == "moe":
            assert self.moe is not None
        if self.attn_kind == "mla":
            assert self.mla is not None
        if self.pos == "mrope":
            assert sum(self.mrope_sections) == self.hd // 2
        assert self.attn_backend in ("auto", "xla", "pallas", "pallas_interpret"), (
            self.attn_backend
        )
        return self
