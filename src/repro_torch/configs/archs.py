"""The 10 assigned architectures, exactly as specified in the assignment
brief (sources noted inline).  Each entry has a full production config
and a reduced same-family smoke config (small layers/width/experts) that
runs one forward/train step on CPU.
"""
from __future__ import annotations

from repro_torch.models.config import LMConfig, MLAConfig, MoEConfig, SSMConfig

from .base import PROD, ArchEntry, register


# --- qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191] -----
def qwen2_vl_72b(**ov) -> LMConfig:
    kw = dict(
        name="qwen2-vl-72b",
        n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=29568,
        vocab_size=152064, head_dim=128, qkv_bias=True,
        pos="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
        external_embed=True,        # patch/text embeds from the stub frontend
        **PROD,
    )
    kw.update(ov)
    return LMConfig(**kw).validate()


def qwen2_vl_72b_smoke() -> LMConfig:
    return qwen2_vl_72b(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, head_dim=16,
        vocab_size=512, mrope_sections=(4, 2, 2),
        param_dtype="float32", compute_dtype="float32", remat=False,
        attn_chunk_q=8, attn_chunk_kv=8, loss_chunk=0,
    )


# --- musicgen-large [audio] — decoder-only over EnCodec tokens [2306.05284] --
def musicgen_large(**ov) -> LMConfig:
    kw = dict(
        name="musicgen-large",
        n_layers=48, d_model=2048, n_heads=32, n_kv=32, d_ff=8192,
        vocab_size=2048, pos="sinusoidal", norm="ln", act="gelu",
        **PROD,
    )
    kw.update(ov)
    return LMConfig(**kw).validate()


def musicgen_large_smoke() -> LMConfig:
    return musicgen_large(
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab_size=256,
        param_dtype="float32", compute_dtype="float32", remat=False,
        attn_chunk_q=8, attn_chunk_kv=8, loss_chunk=0,
    )


# --- moonshot-v1-16b-a3b [moe] — 64e top-6 [hf:moonshotai/Moonlight-16B-A3B] --
def moonshot_v1_16b(**ov) -> LMConfig:
    kw = dict(
        name="moonshot-v1-16b-a3b",
        n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_ff=1408,
        vocab_size=163840, head_dim=128,
        ffn_kind="moe",
        moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, group_size=256),
        **PROD,
    )
    kw.update(ov)
    return LMConfig(**kw).validate()


def moonshot_v1_16b_smoke() -> LMConfig:
    return moonshot_v1_16b(
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=64, head_dim=16,
        vocab_size=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, group_size=16),
        param_dtype="float32", compute_dtype="float32", remat=False,
        attn_chunk_q=8, attn_chunk_kv=8, loss_chunk=0,
    )


# --- deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP [2412.19437]
def deepseek_v3_671b(**ov) -> LMConfig:
    kw = dict(
        name="deepseek-v3-671b",
        n_layers=61, d_model=7168, n_heads=128, n_kv=128, d_ff=2048,
        vocab_size=129280,
        attn_kind="mla",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        ffn_kind="moe",
        moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1,
                      group_size=256),
        mtp=True,
        **PROD,
    )
    kw.update(ov)
    return LMConfig(**kw).validate()


def deepseek_v3_671b_smoke() -> LMConfig:
    return deepseek_v3_671b(
        n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=64, vocab_size=512,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, n_shared=1, group_size=16),
        param_dtype="float32", compute_dtype="float32", remat=False,
        attn_chunk_q=8, attn_chunk_kv=8, loss_chunk=0,
    )


# --- falcon-mamba-7b [ssm] — mamba1, attn-free [arXiv:2410.05355] -------------
def falcon_mamba_7b(**ov) -> LMConfig:
    kw = dict(
        name="falcon-mamba-7b",
        n_layers=64, d_model=4096, n_heads=1, n_kv=1, d_ff=0,
        vocab_size=65024,
        mixer="mamba", ffn_kind="none",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
        ssm_impl="pallas",   # adopted after §Perf I5 (serving path only)
        **PROD,
    )
    kw.update(ov)
    return LMConfig(**kw).validate()


def falcon_mamba_7b_smoke() -> LMConfig:
    return falcon_mamba_7b(
        n_layers=2, d_model=64, vocab_size=256,
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, dt_rank=8),
        param_dtype="float32", compute_dtype="float32", remat=False,
        mamba_chunk=8, loss_chunk=0,
    )


# --- phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905] ---------------
def phi4_mini_3p8b(**ov) -> LMConfig:
    kw = dict(
        name="phi4-mini-3.8b",
        n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_ff=8192,
        vocab_size=200064, head_dim=128, tie_embeddings=True,
        **PROD,
    )
    kw.update(ov)
    return LMConfig(**kw).validate()


def phi4_mini_3p8b_smoke() -> LMConfig:
    return phi4_mini_3p8b(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, head_dim=16,
        vocab_size=512,
        param_dtype="float32", compute_dtype="float32", remat=False,
        attn_chunk_q=8, attn_chunk_kv=8, loss_chunk=0,
    )


# --- qwen2.5-14b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5] ---------------------
def qwen2p5_14b(**ov) -> LMConfig:
    kw = dict(
        name="qwen2.5-14b",
        n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=13824,
        vocab_size=152064, head_dim=128, qkv_bias=True,
        **PROD,
    )
    kw.update(ov)
    return LMConfig(**kw).validate()


def qwen2p5_14b_smoke() -> LMConfig:
    return qwen2p5_14b(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, head_dim=16,
        vocab_size=512,
        param_dtype="float32", compute_dtype="float32", remat=False,
        attn_chunk_q=8, attn_chunk_kv=8, loss_chunk=0,
    )


# --- qwen2.5-3b [dense] --------------------------------------------------------
def qwen2p5_3b(**ov) -> LMConfig:
    kw = dict(
        name="qwen2.5-3b",
        n_layers=36, d_model=2048, n_heads=16, n_kv=2, d_ff=11008,
        vocab_size=151936, head_dim=128, qkv_bias=True,
        **PROD,
    )
    kw.update(ov)
    return LMConfig(**kw).validate()


def qwen2p5_3b_smoke() -> LMConfig:
    return qwen2p5_3b(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, head_dim=16,
        vocab_size=512,
        param_dtype="float32", compute_dtype="float32", remat=False,
        attn_chunk_q=8, attn_chunk_kv=8, loss_chunk=0,
    )


# --- mistral-nemo-12b [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407] --
def mistral_nemo_12b(**ov) -> LMConfig:
    kw = dict(
        name="mistral-nemo-12b",
        n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=14336,
        vocab_size=131072, head_dim=128,
        **PROD,
    )
    kw.update(ov)
    return LMConfig(**kw).validate()


def mistral_nemo_12b_smoke() -> LMConfig:
    return mistral_nemo_12b(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, head_dim=16,
        vocab_size=512,
        param_dtype="float32", compute_dtype="float32", remat=False,
        attn_chunk_q=8, attn_chunk_kv=8, loss_chunk=0,
    )


# --- jamba-v0.1-52b [hybrid] — Mamba+attn 1:7, MoE 16e top-2 [arXiv:2403.19887] -
def jamba_v0p1_52b(**ov) -> LMConfig:
    kw = dict(
        name="jamba-v0.1-52b",
        n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
        vocab_size=65536, head_dim=128,
        mixer="hybrid", hybrid_period=8, hybrid_attn_index=4,
        ffn_kind="moe", moe_every=2, moe_offset=1,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, group_size=256),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
        ssm_impl="pallas",   # adopted after §Perf I5 (serving path only)
        **PROD,
    )
    kw.update(ov)
    return LMConfig(**kw).validate()


def jamba_v0p1_52b_smoke() -> LMConfig:
    return jamba_v0p1_52b(
        n_layers=8, d_model=64, n_heads=4, n_kv=2, d_ff=128, head_dim=16,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=64, group_size=16),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, dt_rank=8),
        param_dtype="float32", compute_dtype="float32", remat=False,
        attn_chunk_q=8, attn_chunk_kv=8, mamba_chunk=8, loss_chunk=0,
    )


ENTRIES = [
    ArchEntry("qwen2-vl-72b", "vlm", qwen2_vl_72b, qwen2_vl_72b_smoke),
    ArchEntry("musicgen-large", "audio", musicgen_large, musicgen_large_smoke),
    ArchEntry("moonshot-v1-16b-a3b", "moe", moonshot_v1_16b, moonshot_v1_16b_smoke),
    ArchEntry("deepseek-v3-671b", "moe", deepseek_v3_671b, deepseek_v3_671b_smoke),
    ArchEntry("falcon-mamba-7b", "ssm", falcon_mamba_7b, falcon_mamba_7b_smoke,
              sub_quadratic=True),
    ArchEntry("phi4-mini-3.8b", "dense", phi4_mini_3p8b, phi4_mini_3p8b_smoke),
    ArchEntry("qwen2.5-14b", "dense", qwen2p5_14b, qwen2p5_14b_smoke),
    ArchEntry("qwen2.5-3b", "dense", qwen2p5_3b, qwen2p5_3b_smoke),
    ArchEntry("mistral-nemo-12b", "dense", mistral_nemo_12b, mistral_nemo_12b_smoke),
    ArchEntry("jamba-v0.1-52b", "hybrid", jamba_v0p1_52b, jamba_v0p1_52b_smoke,
              sub_quadratic=True),
]

for e in ENTRIES:
    register(e)
