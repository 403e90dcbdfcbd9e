"""The plain references compute the published models: at small widths
they give the logits of ``transformers``' own ``Qwen2ForCausalLM`` (at
the published norm eps) and ``FalconMambaForCausalLM`` (RMS norms on dt,
B and C inside the mixer, a float32 residual) from the same weights.
Skips where ``transformers`` is not installed."""
import json
import os

import pytest
import torch

from conftest import DATA, ROOT
from harness import spec, weights
from reference import mamba1, qwen2


def _transformers():
    for var in ("USE_TF", "USE_FLAX", "USE_JAX"):
        os.environ.setdefault(var, "0")
    return pytest.importorskip("transformers")


def _draw(config, seed):
    return {k: v.float() for k, v in weights.by_path(
        weights.draw(spec.program_config(config), seed, "cpu")).items()}


def _hf_qwen2(w, P):
    tf = _transformers()
    hf = tf.Qwen2Config(
        vocab_size=w["vocab"], hidden_size=w["d_model"], intermediate_size=w["d_ff"],
        num_hidden_layers=w["layers"], num_attention_heads=w["heads"],
        num_key_value_heads=w["kv_heads"], rms_norm_eps=w["eps"], rope_theta=w["rope_theta"],
        tie_word_embeddings=w["tied"], use_sliding_window=False, use_cache=False,
        attn_implementation="eager")
    model = tf.Qwen2ForCausalLM(hf).float().eval()
    a, f = "blocks/0/mixer/", "blocks/0/ffn/"
    with torch.no_grad():
        model.model.embed_tokens.weight.copy_(P["embed/w"])
        model.model.norm.weight.copy_(P["ln_f/scale"])
        for l, layer in enumerate(model.model.layers):
            at, mlp = layer.self_attn, layer.mlp
            layer.input_layernorm.weight.copy_(P["blocks/0/ln1/scale"][l])
            layer.post_attention_layernorm.weight.copy_(P["blocks/0/ln2/scale"][l])
            for name, mod in (("wq", at.q_proj), ("wk", at.k_proj), ("wv", at.v_proj)):
                mod.weight.copy_(P[a + name + "/w"][l].t())
                mod.bias.copy_(P[a + name + "/b"][l])
            at.o_proj.weight.copy_(P[a + "wo/w"][l].t())
            mlp.gate_proj.weight.copy_(P[f + "w_gate/w"][l].t())
            mlp.up_proj.weight.copy_(P[f + "w_up/w"][l].t())
            mlp.down_proj.weight.copy_(P[f + "w_down/w"][l].t())
    return model


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 9])
def test_qwen2_reference_is_published_qwen2(seed):
    published = json.loads((ROOT / "perfbench/configs/qwen2.5-3b.json").read_text())
    small = json.loads((DATA / "qwen-small.json").read_text())
    config = {**small, "rms_norm_eps": published["rms_norm_eps"]}
    w = spec.widths(config)
    P = _draw(config, seed)
    model = _hf_qwen2(w, P)
    S = 40
    toks = torch.randint(0, w["vocab"], (S,), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        want = model(toks[None]).logits[0]
    got = qwen2.logits_at(P, w, toks, range(S))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()
    # At the port's eps of 1e-5 it is measurably another model.
    port_eps = qwen2.logits_at(P, {**w, "eps": 1e-5}, toks, range(S))
    assert (port_eps - want).abs().max() > 10 * (got - want).abs().max()


def _hf_falcon_mamba(config, w, P):
    tf = _transformers()
    hf = tf.FalconMambaConfig(
        vocab_size=w["vocab"], hidden_size=w["d_model"], state_size=w["d_state"],
        num_hidden_layers=w["layers"], layer_norm_epsilon=w["eps"], expand=2,
        conv_kernel=w["d_conv"], use_bias=False, use_conv_bias=True,
        time_step_rank=w["dt_rank"], residual_in_fp32=config["residual_in_fp32"],
        mixer_rms_eps=config["mixer_rms_eps"], tie_word_embeddings=False, use_cache=False)
    model = tf.FalconMambaForCausalLM(hf).float().eval()
    m = "blocks/0/mixer/"
    with torch.no_grad():
        model.backbone.embeddings.weight.copy_(P["embed/w"])
        model.backbone.norm_f.weight.copy_(P["ln_f/scale"])
        model.lm_head.weight.copy_(P["head/w"].t())
        for l, layer in enumerate(model.backbone.layers):
            mx = layer.mixer
            layer.norm.weight.copy_(P["blocks/0/ln1/scale"][l])
            mx.in_proj.weight.copy_(P[m + "in_proj/w"][l].t())
            mx.conv1d.weight.copy_(P[m + "conv_w"][l][:, None, :])
            mx.conv1d.bias.copy_(P[m + "conv_b"][l])
            mx.x_proj.weight.copy_(P[m + "x_proj/w"][l].t())
            mx.dt_proj.weight.copy_(P[m + "dt_proj/w"][l].t())
            mx.dt_proj.bias.copy_(P[m + "dt_bias"][l])
            mx.A_log.copy_(P[m + "A_log"][l])
            mx.D.copy_(P[m + "D"][l])
            mx.out_proj.weight.copy_(P[m + "out_proj/w"][l].t())
    return model


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 9])
def test_mamba1_reference_is_published_falcon_mamba(seed):
    config = json.loads((DATA / "mamba-small.json").read_text())
    w = spec.widths(config)
    P = _draw(config, seed)
    model = _hf_falcon_mamba(config, w, P)
    S = 40
    toks = torch.randint(0, w["vocab"], (S,), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        want = model(toks[None]).logits[0]
    got = mamba1.logits_at(P, w, toks, range(S))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()
    # Without the mixer's norms the reference is another model.
    plain = mamba1.logits_at(P, {**w, "mixer_eps": None}, toks, range(S))
    assert (plain - want).abs().max() > 100 * (got - want).abs().max()
