"""Plain float32 Qwen2 decoder: the reference of the qwen2.5-3b cells.

Independent of the program: plain ``torch`` operations in float32 (the
harness turns TF32 off), no kernel, no cache, no batching of requests.
It follows the Qwen2 architecture (pre-norm RMSNorm blocks; GQA with
biases on q, k and v and rotary positions on the two halves of each
head; SwiGLU; a final RMSNorm; the head tied to the embedding when the
configuration says so) at the widths and eps of the configuration file.
It reads the weights the benchmark drew, in the program's layout (the
same tensors both sides got: leaves stacked over layers), and computes
in float32 from them.

``logits_at`` teacher-forces one sequence and returns the logits at the
rows asked for; ``loss`` is the training loss (mean next-token cross
entropy), each layer under ``checkpoint`` so that float32 activations of
a whole batch fit beside the optimizer state.  ``linear`` is the product
of every weight: ``lowp.exact_linear``, or ``lowp.fp8_linear`` for the
control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .lowp import exact_linear

Q_BLOCK = 1024


def widths(config: dict) -> Dict[str, object]:
    return {"kind": "gqa", "layers": config["num_hidden_layers"],
            "d_model": config["hidden_size"], "heads": config["num_attention_heads"],
            "kv_heads": config["num_key_value_heads"], "head_dim": config["head_dim"],
            "d_ff": config["intermediate_size"], "vocab": config["vocab_size"],
            "rope_theta": config["rope_theta"], "eps": config["rms_norm_eps"],
            "tied": config["tie_word_embeddings"], "qkv_bias": config["attention_bias"]}


def _get(P, path: str, layer=None) -> torch.Tensor:
    t = P[path]
    return (t if layer is None else t[layer]).float()


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x (B, S, h, hd), pos (S,): rotate (x1, x2) = the two halves."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = (pos.double()[:, None] * inv[None, :]).float()
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v):
    """q (B, S, H, hd), k/v (B, S, Hk, hd) -> (B, S, H, hd), softmax over
    keys j <= i, taken in blocks of queries."""
    B, S, H, hd = q.shape
    Hk = k.shape[2]
    G = H // Hk
    out = torch.empty_like(q)
    kk = k.permute(0, 2, 1, 3)                                    # (B, Hk, S, hd)
    vv = v.permute(0, 2, 1, 3)
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(S, q0 + Q_BLOCK)
        qb = q[:, q0:q1].reshape(B, q1 - q0, Hk, G, hd).permute(0, 2, 3, 1, 4)
        s = torch.einsum("bkgqd,bkjd->bkgqj", qb, kk[:, :, :q1]) / math.sqrt(hd)
        i = torch.arange(q0, q1, device=q.device)[:, None]
        j = torch.arange(q1, device=q.device)[None, :]
        s = s.masked_fill(j > i, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqj,bkjd->bkgqd", p, vv[:, :, :q1])
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(B, q1 - q0, H, hd)
    return out


def block(x, P, l: int, w, pos, linear: Callable):
    B, S, _ = x.shape
    H, Hk, hd = w["heads"], w["kv_heads"], w["head_dim"]
    a = "blocks/0/mixer/"
    h = rms_norm(x, _get(P, "blocks/0/ln1/scale", l), w["eps"])

    def proj(name):
        y = linear(h, _get(P, a + name + "/w", l))
        return y + _get(P, a + name + "/b", l) if w["qkv_bias"] else y

    q = rope(proj("wq").reshape(B, S, H, hd), pos, w["rope_theta"])
    k = rope(proj("wk").reshape(B, S, Hk, hd), pos, w["rope_theta"])
    v = proj("wv").reshape(B, S, Hk, hd)
    o = causal_attention(q, k, v).reshape(B, S, H * hd)
    x = x + linear(o, _get(P, a + "wo/w", l))
    h = rms_norm(x, _get(P, "blocks/0/ln2/scale", l), w["eps"])
    f = "blocks/0/ffn/"
    g = F.silu(linear(h, _get(P, f + "w_gate/w", l))) * linear(h, _get(P, f + "w_up/w", l))
    return x + linear(g, _get(P, f + "w_down/w", l))


def _head(P, w):
    return _get(P, "embed/w").t() if w["tied"] else _get(P, "head/w")


def hidden(P, tokens, w, linear: Callable = exact_linear, remat: bool = False):
    """Final-normed hidden states (B, S, D) of token rows (B, S)."""
    x = _get(P, "embed/w")[tokens.long()]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for l in range(w["layers"]):
        if remat:
            x = checkpoint(block, x, P, l, w, pos, linear, use_reentrant=False)
        else:
            x = block(x, P, l, w, pos, linear)
    return rms_norm(x, _get(P, "ln_f/scale"), w["eps"])


@torch.no_grad()
def logits_at(P, w, tokens: torch.Tensor, rows: Sequence[int],
              linear: Callable = exact_linear) -> torch.Tensor:
    """Logits (len(rows), V) of one sequence (S,) at positions ``rows``."""
    h = hidden(P, tokens[None], w, linear)[0, list(rows)]
    return linear(h, _head(P, w))


def loss(P, batch, w, linear: Callable = exact_linear, chunk: int = 2048) -> torch.Tensor:
    """Mean next-token cross entropy of a batch {"tokens", "targets"} (B, S),
    the head taken ``chunk`` positions at a time under ``checkpoint``."""
    h = hidden(P, batch["tokens"], w, linear, remat=True).reshape(-1, w["d_model"])
    t = batch["targets"].reshape(-1).long()

    def part(hc, tc):
        z = linear(hc, _head(P, w))
        return (torch.logsumexp(z, -1) - z.gather(1, tc[:, None])[:, 0]).sum()

    total = sum(checkpoint(part, h[i:i + chunk], t[i:i + chunk], use_reentrant=False)
                for i in range(0, h.shape[0], chunk))
    return total / h.shape[0]
