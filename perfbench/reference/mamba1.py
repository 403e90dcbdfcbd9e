"""Plain float32 Mamba-1 language model: the reference of the
falcon-mamba-7b cell.

Independent of the program: plain ``torch`` operations in float32, no
kernel, no cache.  Each block is h = x + Mixer(RMSNorm(x)); the mixer
projects x to (u, z), runs u through a causal depthwise conv of width
d_conv with its bias and SiLU, projects it to (dt_in, B, C), takes
dt = softplus(dt_in @ W_dt + dt_bias), A = -exp(A_log), and runs the
selective scan h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t, y_t = C_t h_t +
D u_t, gated by SiLU(z) and projected back.  A final RMSNorm and an
untied head give the logits.  Where the configuration gives
``mixer_rms_eps`` (Falcon-Mamba), dt_in, B and C are each RMS-normalised
over their own width, with no scale, before they are used.  The residual
stream is float32, as everything here is (Falcon-Mamba's
``residual_in_fp32``).

The scan is exact in float32 and runs the recurrence step by step in
order: a sequence is cut into segments, a segment into chunks of
``CHUNK`` steps; one loop walks the steps of every chunk at once, a
second carries the state from chunk to chunk.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from .lowp import exact_linear
from .qwen2 import rms_norm

SEGMENT = 2048
CHUNK = 16


def widths(config: dict) -> Dict[str, object]:
    return {"kind": "mamba", "layers": config["num_hidden_layers"],
            "d_model": config["hidden_size"], "d_inner": config["intermediate_size"],
            "d_state": config["state_size"], "d_conv": config["conv_kernel"],
            "dt_rank": config["time_step_rank"], "vocab": config["vocab_size"],
            "eps": config["layer_norm_epsilon"], "tied": config["tie_word_embeddings"],
            "mixer_eps": config.get("mixer_rms_eps")}


def _get(P, path: str, layer=None) -> torch.Tensor:
    t = P[path]
    return (t if layer is None else t[layer]).float()


def scan(dA: torch.Tensor, dBu: torch.Tensor, h0: torch.Tensor):
    """Every state of h_t = dA_t h_{t-1} + dBu_t: dA, dBu (S, Di, N), h0
    (Di, N) -> (hs (S, Di, N), h_last)."""
    S = dA.shape[0]
    pad = (-S) % CHUNK
    if pad:
        dA = torch.cat([dA, dA.new_ones((pad, *dA.shape[1:]))])
        dBu = torch.cat([dBu, dBu.new_zeros((pad, *dBu.shape[1:]))])
    n = dA.shape[0] // CHUNK
    a = dA.reshape(n, CHUNK, *dA.shape[1:])
    b = dBu.reshape(n, CHUNK, *dBu.shape[1:])
    hs = torch.empty_like(b)                      # states from a zero start
    prod = torch.empty_like(a)                    # products of dA within the chunk
    hs[:, 0], prod[:, 0] = b[:, 0], a[:, 0]
    for j in range(1, CHUNK):
        hs[:, j] = a[:, j] * hs[:, j - 1] + b[:, j]
        prod[:, j] = a[:, j] * prod[:, j - 1]
    carry = h0
    for c in range(n):                            # the true start of each chunk
        hs[c] += prod[c] * carry
        carry = hs[c, -1]
    return hs.reshape(-1, *dA.shape[1:])[:S], carry


def mixer(x, P, l: int, w, linear: Callable):
    """x (S, D) -> (S, D) for one sequence."""
    S = x.shape[0]
    Di, N, R, K = w["d_inner"], w["d_state"], w["dt_rank"], w["d_conv"]
    m = "blocks/0/mixer/"
    u, z = linear(x, _get(P, m + "in_proj/w", l)).split(Di, dim=-1)
    cw = _get(P, m + "conv_w", l)                                 # (Di, K)
    up = F.pad(u, (0, 0, K - 1, 0))
    conv = sum(up[i:i + S] * cw[:, i] for i in range(K)) + _get(P, m + "conv_b", l)
    u = F.silu(conv)
    dt_in, Bc, Cc = linear(u, _get(P, m + "x_proj/w", l)).split([R, N, N], dim=-1)
    if w["mixer_eps"] is not None:
        dt_in, Bc, Cc = (rms_norm(t, 1.0, w["mixer_eps"]) for t in (dt_in, Bc, Cc))
    dt = F.softplus(dt_in @ _get(P, m + "dt_proj/w", l) + _get(P, m + "dt_bias", l))
    A = -torch.exp(_get(P, m + "A_log", l))                       # (Di, N)
    h = torch.zeros((Di, N), dtype=torch.float32, device=x.device)
    ys = []
    for s0 in range(0, S, SEGMENT):
        sl = slice(s0, s0 + SEGMENT)
        dA = torch.exp(dt[sl, :, None] * A)
        dBu = (dt[sl] * u[sl])[:, :, None] * Bc[sl, None, :]
        hs, h = scan(dA, dBu, h)
        ys.append(torch.einsum("sdn,sn->sd", hs, Cc[sl]))
        del dA, dBu, hs
    y = torch.cat(ys) + _get(P, m + "D", l) * u
    return linear(y * F.silu(z), _get(P, m + "out_proj/w", l))


@torch.no_grad()
def logits_at(P, w, tokens: torch.Tensor, rows: Sequence[int],
              linear: Callable = exact_linear) -> torch.Tensor:
    """Logits (len(rows), V) of one sequence (S,) at positions ``rows``."""
    x = _get(P, "embed/w")[tokens.long()]
    for l in range(w["layers"]):
        x = x + mixer(rms_norm(x, _get(P, "blocks/0/ln1/scale", l), w["eps"]), P, l, w, linear)
    h = rms_norm(x, _get(P, "ln_f/scale"), w["eps"])[list(rows)]
    return linear(h, _get(P, "head/w"))
