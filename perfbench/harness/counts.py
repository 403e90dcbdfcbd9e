"""The benchmark's own count of operations and bytes, from shapes.

``w`` is a configuration's ``widths`` (``spec.widths``).  Counts are of
what the inputs need: real tokens, never bucket padding; a causal query
at position i of a row attends i + 1 keys of its tail plus the row's
reused context.  A multiply-add is two operations.  Bytes count each
input read once and each output written once, whatever a kernel reads
again.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

from . import peaks

BF16 = 2
F32 = 4


# ---------------------------------------------------------------- the model
def dense_flops_per_token(w: Dict) -> float:
    """Every weight product of the block stack for one token (the head
    apart): 2 x the stack's matmul weights."""
    d, L = w["d_model"], w["layers"]
    if w["kind"] == "gqa":
        H, Hk, hd, f = w["heads"], w["kv_heads"], w["head_dim"], w["d_ff"]
        per_layer = d * H * hd + 2 * d * Hk * hd + H * hd * d + 3 * d * f
    elif w["kind"] == "mamba":
        Di, N, R = w["d_inner"], w["d_state"], w["dt_rank"]
        per_layer = d * 2 * Di + Di * (R + 2 * N) + R * Di + Di * d
    else:
        raise ValueError(w["kind"])
    return 2.0 * L * per_layer


def head_flops(w: Dict) -> float:
    """The head's product for one token's logits."""
    return 2.0 * w["d_model"] * w["vocab"]


def attention_flops(w: Dict, pairs: float) -> float:
    """Scores and weighted values of every layer for ``pairs`` (query,
    key) pairs: 4 x heads x head_dim a pair a layer; 0 without attention."""
    if w["kind"] != "gqa":
        return 0.0
    return 4.0 * w["layers"] * w["heads"] * w["head_dim"] * pairs


def scan_flops_per_token(w: Dict) -> float:
    """A Mamba stack's arithmetic outside its products, one token: the
    depthwise conv (2 x d_conv a channel) and the recurrence (K7's count);
    0 without SSM layers."""
    if w["kind"] != "mamba":
        return 0.0
    Di = w["d_inner"]
    return w["layers"] * (2.0 * w["d_conv"] * Di + Di * k7_flops_per_channel(w["d_state"]))


def causal_pairs(tail: int, ctx: int = 0) -> int:
    """(query, key) pairs of a causal tail of ``tail`` tokens over ``ctx``
    reused context tokens."""
    return tail * ctx + tail * (tail + 1) // 2


def forward_flops(w: Dict, tokens: int, pairs: float, logit_rows: int) -> float:
    """A forward over ``tokens`` tokens with ``pairs`` attention pairs and
    the head at ``logit_rows`` positions."""
    return (tokens * (dense_flops_per_token(w) + scan_flops_per_token(w))
            + attention_flops(w, pairs) + logit_rows * head_flops(w))


def train_step_flops(w: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: forward and backward (3x the
    forward), the loss's head at every position, no recompute counted."""
    return 3.0 * forward_flops(w, batch * seq, batch * causal_pairs(seq), batch * seq)


# --------------------------------------------------------------- K5 and K7
def k5_launch(w: Dict, rows: Iterable[Tuple[int, int]], act_bytes: int = BF16
              ) -> Tuple[float, float]:
    """(operations, bytes) of one ``prefix_prefill`` launch (one layer) over
    ``rows`` of (tail tokens, context tokens): q and the tail's K and V
    read, the context's K and V read, the float32 output written."""
    H, Hk, hd = w["heads"], w["kv_heads"], w["head_dim"]
    flops = nbytes = 0.0
    for tail, ctx in rows:
        flops += 4.0 * H * hd * causal_pairs(tail, ctx)
        nbytes += (tail * H * hd * act_bytes + 2 * (tail + ctx) * Hk * hd * act_bytes
                   + tail * H * hd * F32 + F32)
    return flops, nbytes


def k7_flops_per_channel(N: int) -> float:
    """One step of one channel of the selective scan: dt x u once, then per
    state exp(dt A) (a product and an exponential), (dt u) B, the update
    h = dA h + dBu (two), C h and its sum (two); then the D skip (two)."""
    return 7.0 * N + 3.0


def k7_launch(w: Dict, rows: Iterable[int], u_bytes: int = BF16) -> Tuple[float, float]:
    """(operations, bytes) of one ``selective_scan`` launch (one layer) over
    ``rows`` of real tokens: u, dt, B and C read, y written, A and D read
    once, each row's last state written."""
    D, N = w["d_inner"], w["d_state"]
    flops = nbytes = 0.0
    for tokens in rows:
        flops += tokens * D * k7_flops_per_channel(N)
        nbytes += tokens * (D * (u_bytes + F32 + F32) + 2 * N * F32) + D * N * F32
    return flops, nbytes + D * N * F32 + D * F32


def bound_s(flops: float, nbytes: float, flops_per_s: float) -> float:
    """The least time the card could take: the larger of the operations
    at ``flops_per_s`` and the bytes at the HBM rate."""
    return max(flops / flops_per_s, nbytes / peaks.HBM_BYTES_PER_S)
