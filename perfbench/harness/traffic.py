"""The one general traffic generator: it reads a mix's data file and the
cell's own data, and makes the requests (or training batches) of a run
from ``--seed``.

Every seed gets the same work in the same order.  A serving run of
``n = round(rate * seconds)`` requests takes its prompt lengths, output
lengths and gaps between arrivals at fixed quantiles of their laws, put
in an order fixed by the mix's ``order_seed``; the run's seed draws only
the prompts' token ids.  So every seed's window holds the same sizes at
the same times, whatever share of them the system completes, and the
run's spread is the system's and not the draw's.  The gaps follow the
exponential law (a Poisson process), scaled so that the last request is
due half a mean gap before the window ends.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np


@dataclasses.dataclass
class Planned:
    rid: int
    due_s: float                  # seconds after the window's start
    prompt: np.ndarray            # (P,) int32
    n_tokens: int


def _quantiles(law: dict, n: int) -> np.ndarray:
    """n values of ``law`` at the mid-points of n equal slices of its
    probability: {"law": "log_uniform" | "uniform", "min", "max"}, whole
    numbers."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = float(law["min"]), float(law["max"])
    if law["law"] == "log_uniform":
        v = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    elif law["law"] == "uniform":
        v = lo + q * (hi - lo)
    else:
        raise ValueError(f"unknown law {law['law']!r}")
    return np.rint(v).astype(np.int64)


def n_requests(rate_per_s: float, seconds: float) -> int:
    return max(1, int(round(rate_per_s * seconds)))


def serve_plan(traffic: dict, rate_per_s: float, seconds: float, seed: int,
               vocab: int) -> List[Planned]:
    """The requests due in a window of ``seconds`` at ``rate_per_s``."""
    if traffic.get("arrivals") != "poisson":
        raise ValueError(f"unknown arrivals {traffic.get('arrivals')!r}")
    n = n_requests(rate_per_s, seconds)
    order = np.random.default_rng(int(traffic["order_seed"]))
    prompts = order.permutation(_quantiles(traffic["prompt_tokens"], n))
    outputs = order.permutation(_quantiles(traffic["output_tokens"], n))
    q = (np.arange(n) + 0.5) / n
    gaps = order.permutation(-np.log1p(-q))
    gaps *= seconds * (1.0 - 0.5 / n) / gaps.sum()
    due = np.cumsum(gaps)
    rng = np.random.default_rng(int(seed))
    return [Planned(i, float(due[i]), rng.integers(0, vocab, int(prompts[i]), dtype=np.int32),
                    int(outputs[i])) for i in range(n)]


def warm_plan(traffic: dict, seed: int, vocab: int) -> List[List[np.ndarray]]:
    """The set-up's warm bursts: for each [width, prompt length] of the
    mix's ``warm`` list, ``width`` prompts of that length (admitted
    together, they run one prefill program of that width and bucket)."""
    rng = np.random.default_rng([int(seed), 1])
    return [[rng.integers(0, vocab, int(length), dtype=np.int32) for _ in range(int(width))]
            for width, length in traffic["warm"]]


def train_batch(traffic: dict, seed: int, step: int, vocab: int, device):
    """Step ``step``'s batch (``step`` counts from 1): ``batch`` rows of
    ``seq`` tokens and their targets, made on ``device``.  The
    "successor" stream is the learnable one (next token = token + 1 mod
    V), each row starting at its own offset drawn from (seed, step), so
    every row of every step differs and the loss has something to learn."""
    import torch

    if traffic["stream"] != "successor":
        raise ValueError(f"unknown stream {traffic['stream']!r}")
    B, S = int(traffic["batch"]), int(traffic["seq"])
    rng = np.random.default_rng([int(seed), int(step)])
    offsets = rng.choice(vocab, size=B, replace=False)
    base = torch.as_tensor(offsets, device=device)[:, None] + torch.arange(S + 1, device=device)
    toks = (base % vocab).to(torch.int32)
    return {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous(),
            "loss_mask": torch.ones((B, S), dtype=torch.float32, device=device)}
