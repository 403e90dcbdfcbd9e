"""The controls: the plain reference put in the program's place and
computed in the precision below the configuration's (fp8 products for a
bfloat16 model, ``reference.lowp``), read by the same numbers as a run.

A limit has to fail the control: the benchmark's runs never compute
these; ``tools/calibrate.py`` reads them on the card at the cell's own
size, the tests under ``perfbench/tests`` at a small one.
"""
from __future__ import annotations

import torch

from reference.lowp import fp8_linear

from . import spec, train_closed_loop, weights
from .serve_open_loop import _exact


def serve_gap(cell, run, seed: int, device) -> float:
    """At each position of the requests a run judged (their prompts and
    served tokens), the gap between the float32 reference's best logit and
    its logit of the token the fp8 reference puts first; the widest."""
    ref = spec.reference(cell.config)
    w = spec.widths(cell.config)
    P = weights.by_path(weights.draw(spec.program_config(cell.config), seed, device))
    worst = 0.0
    with _exact():
        for rec in run.sample:
            prompt = torch.as_tensor(run.prompts[rec.rid], device=device).to(torch.int64)
            served = torch.as_tensor(rec.tokens, device=device).to(torch.int64)
            seq = torch.cat([prompt, served])[:-1]
            rows = range(rec.prompt_len - 1, seq.numel())
            low = ref.logits_at(P, w, seq, rows, linear=fp8_linear).argmax(-1)
            z = ref.logits_at(P, w, seq, rows)
            worst = max(worst, float((z.max(-1).values - z.gather(1, low[:, None])[:, 0]).max()))
    return worst


def train_checks(cell, seed: int, device) -> dict:
    """The training numbers of the fp8 reference (its set-up steps) against
    the float32 reference's, on the same weights and batches."""
    from . import traffic

    w = spec.widths(cell.config)
    cfg = spec.program_config(cell.config)
    p0 = {k: v.to("cpu", copy=True)
          for k, v in weights.leaves(weights.draw(cfg, seed, device))}
    batch = lambda k: traffic.train_batch(cell.traffic, seed, k, w["vocab"], device)
    n = int(cell.traffic["setup_steps"])
    low = train_closed_loop.reference_steps(cell, w, p0, batch, n, device, linear=fp8_linear)
    exact = train_closed_loop.reference_steps(cell, w, p0, batch, n, device)
    return train_closed_loop.compare(low, exact, cell.data["limits"])
