"""Device selection for the port's public entry points.

Entry points default to the card (``device="cuda"``) and raise when no
card is present: they never quietly carry on on the CPU.  Callers that
want the CPU (the tests, the CPU rehearsal of the smoke run) say so.

Resolving a CUDA device also turns cuBLAS's reduced-precision reduction
off, for bf16 and f16 products alike (PyTorch allows both by default):
a bf16 x bf16 product with a bf16 output may otherwise reduce in bf16,
where the reference declares f32 accumulation for every such product
(``preferred_element_type=float32``: ``models.common.dense``, the tied
head, attention).  The CPU's bf16 products accumulate in f32 already.
The contract lint reads the flags at every product it records."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    return dev
