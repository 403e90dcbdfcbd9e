"""Device selection for the port's public entry points.

Entry points default to the card (``device="cuda"``) and raise when no
card is present: they never quietly carry on on the CPU.  Callers that
want the CPU (the tests, the CPU rehearsal of the smoke run) say so."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
