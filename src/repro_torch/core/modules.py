"""Digital logic module cost models (paper Table II).

Every function is elementwise float32 tensor code and broadcasts over
arbitrary shapes, so the whole design space is evaluated in one call.
``N`` arguments may be tensors or Python numbers (the paper's formulas
use real ``log2 N``; the explorer only ever passes powers of two).  The
operations and their order follow ``repro.core.modules`` one for one.

Cost triplets are returned as ``(area, delay, energy)`` in NOR-gate
normalized units (see cells.py).
"""
from __future__ import annotations

import torch

from .cells import CellLibrary, TSMC28


def f32(x) -> torch.Tensor:
    """``jnp.asarray(x, float32)``: keeps a tensor's device, makes a
    0-d CPU tensor of a Python number (it broadcasts onto any device)."""
    return torch.as_tensor(x, dtype=torch.float32)


def _log2(n):
    return torch.log2(torch.clamp_min(f32(n), 1.0))


# --- 1-bit x N-bit multiplier (k NOR gates, Fig. 5) -----------------------
def mul_area(N, lib: CellLibrary = TSMC28):
    return f32(N) * lib.A_NOR


def mul_delay(N, lib: CellLibrary = TSMC28):
    return torch.full_like(f32(N), lib.D_NOR)


def mul_energy(N, lib: CellLibrary = TSMC28):
    return f32(N) * lib.E_NOR


# --- N-bit ripple-carry adder ---------------------------------------------
def add_area(N, lib: CellLibrary = TSMC28):
    return (f32(N) - 1.0) * lib.A_FA + lib.A_HA


def add_delay(N, lib: CellLibrary = TSMC28):
    return (f32(N) - 1.0) * lib.D_FA + lib.D_HA


def add_energy(N, lib: CellLibrary = TSMC28):
    return (f32(N) - 1.0) * lib.E_FA + lib.E_HA


# --- N:1 mux ---------------------------------------------------------------
def sel_area(N, lib: CellLibrary = TSMC28):
    return (f32(N) - 1.0) * lib.A_MUX


def sel_delay(N, lib: CellLibrary = TSMC28):
    return _log2(N) * lib.D_MUX


def sel_energy(N, lib: CellLibrary = TSMC28):
    return (f32(N) - 1.0) * lib.E_MUX


# --- N-bit barrel shifter (N parallel N:1 muxes) ---------------------------
def shift_area(N, lib: CellLibrary = TSMC28):
    return f32(N) * sel_area(N, lib)


def shift_delay(N, lib: CellLibrary = TSMC28):
    if lib.shifter_delay_model == "mux_tree":
        return sel_delay(N, lib)
    # As printed in Table II: (log2 N) * D_sel(N) == (log2 N)^2 * D_MUX.
    return _log2(N) * sel_delay(N, lib)


def shift_energy(N, lib: CellLibrary = TSMC28):
    return f32(N) * sel_energy(N, lib)


# --- N-bit comparator (simplified to an adder, paper §III-B1) ---------------
def comp_area(N, lib: CellLibrary = TSMC28):
    return add_area(N, lib)


def comp_delay(N, lib: CellLibrary = TSMC28):
    return add_delay(N, lib)


def comp_energy(N, lib: CellLibrary = TSMC28):
    return add_energy(N, lib)
