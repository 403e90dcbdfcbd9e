"""DCIM component cost models (paper Table IV).

Components: adder tree, shift accumulator, result-fusion unit, FP
pre-alignment, INT->FP converter.  All functions broadcast over float32
tensors; tree summations are *static masked loops* (max log2 H = 12,
max log2 B_r = 7) so one call serves a population with non-uniform H.
Operation order follows ``repro.core.components``.
"""
from __future__ import annotations

import torch

from . import modules as m
from .cells import CellLibrary, TSMC28
from .modules import f32

_MAX_LOG2_H = 12   # H <= 4096 covered; paper bounds H <= 2048
_MAX_LOG2_BR = 7   # B_r = B_w + B_M + log2 H <= 59 for FP32


def _log2(n):
    return torch.log2(torch.clamp_min(f32(n), 1.0))


def _zeros(*xs):
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    return torch.zeros(shape, dtype=torch.float32, device=xs[0].device)


# --- Adder tree: H k-bit inputs, levels n = 0 .. log2(H)-1 -----------------
def tree_area(H, k, lib: CellLibrary = TSMC28):
    H, k = f32(H), f32(k)
    lg = _log2(H)
    out = _zeros(H, k)
    for n in range(_MAX_LOG2_H):
        out = out + torch.where(n < lg, m.add_area(k + n, lib) * H / 2.0 ** (n + 1), 0.0)
    return out


def tree_delay(H, k, lib: CellLibrary = TSMC28):
    H, k = f32(H), f32(k)
    lg = _log2(H)
    out = _zeros(H, k)
    for n in range(_MAX_LOG2_H):
        out = out + torch.where(n < lg, m.add_delay(k + n, lib), 0.0)
    return out


def tree_energy(H, k, lib: CellLibrary = TSMC28):
    H, k = f32(H), f32(k)
    lg = _log2(H)
    out = _zeros(H, k)
    for n in range(_MAX_LOG2_H):
        out = out + torch.where(n < lg, m.add_energy(k + n, lib) * H / 2.0 ** (n + 1), 0.0)
    return out


# --- Shift accumulator: width B = B_x + log2 H ------------------------------
def _accu_width(B_x, H):
    return f32(B_x) + _log2(H)


def accu_area(B_x, H, lib: CellLibrary = TSMC28):
    B = _accu_width(B_x, H)
    return B * lib.A_DFF + m.shift_area(B, lib) + m.add_area(B, lib)


def accu_delay(B_x, H, lib: CellLibrary = TSMC28):
    B = _accu_width(B_x, H)
    return m.shift_delay(B, lib) + m.add_delay(B, lib)


def accu_energy(B_x, H, lib: CellLibrary = TSMC28):
    B = _accu_width(B_x, H)
    return B * lib.E_DFF + m.shift_energy(B, lib) + m.add_energy(B, lib)


# --- Result-fusion unit ------------------------------------------------------
def fusion_area(B_w, B_x, H, lib: CellLibrary = TSMC28):
    B_w = f32(B_w)
    w = f32(B_x) + _log2(H)          # per-column width
    return (B_w - 1.0) * (w - 1.0) * lib.A_FA + (B_w + w - 1.0) * lib.A_HA


def fusion_delay(B_w, B_x, H, lib: CellLibrary = TSMC28):
    B_w = f32(B_w)
    w = f32(B_x) + _log2(H)
    return (w - 1.0) * lib.D_HA + (B_w - 1.0) * lib.D_FA


def fusion_energy(B_w, B_x, H, lib: CellLibrary = TSMC28):
    B_w = f32(B_w)
    w = f32(B_x) + _log2(H)
    return (B_w - 1.0) * (w - 1.0) * lib.E_FA + (B_w + w - 1.0) * lib.E_HA


# --- FP pre-alignment: comparison tree + H mantissa barrel shifters ---------
# sum_{i=1..log2 H} H/2^i == H - 1 comparators (closed form kept explicit to
# mirror Table IV).
def align_area(H, B_E, B_M, lib: CellLibrary = TSMC28):
    H = f32(H)
    return (H - 1.0) * m.comp_area(B_E, lib) + H * m.shift_area(B_M, lib)


def align_delay(H, B_E, B_M, lib: CellLibrary = TSMC28):
    return torch.maximum(_log2(H) * m.comp_delay(B_E, lib), m.shift_delay(B_M, lib))


def align_energy(H, B_E, B_M, lib: CellLibrary = TSMC28):
    H = f32(H)
    return (H - 1.0) * m.comp_energy(B_E, lib) + H * m.shift_energy(B_M, lib)


# --- INT -> FP converter -----------------------------------------------------
def result_width(B_w, B_M, H):
    """B_r = B_w + B_M + log2 H (paper §III-B1)."""
    return f32(B_w) + f32(B_M) + _log2(H)


def _convert_tree(B_r, a_or, a_mux):
    """sum_{l=1..log2 B_r} ((B_r/2^l - 1)*c_OR + (B_r/2^l)*c_MUX).

    B_r is generally not a power of two; the paper's sum is evaluated with
    real-valued halving up to ceil(log2 B_r) levels.
    """
    B_r = f32(B_r)
    levels = torch.ceil(_log2(B_r))
    out = torch.zeros_like(B_r)
    for l in range(1, _MAX_LOG2_BR + 1):
        frac = B_r / 2.0 ** l
        out = out + torch.where(
            l <= levels, torch.clamp_min(frac - 1.0, 0.0) * a_or + frac * a_mux, 0.0
        )
    return out


def convert_area(N, B_w, B_E, B_r, lib: CellLibrary = TSMC28):
    per = _convert_tree(B_r, lib.A_OR, lib.A_MUX) + m.add_area(B_E, lib)
    return f32(N) / f32(B_w) * per


def convert_delay(B_E, B_r, lib: CellLibrary = TSMC28):
    return _log2(B_r) * (lib.D_OR + lib.D_MUX) + m.add_delay(B_E, lib)


def convert_energy(N, B_w, B_E, B_r, lib: CellLibrary = TSMC28):
    per = _convert_tree(B_r, lib.E_OR, lib.E_MUX) + m.add_energy(B_E, lib)
    return f32(N) / f32(B_w) * per
