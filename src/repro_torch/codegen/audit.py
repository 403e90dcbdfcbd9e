"""Analytic gate census (exact integer counts from Tables II/IV/V) and
the netlist <-> cost-model consistency audit.

The cost model's area is literally (gate census) . (per-cell areas); the
generator emits those gates structurally.  ``audit()`` checks both
directions: census equality per cell type, and census-area == Table V/VI
area (exact for INT; the INT->FP normalize tree uses integer ceil counts
vs the paper's real-valued halving, so FP is checked to <1%).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..core.cells import CellLibrary, TSMC28
from ..core.macros import fp_macro, int_macro

from .verilog import DcimDesign

CELLS = ("NOR", "OR", "MUX2", "HA", "FA", "DFF", "SRAM")


def _zero() -> Dict[str, int]:
    return {k: 0 for k in CELLS}


def _add(a, b, mult=1):
    return {k: a[k] + mult * b[k] for k in CELLS}


def adder_census(n: int) -> Dict[str, int]:
    c = _zero()
    c["FA"] = n - 1
    c["HA"] = 1
    return c


def sel_census(n: int) -> Dict[str, int]:
    c = _zero()
    c["MUX2"] = max(n - 1, 0)
    return c


def shifter_census(n: int) -> Dict[str, int]:
    c = _zero()
    c["MUX2"] = n * max(n - 1, 0)
    return c


def tree_census(H: int, k: int) -> Dict[str, int]:
    c = _zero()
    for lvl in range(int(math.log2(H))):
        cnt = H >> (lvl + 1)
        c = _add(c, adder_census(k + lvl), cnt)
    return c


def accu_census(B_x: int, H: int) -> Dict[str, int]:
    B = B_x + int(math.log2(H))
    c = _zero()
    c["DFF"] = B
    c = _add(c, shifter_census(B))
    return _add(c, adder_census(B))


def fusion_census(B_w: int, B_x: int, H: int) -> Dict[str, int]:
    w = B_x + int(math.log2(H))
    c = _zero()
    c["FA"] = (B_w - 1) * (w - 1)
    c["HA"] = B_w + w - 1
    return c


def prealign_census(H: int, B_E: int, B_M: int) -> Dict[str, int]:
    c = _zero()
    c = _add(c, adder_census(B_E), H - 1)       # comparator tree
    return _add(c, shifter_census(B_M), H)      # mantissa barrel shifters


def int2fp_census(B_r: int, B_E: int) -> Dict[str, int]:
    """Integer (emitted) counts; the paper's Table IV uses real-valued
    halving, so this differs from the analytic area by <1%."""
    c = _zero()
    for l in range(1, math.ceil(math.log2(B_r)) + 1):
        c["OR"] += max(math.ceil(B_r / 2**l) - 1, 0)
        c["MUX2"] += math.ceil(B_r / 2**l)
    return _add(c, adder_census(B_E))


def compute_unit_census(d: DcimDesign) -> Dict[str, int]:
    c = _zero()
    c["NOR"] = d.k
    if d.include_selection_mux and d.L > 1:
        c = _add(c, sel_census(d.L))
    return c


def macro_census(d: DcimDesign) -> Dict[str, int]:
    """Analytic census for the whole macro (Table V/VI assembly)."""
    c = _zero()
    # CU appears H times per column; tree + accumulator once per column.
    per_col = _add(
        _add(tree_census(d.H, d.k), accu_census(d.B_x, d.H)),
        compute_unit_census(d),
        mult=d.H,
    )
    c = _add(c, per_col, d.N)
    c = _add(c, fusion_census(d.B_w, d.B_x, d.H), d.N // d.B_w)
    c["SRAM"] += d.N * d.H * d.L
    if d.is_fp:
        c = _add(c, prealign_census(d.H, d.B_E, d.B_x))
        c = _add(c, int2fp_census(d.B_w + d.B_x + int(math.log2(d.H)), d.B_E),
                 d.N // d.B_w)
    return c


def census_area(census: Dict[str, int], lib: CellLibrary = TSMC28) -> float:
    return (
        census["NOR"] * lib.A_NOR
        + census["OR"] * lib.A_OR
        + census["MUX2"] * lib.A_MUX
        + census["HA"] * lib.A_HA
        + census["FA"] * lib.A_FA
        + census["DFF"] * lib.A_DFF
        + census["SRAM"] * lib.A_SRAM
    )


def model_area(d: DcimDesign, lib: CellLibrary = TSMC28) -> float:
    """Table V/VI area of one design: Python floats in, the cost model's
    float32 on the CPU out, whatever the caller's default device."""
    with torch.device("cpu"):
        if d.is_fp:
            mc = fp_macro(
                float(d.N), float(d.H), float(d.L), float(d.k),
                d.B_w, d.B_E, d.B_x, lib,
                include_selection_mux=d.include_selection_mux,
            )
        else:
            mc = int_macro(
                float(d.N), float(d.H), float(d.L), float(d.k),
                d.B_w, d.B_x, lib,
                include_selection_mux=d.include_selection_mux,
            )
    return float(mc.area)


def audit(d: DcimDesign, emitted_census: Dict[str, int],
          lib: CellLibrary = TSMC28) -> dict:
    """Three-way consistency: emitted netlist census == analytic census,
    and analytic-census area == Table V/VI area."""
    analytic = macro_census(d)
    mismatches = {
        k: (emitted_census[k], analytic[k])
        for k in CELLS
        if emitted_census[k] != analytic[k]
    }
    a_census = census_area(analytic, lib)
    a_model = model_area(d, lib)
    rel = abs(a_census - a_model) / max(a_model, 1e-9)
    return dict(
        census_match=not mismatches,
        mismatches=mismatches,
        census_area=a_census,
        model_area=a_model,
        area_rel_err=rel,
        ok=(not mismatches) and (rel < (0.01 if d.is_fp else 1e-5)),
    )
