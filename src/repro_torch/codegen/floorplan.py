"""Deterministic floorplanner — the stand-in for the commercial P&R step.

Places the macro's three regions exactly as the paper's Fig. 6 layouts
do: the SRAM/compute array in the middle (N column strips, each strip =
L*H cells + H compute units + adder tree + shift accumulator), the
result-fusion + INT->FP converter row at the bottom, and the FP
pre-alignment block on the left edge.  Geometry is derived from the same
gate census the cost model uses, at a configurable placement utilization
(default 70%, a typical Innovus target).

Outputs a DEF-like placement text + a JSON-able summary whose total area
is compared against the analytic model in tests.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

from ..core.cells import CellLibrary, TechParams, TSMC28, CALIBRATED

from . import audit
from .verilog import DcimDesign


@dataclasses.dataclass
class Block:
    name: str
    x_um: float
    y_um: float
    w_um: float
    h_um: float

    @property
    def area_um2(self) -> float:
        return self.w_um * self.h_um


def _region_area_um2(census: Dict[str, int], lib: CellLibrary,
                     tech: TechParams, util: float) -> float:
    return audit.census_area(census, lib) * tech.A_gate_um2 / util


def floorplan(
    d: DcimDesign,
    tech: TechParams = CALIBRATED,
    lib: CellLibrary = TSMC28,
    utilization: float = 0.7,
) -> dict:
    lg = int(math.log2(d.H))
    z = audit._zero

    # Region censuses.
    array_census = z()
    array_census["SRAM"] = d.N * d.H * d.L
    cu = audit.compute_unit_census(d)
    col_logic = audit._add(
        audit._add(audit.tree_census(d.H, d.k), audit.accu_census(d.B_x, d.H)),
        cu, mult=d.H,
    )
    array_census = audit._add(array_census, col_logic, d.N)

    bottom_census = audit._add(z(), audit.fusion_census(d.B_w, d.B_x, d.H),
                               d.N // d.B_w)
    left_census = z()
    if d.is_fp:
        bottom_census = audit._add(
            bottom_census,
            audit.int2fp_census(d.B_w + d.B_x + lg, d.B_E),
            d.N // d.B_w,
        )
        left_census = audit.prealign_census(d.H, d.B_E, d.B_x)

    a_array = _region_area_um2(array_census, lib, tech, utilization)
    a_bottom = _region_area_um2(bottom_census, lib, tech, utilization)
    a_left = _region_area_um2(left_census, lib, tech, utilization)

    # Array: N column strips side by side; aspect ratio ~= 1 overall.
    total = a_array + a_bottom + a_left
    side = math.sqrt(total)
    array_w = side if a_left == 0 else side * a_array / (a_array + a_left)
    array_h = a_array / array_w
    left_w = 0.0 if a_left == 0 else a_left / array_h
    bottom_h = a_bottom / (left_w + array_w) if a_bottom else 0.0

    blocks: List[Block] = []
    if a_left:
        blocks.append(Block("fp_prealign", 0.0, bottom_h, left_w, array_h))
    col_w = array_w / d.N
    for c in range(d.N):
        blocks.append(
            Block(f"column[{c}]", left_w + c * col_w, bottom_h, col_w, array_h)
        )
    if a_bottom:
        blocks.append(
            Block("fusion_convert_row", 0.0, 0.0, left_w + array_w, bottom_h)
        )

    die_w = left_w + array_w
    die_h = bottom_h + array_h
    summary = dict(
        design=dataclasses.asdict(d),
        utilization=utilization,
        die_w_um=die_w,
        die_h_um=die_h,
        die_area_mm2=die_w * die_h * 1e-6,
        array_area_mm2=a_array * 1e-6,
        prealign_area_mm2=a_left * 1e-6,
        periphery_area_mm2=a_bottom * 1e-6,
        cell_area_mm2=audit.census_area(audit.macro_census(d), lib)
        * tech.A_gate_um2 * 1e-6,
        n_blocks=len(blocks),
    )
    return {"blocks": blocks, "summary": summary, "def": _emit_def(d, blocks, die_w, die_h)}


def _emit_def(d: DcimDesign, blocks: List[Block], die_w: float, die_h: float) -> str:
    lines = [
        "VERSION 5.8 ;",
        f"DESIGN dcim_macro_{d.precision}_{d.w_store} ;",
        "UNITS DISTANCE MICRONS 1000 ;",
        f"DIEAREA ( 0 0 ) ( {int(die_w * 1000)} {int(die_h * 1000)} ) ;",
        f"COMPONENTS {len(blocks)} ;",
    ]
    for b in blocks:
        lines.append(
            f"- {b.name} dcim_block + PLACED ( {int(b.x_um * 1000)}"
            f" {int(b.y_um * 1000)} ) N ;"
        )
    lines += ["END COMPONENTS", "END DESIGN"]
    return "\n".join(lines) + "\n"
