"""Whole-macro cost models (paper Tables V & VI) + derived metrics.

``int_macro`` implements Table V (multiply-based integer DCIM) and
``fp_macro`` Table VI (pre-aligned floating-point DCIM).  Both broadcast
over float32 tensors, so a whole NSGA-II population (or the full
enumerated design space, for every scenario at once) is evaluated in a
single call.

Outputs are NOR-normalized (area in A_gate, delay in D_gate, per-cycle
energy in E_gate).  Throughput follows the paper exactly:

    T = (N / B_w) * H * 2 * (k / B_x) * (1 / D)      [ops per gate-delay]

``physical`` converts to mm^2 / ns / nJ / TOPS / TOPS/W / TOPS/mm^2 with a
``TechParams`` calibration, including the activity (sparsity) factor the
paper applies for its Fig. 8 comparison (10% input activity).
"""
from __future__ import annotations

import dataclasses

import torch

from . import components as c
from . import modules as m
from .cells import CALIBRATED, CellLibrary, TSMC28, TechParams
from .modules import f32
from .precision import Precision


@dataclasses.dataclass
class MacroCosts:
    """NOR-normalized macro costs. All fields broadcast together."""

    area: torch.Tensor        # A_gate units
    delay: torch.Tensor       # D_gate units (critical path per cycle)
    energy: torch.Tensor      # E_gate units (per cycle)
    throughput: torch.Tensor  # ops per D_gate (2 ops per MAC)
    sram_bits: torch.Tensor   # N*H*L
    # Component breakdown (normalized area) for reports/floorplanning.
    area_sram: torch.Tensor
    area_mul: torch.Tensor
    area_tree: torch.Tensor
    area_accu: torch.Tensor
    area_fusion: torch.Tensor
    area_align: torch.Tensor
    area_convert: torch.Tensor

    def objectives(self) -> torch.Tensor:
        """Stack the paper's 4 objectives [A, D, E, -T] on a last axis."""
        return torch.stack(
            [self.area, self.delay, self.energy, -self.throughput], dim=-1
        )


def int_macro(
    N,
    H,
    L,
    k,
    B_w,
    B_x,
    lib: CellLibrary = TSMC28,
    include_selection_mux: bool = False,
) -> MacroCosts:
    """Table V — multiply-based integer DCIM.

    ``include_selection_mux=False`` reproduces the printed Table V, which
    omits the per-compute-unit L:1 weight-selection gate of Fig. 5; the
    extended model adds ``N*H*k`` L:1 muxes (one per NOR input bit).
    """
    N, H, L, k, B_w, B_x = (f32(a) for a in (N, H, L, k, B_w, B_x))

    a_sram = N * H * L * lib.A_SRAM
    a_mul = N * H * k * lib.A_NOR
    a_tree = N * c.tree_area(H, k, lib)
    a_accu = N * c.accu_area(B_x, H, lib)
    a_fusion = N / B_w * c.fusion_area(B_w, B_x, H, lib)

    e_mul = N * H * k * lib.E_NOR
    e_tree = N * c.tree_energy(H, k, lib)
    e_accu = N * c.accu_energy(B_x, H, lib)
    e_fusion = N / B_w * c.fusion_energy(B_w, B_x, H, lib)

    d_path = lib.D_NOR + c.tree_delay(H, k, lib) + c.accu_delay(B_x, H, lib)
    d_fusion = c.fusion_delay(B_w, B_x, H, lib)

    if include_selection_mux:
        a_mul = a_mul + N * H * m.sel_area(L, lib)
        e_mul = e_mul + N * H * m.sel_energy(L, lib)
        d_path = d_path + m.sel_delay(L, lib)

    area = a_sram + a_mul + a_tree + a_accu + a_fusion
    energy = e_mul + e_tree + e_accu + e_fusion
    delay = torch.maximum(d_path, d_fusion)
    thpt = N / B_w * H * 2.0 * (k / B_x) / delay
    zero = torch.zeros_like(area)

    return MacroCosts(
        area=area,
        delay=delay,
        energy=energy,
        throughput=thpt,
        sram_bits=N * H * L,
        area_sram=a_sram,
        area_mul=a_mul,
        area_tree=a_tree,
        area_accu=a_accu,
        area_fusion=a_fusion,
        area_align=zero,
        area_convert=zero,
    )


def fp_macro(
    N,
    H,
    L,
    k,
    B_w,
    B_E,
    B_M,
    lib: CellLibrary = TSMC28,
    include_selection_mux: bool = False,
) -> MacroCosts:
    """Table VI — pre-aligned floating-point DCIM.

    The integer core runs on aligned mantissas (B_x -> B_M); one
    pre-alignment unit serves the whole array (Fig. 3) and N/B_w INT->FP
    converters sit after the result-fusion units.
    """
    N, B_w, B_E, B_M = (f32(a) for a in (N, B_w, B_E, B_M))

    core = int_macro(
        N, H, L, k, B_w, B_M, lib, include_selection_mux=include_selection_mux
    )
    B_r = c.result_width(B_w, B_M, H)

    a_align = c.align_area(H, B_E, B_M, lib)
    a_convert = c.convert_area(N, B_w, B_E, B_r, lib)
    e_align = c.align_energy(H, B_E, B_M, lib)
    e_convert = c.convert_energy(N, B_w, B_E, B_r, lib)
    d_align = c.align_delay(H, B_E, B_M, lib)
    d_convert = c.convert_delay(B_E, B_r, lib)

    area = core.area + a_align + a_convert
    energy = core.energy + e_align + e_convert
    delay = torch.maximum(torch.maximum(d_align, core.delay), d_convert)
    thpt = N / B_w * f32(H) * 2.0 * (f32(k) / B_M) / delay

    return MacroCosts(
        area=area,
        delay=delay,
        energy=energy,
        throughput=thpt,
        sram_bits=core.sram_bits,
        area_sram=core.area_sram,
        area_mul=core.area_mul,
        area_tree=core.area_tree,
        area_accu=core.area_accu,
        area_fusion=core.area_fusion,
        area_align=torch.broadcast_to(a_align, area.shape),
        area_convert=torch.broadcast_to(a_convert, area.shape),
    )


def macro_costs(
    N, H, L, k, prec: Precision, lib: CellLibrary = TSMC28, **kw
) -> MacroCosts:
    """Dispatch on precision (INT -> Table V, FP -> Table VI)."""
    if prec.is_fp:
        return fp_macro(N, H, L, k, prec.B_w, prec.B_E, prec.B_M, lib, **kw)
    return int_macro(N, H, L, k, prec.B_w, prec.B_x, lib, **kw)


@dataclasses.dataclass
class PhysicalMetrics:
    area_mm2: torch.Tensor
    delay_ns: torch.Tensor
    energy_nJ: torch.Tensor      # per cycle, at the given activity
    freq_GHz: torch.Tensor
    power_mW: torch.Tensor
    tops: torch.Tensor
    tops_per_w: torch.Tensor
    tops_per_mm2: torch.Tensor


def physical(
    costs: MacroCosts,
    tech: TechParams = CALIBRATED,
    activity: float = 1.0,
) -> PhysicalMetrics:
    """Convert normalized costs to physical metrics.

    ``activity`` scales dynamic energy: the paper reports Fig. 8 at "10%
    sparsity", i.e. an input-activity factor of 0.1 on switching energy.
    """
    area_mm2 = tech.area_mm2(costs.area)
    delay_ns = tech.delay_ns(costs.delay)
    energy_nJ = tech.energy_nJ(costs.energy) * activity
    freq_GHz = 1.0 / torch.clamp_min(delay_ns, 1e-9)
    power_mW = energy_nJ * freq_GHz * 1e3           # nJ/cycle * Gcycle/s
    # throughput [ops/D_gate] -> ops/s: divide by D_gate seconds.
    ops = costs.throughput / (tech.D_gate_ps * 1e-12)
    tops = ops * 1e-12
    tops_per_w = tops / torch.clamp_min(power_mW * 1e-3, 1e-12)
    tops_per_mm2 = tops / torch.clamp_min(area_mm2, 1e-12)
    return PhysicalMetrics(
        area_mm2=area_mm2,
        delay_ns=delay_ns,
        energy_nJ=energy_nJ,
        freq_GHz=freq_GHz,
        power_mW=power_mW,
        tops=tops,
        tops_per_w=tops_per_w,
        tops_per_mm2=tops_per_mm2,
    )
