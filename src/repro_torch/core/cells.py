"""Standard-cell cost table (paper Table III) and physical calibration.

All area/delay/energy figures are *normalized to a NOR gate* of the
TSMC28 digital PDK, exactly as the paper does.  ``TechParams`` carries
the three physical scalars (A_gate, D_gate, E_gate) that convert
normalized costs to um^2 / ps / fJ; they are calibrated against the
paper's published anchor points in ``benchmarks/bench_calibration.py``
(the PDK itself is not available in this environment — see DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CellLibrary:
    """Table III — costs normalized to a NOR gate (A_gate/D_gate/E_gate)."""

    A_NOR: float = 1.0
    D_NOR: float = 1.0
    E_NOR: float = 1.0

    A_OR: float = 1.3
    D_OR: float = 1.0
    E_OR: float = 2.3

    A_MUX: float = 2.2
    D_MUX: float = 2.2
    E_MUX: float = 3.0

    A_HA: float = 4.3
    D_HA: float = 2.5
    E_HA: float = 6.9

    A_FA: float = 5.7
    D_FA: float = 3.3
    E_FA: float = 8.4

    A_DFF: float = 6.6
    E_DFF: float = 9.6          # DFF delay is N/A in the paper (pipelined)

    A_SRAM: float = 2.2         # 6T cell, hard-wired read: D = E = 0
    D_SRAM: float = 0.0
    E_SRAM: float = 0.0

    # Shifter delay model. The paper's Table II prints
    #   D_shift(N) = (log2 N) * D_sel(N)  ==  (log2 N)^2 * D_MUX
    # which double-counts the mux-tree depth of a barrel shifter whose
    # area is N * A_sel(N).  "as_printed" reproduces the paper;
    # "mux_tree" uses the physically-consistent D_sel(N).  (DESIGN.md §8.3)
    shifter_delay_model: str = "as_printed"


TSMC28 = CellLibrary()


@dataclasses.dataclass(frozen=True)
class TechParams:
    """Physical normalization constants for one technology node.

    Calibrated against the paper's anchors (DESIGN.md §7):
      * A_gate: INT8/8K-weight macro layout area = 0.079 mm^2 (Fig. 6a)
      * D_gate: 64K design-space average delays 1.2 ns (INT2) .. 10.9 ns
        (FP32) (Fig. 7c)
      * E_gate: design A (INT8, 64K) = 22 TOPS/W at 0.9 V, 10% activity
        (Fig. 8a)
    """

    name: str = "tsmc28-calibrated"
    # Fitted by benchmarks/bench_calibration.py against the paper's
    # anchors (Fig. 6a, Fig. 7c endpoints, design A TOPS/W); all other
    # published numbers are held-out validations — see EXPERIMENTS.md.
    A_gate_um2: float = 0.4260  # NOR2 footprint, um^2
    D_gate_ps: float = 33.46    # NOR2 prop delay, ps
    E_gate_fJ: float = 0.4282   # NOR2 switching energy, fJ
    voltage: float = 0.9        # supply used in the paper's Fig. 8

    def area_mm2(self, a_norm):
        """Normalized area -> mm^2."""
        return a_norm * self.A_gate_um2 * 1e-6

    def delay_ns(self, d_norm):
        """Normalized delay -> ns."""
        return d_norm * self.D_gate_ps * 1e-3

    def energy_nJ(self, e_norm):
        """Normalized per-cycle energy -> nJ."""
        return e_norm * self.E_gate_fJ * 1e-6

    def with_(self, **kw) -> "TechParams":
        return dataclasses.replace(self, **kw)


# Frozen calibration — fitted once by benchmarks/bench_calibration.py and
# then used for every EXPERIMENTS.md claim check.  See EXPERIMENTS.md §Repro.
CALIBRATED = TechParams()
