"""The SEGA-DCIM design space (paper Eq. (2)/(3) + §IV bounds).

Design variables (all powers of two, as in the paper's experiments):

    N = B_w * 2^j   columns          (N > 4*B_w  =>  j >= 3)
    H = 2^h         column height    (H <= 2048)
    L = 2^l         weights / compute unit  (L <= 64)
    k = 2^kk        input bits per cycle    (k <= B_x)

The storage constraint  N*H*L = W_store*B_w  becomes linear in log2:
j + h + l = log2(W_store).  The genome is (j, h, kk); ``l`` is *derived*,
so the equality constraint is satisfied by construction and only the
box bound on l can be violated (handled by Deb's constrained-domination).
This also means the whole space is finitely enumerable, giving an exact
Pareto oracle to validate NSGA-II against.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from . import scenario as scenario_mod
from .cells import CellLibrary, TSMC28
from .macros import MacroCosts
from .precision import Precision
from .scenario import N_GENES, ScenarioTable  # noqa: F401  (re-export)


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    prec: Precision
    w_store: int
    h_min_log2: int = 1          # H >= 2
    h_max_log2: int = 11         # H <= 2048 (paper §IV)
    l_max_log2: int = 6          # L <= 64   (paper §IV)
    j_min: int = 3               # N > 4*B_w (paper §IV)
    lib: CellLibrary = TSMC28
    include_selection_mux: bool = False

    def __post_init__(self):
        if self.w_store & (self.w_store - 1):
            raise ValueError(f"W_store must be a power of two, got {self.w_store}")

    @property
    def s_log2(self) -> int:
        return int(math.log2(self.w_store))

    @property
    def j_max(self) -> int:
        # j + h + l = s with h >= h_min, l >= 0.
        return self.s_log2 - self.h_min_log2

    @property
    def kk_max(self) -> int:
        return int(math.floor(math.log2(self.prec.B_x)))

    @property
    def gene_lo(self) -> np.ndarray:
        return np.array([self.j_min, self.h_min_log2, 0], np.int32)

    @property
    def gene_hi(self) -> np.ndarray:
        return np.array([self.j_max, self.h_max_log2, self.kk_max], np.int32)

    # --- the scenario row: bridge into the batched pipeline ------------------
    def scenario(self, device="cuda") -> ScenarioTable:
        """This space as a 0-d-field :class:`ScenarioTable` row on
        ``device`` (cached per device: the space is frozen)."""
        dev = torch.device(device)
        rows = self.__dict__.setdefault("_rows", {})
        if dev not in rows:
            rows[dev] = self.to_table(dev).row(0)
        return rows[dev]

    def to_table(self, device="cuda") -> ScenarioTable:
        """This space as a 1-scenario table (leading axis kept)."""
        return scenario_mod.ScenarioTable.from_spaces([self], device=device)

    # --- decoding (on the device of ``genes``) ------------------------------
    def derived_l(self, genes: torch.Tensor) -> torch.Tensor:
        return scenario_mod.derived_l(self.scenario(genes.device), genes)

    def decode(self, genes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """genes (..., 3) int32 -> (N, H, L, k) float32 tensors.

        ``l`` is clamped into its box for cost evaluation; the true
        violation is reported separately by :meth:`violation`.
        """
        return scenario_mod.decode(self.scenario(genes.device), genes)

    def violation(self, genes: torch.Tensor) -> torch.Tensor:
        return scenario_mod.violation(self.scenario(genes.device), genes)

    # --- evaluation ----------------------------------------------------------
    def costs(self, genes: torch.Tensor) -> MacroCosts:
        return scenario_mod.costs(self.scenario(genes.device), genes)

    def evaluate(self, genes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """genes (..., 3) -> (objectives (..., 4) [A, D, E, -T], violation).

        Delegates to :func:`repro_torch.core.scenario.evaluate` — the single
        pipeline shared with the batched multi-scenario explorer."""
        return scenario_mod.evaluate(self.scenario(genes.device), genes)

    # --- exhaustive oracle ----------------------------------------------------
    def enumerate_feasible(self) -> np.ndarray:
        """All feasible genomes, shape (n, 3) — the exact-design-space oracle."""
        out = []
        for j in range(self.j_min, self.j_max + 1):
            for h in range(self.h_min_log2, self.h_max_log2 + 1):
                l = self.s_log2 - j - h
                if not (0 <= l <= self.l_max_log2):
                    continue
                for kk in range(0, self.kk_max + 1):
                    out.append((j, h, kk))
        if not out:
            raise ValueError(
                f"design space empty for {self.prec.name}, W_store={self.w_store}"
            )
        return np.asarray(out, np.int32)

    def describe(self, genes: np.ndarray) -> dict:
        """Human-readable design point for reports / the generator."""
        g = torch.as_tensor(np.asarray(genes, np.int32).reshape(3))
        N, H, L, k = (int(float(x)) for x in self.decode(g))
        return dict(
            precision=self.prec.name,
            w_store=self.w_store,
            N=N,
            H=H,
            L=L,
            k=k,
            B_w=self.prec.B_w,
            B_x=self.prec.B_x,
            B_E=self.prec.B_E,
            sram_bits=N * H * L,
        )
