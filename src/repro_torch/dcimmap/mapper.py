"""Workload -> DCIM macro plan: run the SEGA-DCIM explorer against an
architecture's GEMM demand and produce a chip-level provisioning report.

This is the integration that makes the paper's compiler a first-class
feature of the framework: ``plan(arch_name, precision)`` extracts the
arch's MVM workloads, explores the (precision, W_store) space, distills
by the user constraint set, and reports macro count / total area / power
/ per-token latency for serving the whole model from DCIM.

``precision`` may be a single format or a list: multiple candidate
precisions (and optionally multiple ``w_store`` budgets) are explored in
ONE batched ``explore_multi`` call — one NSGA-II over the scenario
table, on ``device`` — and distillation then picks across the merged
INT+FP candidate set, exactly the paper's Fig. 4 flow.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import explorer, nsga2
from repro_torch.core.cells import CALIBRATED, TechParams
from repro_torch.core.precision import Precision
from repro_torch.sim.functional import DCIMMacroSim

from .workloads import ArchWorkload, extract


@dataclasses.dataclass
class MacroPlan:
    arch: str
    precision: str
    point: explorer.ParetoPoint
    n_macros: int
    total_area_mm2: float
    total_power_W: float
    macs_per_token: float
    token_latency_us: float
    tokens_per_s: float
    unmappable: List[str]

    def summary(self) -> str:
        return (
            f"{self.arch:<22} {self.precision:>5}: {self.n_macros:>6} macros"
            f" {self.total_area_mm2:9.1f} mm^2 {self.total_power_W:8.2f} W"
            f" {self.tokens_per_s:10.1f} tok/s"
        )


def plan(
    arch: str,
    precision: Union[str, Precision, Sequence] = "int8",
    w_store: Union[int, Sequence[int]] = 65536,
    cfg_nsga: Optional[nsga2.NSGA2Config] = None,
    tech: TechParams = CALIBRATED,
    activity: float = 0.1,
    max_area_mm2: Optional[float] = None,
    sort_by: str = "edp",
    device="cuda",
) -> MacroPlan:
    """Provision DCIM macros of one explored design for a whole arch.

    With a list of precisions (and/or ``w_store`` budgets) the full
    scenario cross-product runs as ONE batched NSGA-II; distillation
    then selects the winning design across the merged candidate set."""
    lmcfg = get_config(arch)
    wl: ArchWorkload = extract(lmcfg)

    if isinstance(precision, (str, Precision)):
        precisions = [precision]
    else:
        precisions = list(precision)
    if isinstance(w_store, (int, np.integer)):
        w_stores = [int(w_store)]
    else:
        w_stores = [int(w) for w in w_store]
    scenarios = [(p, w) for p in precisions for w in w_stores]
    pts = explorer.explore_multi(
        scenarios,
        cfg_nsga or nsga2.NSGA2Config(pop_size=96, generations=48),
        tech=tech, activity=activity, device=device,
    )
    pts = explorer.distill(pts, max_area_mm2=max_area_mm2, sort_by=sort_by)
    if not pts:
        raise ValueError("distillation removed every Pareto point")
    pt = pts[0]
    sim = DCIMMacroSim.from_point(pt, tech=tech, activity=activity)

    total_weights = wl.total_weights()
    n_macros = math.ceil(total_weights / sim.w_store)

    # Per-token latency: weights are resident (weight-stationary), each
    # GEMM (1, K) x (K, N) runs on its own macro slice; layers execute
    # sequentially, GEMMs inside a layer in parallel across macros.
    per_layer_us = 0.0
    for g in wl.gemms:
        acct = sim.account(1, g.K, g.N)
        # count instances serialized across layers, parallel across macros
        per_layer_us += acct["latency_us"] * g.count * g.activation / max(
            n_macros / max(len(wl.gemms), 1), 1.0
        )
    token_latency_us = per_layer_us
    power_W = pt.energy_nJ / max(pt.delay_ns, 1e-9) * n_macros

    return MacroPlan(
        arch=arch,
        precision=pt.precision,  # the distillation winner's format
        point=pt,
        n_macros=n_macros,
        total_area_mm2=pt.area_mm2 * n_macros,
        total_power_W=power_W,
        macs_per_token=wl.macs_per_token(),
        token_latency_us=token_latency_us,
        tokens_per_s=1e6 / max(token_latency_us, 1e-9),
        unmappable=wl.unmappable,
    )
