"""MOGA-based design space explorer (paper Fig. 4, §III-B).

Drives NSGA-II across (precision, W_store) scenarios, merges the fronts
into one candidate set (optionally re-extracting the joint Pareto front,
as the paper's "Pareto set containing both integer and floating-point
solutions"), applies *user-defined distillation* (application
constraints), and hands selected points on (``sim.DCIMMacroSim``,
``dcimmap.plan``).

``explore_multi`` evolves all S scenarios together
(``nsga2.run_batched`` over one :class:`ScenarioTable`).  Also provides
the exhaustive brute-force oracle: the log2-linear storage constraint
makes the space finitely enumerable.  ``explore_multi(store=...)``
persists the merged front and its wall time in a
:class:`~repro_torch.core.results.ResultStore`, as the reference does.

The island-model NSGA-II (:func:`run_islands`, :func:`run_islands_multi`)
runs S scenarios x I islands as one batch of S * I populations through
the same batched generation step; ring migration is a roll along the
island axis, never across scenarios.  With ``mesh=`` (a ``DeviceMesh``
over a ``torch.distributed`` process group, one process a rank) the
scenarios are split in blocks over the scenario ranks and the islands
over the island ranks: each rank steps its own populations, the ring
crosses ranks by gathering the migrants over the island group, and every
rank ends with the whole, bitwise the one-process run's results.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve
from ..dist import collectives
from . import nsga2
from . import scenario as scen_mod
from .cells import CALIBRATED, CellLibrary, TechParams, TSMC28
from .macros import physical
from .pareto import pareto_front_mask
from .precision import Precision, get as get_precision
from .results import front_payload
from .scenario import N_GENES, ScenarioTable
from .space import DesignSpace


@dataclasses.dataclass
class ParetoPoint:
    """One explored design, fully described for reports and codegen."""

    precision: str
    w_store: int
    N: int
    H: int
    L: int
    k: int
    genes: np.ndarray
    # normalized costs
    area: float
    delay: float
    energy: float
    throughput: float
    # physical metrics (calibrated tech, activity applied)
    area_mm2: float
    delay_ns: float
    energy_nJ: float
    tops: float
    tops_per_w: float
    tops_per_mm2: float

    @property
    def objectives(self) -> np.ndarray:
        return np.array(
            [self.area, self.delay, self.energy, -self.throughput], np.float32
        )

    def summary(self) -> str:
        return (
            f"{self.precision:>5} W={self.w_store:>6} N={self.N:<5} H={self.H:<5}"
            f" L={self.L:<3} k={self.k:<2} | {self.area_mm2:8.4f} mm^2"
            f" {self.delay_ns:6.2f} ns {self.energy_nJ:8.4f} nJ"
            f" {self.tops:7.3f} TOPS {self.tops_per_w:8.2f} TOPS/W"
        )


def _points_from_genes(
    space: DesignSpace,
    genes: np.ndarray,
    tech: TechParams,
    activity: float,
    device,
) -> List[ParetoPoint]:
    if genes.size == 0:
        return []
    row = space.scenario(device)
    g = torch.as_tensor(np.asarray(genes, np.int32).reshape(-1, N_GENES), device=row.device)
    c = scen_mod.costs(row, g)
    phys = physical(c, tech, activity)
    N, H, L, k = (t.cpu().numpy() for t in scen_mod.decode(row, g))
    costs = {f: getattr(c, f).cpu().numpy() for f in ("area", "delay", "energy", "throughput")}
    ph = {f.name: getattr(phys, f.name).cpu().numpy() for f in dataclasses.fields(phys)}
    return [
        ParetoPoint(
            precision=space.prec.name,
            w_store=space.w_store,
            N=int(N[i]),
            H=int(H[i]),
            L=int(L[i]),
            k=int(k[i]),
            genes=np.asarray(genes[i]),
            area=float(costs["area"][i]),
            delay=float(costs["delay"][i]),
            energy=float(costs["energy"][i]),
            throughput=float(costs["throughput"][i]),
            area_mm2=float(ph["area_mm2"][i]),
            delay_ns=float(ph["delay_ns"][i]),
            energy_nJ=float(ph["energy_nJ"][i]),
            tops=float(ph["tops"][i]),
            tops_per_w=float(ph["tops_per_w"][i]),
            tops_per_mm2=float(ph["tops_per_mm2"][i]),
        )
        for i in range(genes.shape[0])
    ]


def _normalize_scenarios(scenarios: Sequence[tuple]) -> List[tuple]:
    return [
        (get_precision(prec) if isinstance(prec, str) else prec, w)
        for prec, w in scenarios
    ]


def brute_force_front(space: DesignSpace, device="cuda") -> np.ndarray:
    """Exact Pareto-optimal genomes by full enumeration (the oracle).

    Routed through the same evaluate+front code as the NSGA-II archive
    extraction (``enumerate_feasible`` only yields zero-violation genomes,
    so the feasibility mask is a no-op here)."""
    genes = space.enumerate_feasible()
    table = space.to_table(resolve(device))
    (_, _, mask), = nsga2.archive_fronts(table, [genes])
    return genes[mask]


def explore(
    precision: str | Precision,
    w_store: int,
    cfg: nsga2.NSGA2Config = nsga2.NSGA2Config(),
    lib: CellLibrary = TSMC28,
    tech: TechParams = CALIBRATED,
    activity: float = 1.0,
    method: str = "nsga2",
    include_selection_mux: bool = False,
    device="cuda",
) -> List[ParetoPoint]:
    """Explore one (precision, W_store) scenario; returns its Pareto set.

    ``method``: ``"nsga2"`` or ``"brute"`` (exhaustive oracle).
    """
    dev = resolve(device)
    prec = get_precision(precision) if isinstance(precision, str) else precision
    space = DesignSpace(
        prec=prec, w_store=w_store, lib=lib,
        include_selection_mux=include_selection_mux,
    )
    if method == "brute":
        fg = brute_force_front(space, dev)
    elif method == "nsga2":
        fg = nsga2.run(space, cfg, dev).front_genes
    else:
        raise ValueError(f"unknown method {method!r}")
    return _points_from_genes(space, fg, tech, activity, dev)


def explore_multi(
    scenarios: Sequence[tuple],
    cfg: nsga2.NSGA2Config = nsga2.NSGA2Config(),
    cross_dominate: bool = False,
    lib: CellLibrary = TSMC28,
    tech: TechParams = CALIBRATED,
    activity: float = 1.0,
    method: str = "nsga2",
    include_selection_mux: bool = False,
    device="cuda",
    store=None,
    record_name: str = "explore_multi",
) -> List[ParetoPoint]:
    """Union of per-scenario fronts — the paper's merged INT+FP candidate
    set handed to user distillation.

    ``scenarios`` is a list of (precision, w_store); with ``method="nsga2"``
    all of them evolve together (``nsga2.run_batched``), with
    ``method="brute"`` each front is the exhaustive oracle's.

    By default points of different precisions do NOT dominate each other
    (an INT8 design is not a functional substitute for a BF16 one; the
    paper's distillation step picks by application).
    ``cross_dominate=True`` re-reduces the union to a single joint front
    instead.

    ``store`` may be a :class:`repro_torch.core.results.ResultStore`; the
    merged front and wall-time are then persisted under ``record_name``.
    """
    t0 = time.perf_counter()
    dev = resolve(device)
    specs = _normalize_scenarios(scenarios)
    spaces = [
        DesignSpace(prec=p, w_store=w, lib=lib,
                    include_selection_mux=include_selection_mux)
        for p, w in specs
    ]
    if method == "nsga2" and spaces:
        table = ScenarioTable.from_spaces(spaces, device=dev)
        fronts = [r.front_genes for r in nsga2.run_batched(table, cfg)]
    elif method == "brute":
        fronts = [brute_force_front(sp, dev) for sp in spaces]
    else:
        raise ValueError(f"unknown method {method!r}")
    pts: List[ParetoPoint] = []
    for space, fg in zip(spaces, fronts):
        pts.extend(_points_from_genes(space, fg, tech, activity, dev))
    if pts and cross_dominate:
        F = torch.as_tensor(np.stack([p.objectives for p in pts]), device=dev)
        mask = pareto_front_mask(F).cpu().numpy()
        pts = [p for p, m in zip(pts, mask) if m]
    if store is not None:
        payload = front_payload(pts)
        payload["scenarios"] = [(p.name, w) for p, w in specs]
        payload["batched"] = method == "nsga2"   # the port evolves scenarios together
        payload["cross_dominate"] = cross_dominate
        store.put(record_name, payload, kind="dse",
                  wall_s=time.perf_counter() - t0)
    return pts


def distill(
    points: Sequence[ParetoPoint],
    max_area_mm2: Optional[float] = None,
    max_power_mW: Optional[float] = None,
    max_delay_ns: Optional[float] = None,
    min_tops: Optional[float] = None,
    min_tops_per_w: Optional[float] = None,
    top: Optional[int] = None,
    sort_by: str = "edp",
) -> List[ParetoPoint]:
    """User-defined distillation (paper Fig. 4): filter the Pareto set by
    application constraints, then rank by a scalar figure of merit."""
    sel = []
    for p in points:
        power_mW = p.energy_nJ / max(p.delay_ns, 1e-12) * 1e3
        if max_area_mm2 is not None and p.area_mm2 > max_area_mm2:
            continue
        if max_power_mW is not None and power_mW > max_power_mW:
            continue
        if max_delay_ns is not None and p.delay_ns > max_delay_ns:
            continue
        if min_tops is not None and p.tops < min_tops:
            continue
        if min_tops_per_w is not None and p.tops_per_w < min_tops_per_w:
            continue
        sel.append(p)
    keyfns = {
        "edp": lambda p: p.energy_nJ * p.delay_ns,
        "area": lambda p: p.area_mm2,
        "delay": lambda p: p.delay_ns,
        "energy": lambda p: p.energy_nJ,
        "tops": lambda p: -p.tops,
        "tops_per_w": lambda p: -p.tops_per_w,
    }
    sel.sort(key=keyfns[sort_by])
    return sel[:top] if top else sel


# --------------------------------------------------------------------------
# Island-model NSGA-II: S scenarios x I islands as one batch of populations.
# --------------------------------------------------------------------------
def migrate(pop, F, v, n_islands: int, n_migrants: int, group=None):
    """One ring migration over populations laid out scenario-major,
    ``pop`` (S * I, P, 3) with objectives ``F`` (S * I, P, 4) and
    violations ``v`` (S * I, P): each island's ``n_migrants`` best by
    (rank, -crowding) (``nsga2.best_first``) replace the ``n_migrants``
    worst of island (i + 1) mod I of the same scenario, as the reference's
    ``lax.ppermute`` ring does.  The migrants' objectives and violations
    travel with them.  With ``group`` (the island ranks, each holding
    ``n_islands`` consecutive islands of the ring) the first island of
    each rank receives the last island's of the rank before, gathered
    over ``group``: only the migrants move.  Returns (pop, F, v)."""
    SI, P = pop.shape[:2]
    if not 0 < n_migrants <= P:
        raise ValueError(f"n_migrants must lie in [1, {P}], got {n_migrants}")
    order = nsga2.best_first(*nsga2._rank_and_crowd(F, v))
    best, worst = order[:, :n_migrants], order[:, P - n_migrants:]
    ranks = 1 if group is None else dist.get_world_size(group)

    def arrive(x):
        """Rows (S * I, m, ...) of the sending islands -> the rows each
        island receives: island i's from island i - 1."""
        ring = x.reshape(SI // n_islands, n_islands, *x.shape[1:])
        got = torch.roll(ring, 1, dims=1)
        if ranks > 1:
            last = collectives.all_gather(ring[:, -1:], 1, group)
            got[:, 0] = last[:, (dist.get_rank(group) - 1) % ranks]
        return got.reshape(x.shape)

    def put(x):
        def rows(i):
            return i if x.dim() == 2 else i[..., None].expand(-1, -1, x.shape[-1])
        return x.scatter(1, rows(worst), arrive(torch.gather(x, 1, rows(best))))

    return put(pop), put(F), put(v)


def island_table(table: ScenarioTable, n_islands: int, dev) -> ScenarioTable:
    """``table``'s rows each repeated ``n_islands`` times, scenario-major,
    on ``dev``."""
    return dataclasses.replace(table, **{
        f: getattr(table, f).repeat_interleave(n_islands, dim=0).to(dev)
        for f in scen_mod.DATA_FIELDS
    })


def _mesh_axis(mesh, name: Optional[str]):
    """(size, this rank's index, process group) of ``mesh``'s dim
    ``name``; (1, 0, None) for ``name=None``."""
    if name is None:
        return 1, 0, None
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no {name!r} dim (its dims: {mesh.mesh_dim_names})")
    return mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name), \
        mesh.get_group(name)


def _gather_blocks(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` (S_loc, I_loc, ...) of every rank, gathered over the island
    group along dim 1, then over the scenario group along dim 0."""
    for dim, group in ((1, groups[1]), (0, groups[0])):
        if group is not None:
            x = collectives.all_gather(x, dim, group)
    return x


def run_islands_multi(
    scenarios: Sequence[tuple] | ScenarioTable,
    cfg: nsga2.NSGA2Config = nsga2.NSGA2Config(),
    n_islands: int = 4,
    rounds: int = 4,
    gens_per_round: int = 16,
    n_migrants: int = 8,
    device="cuda",
    mesh=None,
    scenario_axis: Optional[str] = "scenario",
    island_axis: str = "island",
) -> List[nsga2.NSGA2Result]:
    """Island-model NSGA-II over S scenarios, ``n_islands`` islands each.

    Every round, each island runs ``gens_per_round`` generations, then its
    best ``n_migrants`` replace the worst of the next island along a ring
    (:func:`migrate`); migration never crosses scenarios.  The run is
    ``rounds x gens_per_round`` generations (``cfg.generations`` is not
    used), all S x I populations drawn from one ``torch.Generator``
    seeded with ``cfg.seed``.  Per scenario the result pools the islands'
    final populations, (I * P, 3), with ranks 0 on their front and 1
    elsewhere; its front is the feasible non-dominated subset of every
    island's archive (every child of every generation, and the final
    populations), deduplicated and evaluated afresh.

    ``mesh``, a ``DeviceMesh`` with the dims ``scenario_axis`` and
    ``island_axis`` over an initialized process group (one process a
    rank, each on ``device``), splits the run as the reference's
    ``shard_map`` does: the scenarios in contiguous blocks over the
    scenario ranks (S must divide by them; ``scenario_axis=None``: every
    rank holds every scenario), the islands in contiguous blocks over the
    island ranks (``n_islands`` must divide by them; one island a rank is
    the reference's layout).  Every rank draws the whole batch's random
    numbers from the one generator and keeps its rows, evaluates and
    steps only its populations, and sends only its last island's migrants
    around the ring (:func:`migrate`).  The final populations and
    archives are then gathered over both dims, and every rank returns
    the whole list of S results, bitwise the one-process run's on the
    same device type.
    """
    dev = resolve(device)
    if isinstance(scenarios, ScenarioTable):
        table = island_table(scenarios, 1, dev)
    else:
        table = ScenarioTable.from_specs(_normalize_scenarios(scenarios), device=dev)
    S, I = len(table), n_islands
    islands = island_table(table, I, dev)
    s_n, s_r, s_group = 1, 0, None
    i_n, i_r, i_group = 1, 0, None
    if mesh is not None:
        if not dist.is_initialized():
            raise RuntimeError("run_islands_multi(mesh=) needs an initialized "
                               "torch.distributed process group")
        s_n, s_r, s_group = _mesh_axis(mesh, scenario_axis)
        i_n, i_r, i_group = _mesh_axis(mesh, island_axis)
        if S % s_n:
            raise ValueError(f"{S} scenarios not divisible by scenario mesh axis {s_n}")
        if I % i_n:
            raise ValueError(f"{I} islands not divisible by island mesh axis {i_n}")
    S_loc, I_loc = S // s_n, I // i_n
    rows = ((torch.arange(s_r * S_loc, (s_r + 1) * S_loc)[:, None] * I
             + torch.arange(i_r * I_loc, (i_r + 1) * I_loc)).reshape(-1).to(dev))
    local = islands if mesh is None else dataclasses.replace(islands, **{
        f: getattr(islands, f)[rows] for f in scen_mod.DATA_FIELDS})

    def mine(x):
        return x if mesh is None else x[rows]

    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    pop = mine(nsga2.init_population(islands, cfg, gen))
    F, v = scen_mod.evaluate(local, pop)
    step = nsga2.make_step(local, cfg)
    visited = []
    for _ in range(rounds):
        for _ in range(gens_per_round):
            d = nsga2.draw(gen, islands, cfg)
            d = nsga2.Draws(**{f.name: mine(getattr(d, f.name))
                               for f in dataclasses.fields(d)})
            pop, F, v, children = step(pop, F, v, d)
            visited.append(children)
        pop, F, v = migrate(pop, F, v, I_loc, n_migrants, i_group)
    archive = torch.cat(visited + [pop], dim=1)
    pop, F, v, archive = (_gather_blocks(x.reshape(S_loc, I_loc, *x.shape[1:]),
                                         (s_group, i_group)).reshape(S, -1, *x.shape[2:])
                          for x in (pop, F, v, archive))
    ranks = (~pareto_front_mask(F, v)).to(torch.int32)
    return nsga2.results(table, pop, F, v, ranks, archive)


def run_islands(
    space: DesignSpace,
    cfg: nsga2.NSGA2Config = nsga2.NSGA2Config(),
    n_islands: int = 4,
    rounds: int = 4,
    gens_per_round: int = 16,
    n_migrants: int = 8,
    device="cuda",
    mesh=None,
    axis: str = "data",
) -> nsga2.NSGA2Result:
    """:func:`run_islands_multi` for one ``DesignSpace``; with ``mesh``
    the islands are split over its dim ``axis`` (the mesh's other dims
    hold replicas, each computing the same run)."""
    return run_islands_multi(space.to_table(resolve(device)), cfg, n_islands, rounds,
                             gens_per_round, n_migrants, device, mesh=mesh,
                             scenario_axis=None, island_axis=axis)[0]


def timed_explore(precision: str, w_store: int, cfg=None, device="cuda") -> dict:
    """DSE wall-time probe for the paper's '30 minutes per scenario' claim
    (host clock around a run that ends with its results on the host)."""
    cfg = cfg or nsga2.NSGA2Config()
    t0 = time.perf_counter()
    pts = explore(precision, w_store, cfg, device=device)
    t1 = time.perf_counter()
    return dict(
        precision=precision,
        w_store=w_store,
        seconds=t1 - t0,
        front_size=len(pts),
    )
