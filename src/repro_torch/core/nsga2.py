"""Batched NSGA-II (Deb et al. 2002) over the DCIM design space.

This is the paper's "MOGA-based design space explorer" core: 4 objectives
[A, D, E, -T], constrained domination for the storage-equality-derived
box violation, binary tournament selection, uniform crossover and
step/reset mutation on the integer log2 genome, (mu + lambda) elitist
survival.

Every tensor carries a leading scenario axis ``S``: :func:`run_batched`
evolves the populations of all scenarios of a :class:`ScenarioTable`
together, one Python loop over generations, each generation a fixed
sequence of batched tensor operations (the dominance matrix is the K1
kernel on the card).

Randomness is drawn from one ``torch.Generator`` on the table's device.
Each generation is split into *draw* (:func:`draw`: tournament indices,
crossover and mutation masks, steps, resets) and *apply*
(:func:`make_children`, :func:`survivors`), so a test can hand the apply
step the reference's own draws and objectives and compare a generation
exactly.  The port does not reproduce JAX's threefry bits: whole runs
are held to the brute-force oracle, not to the reference's trajectory.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from . import scenario as scen_mod
from .pareto import _lexsort, crowding_distance, non_dominated_sort, pareto_front_mask
from .scenario import N_GENES, ScenarioTable
from ..kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class NSGA2Config:
    pop_size: int = 128
    generations: int = 64
    p_crossover: float = 0.9
    p_mutate: float = 0.3
    p_step_mutate: float = 0.5   # fraction of mutations that are +/-1 steps
    seed: int = 0


@dataclasses.dataclass
class NSGA2Result:
    genes: np.ndarray        # (P, 3) final population
    objectives: np.ndarray   # (P, 4)
    violation: np.ndarray    # (P,)
    ranks: np.ndarray        # (P,)
    front_genes: np.ndarray  # (F, 3) deduped feasible rank-0 set
    front_objectives: np.ndarray  # (F, 4)


@dataclasses.dataclass
class Draws:
    """One generation's random numbers for S scenarios of P individuals."""

    ta_i: torch.Tensor      # (S, P) int64 — tournament candidates, parent a
    ta_j: torch.Tensor      # (S, P) int64
    tb_i: torch.Tensor      # (S, P) int64 — tournament candidates, parent b
    tb_j: torch.Tensor      # (S, P) int64
    do_x: torch.Tensor      # (S, P, 1) bool — crossover this child
    xmask: torch.Tensor     # (S, P, 3) bool — genes taken from parent b
    mmask: torch.Tensor     # (S, P, 3) bool — genes mutated
    step: torch.Tensor      # (S, P, 3) int32 in {-1, +1}
    reset: torch.Tensor     # (S, P, 3) int32 in [lo, hi]
    use_step: torch.Tensor  # (S, P, 3) bool — step (else reset) mutation


def _randint_box(gen: torch.Generator, lo: torch.Tensor, hi: torch.Tensor, P: int):
    """(S, P, 3) int32 uniform in [lo, hi] per scenario and gene."""
    S = lo.shape[0]
    span = (hi - lo + 1).to(torch.int64).unsqueeze(1)
    r = torch.randint(0, 1 << 30, (S, P, N_GENES), generator=gen, device=lo.device)
    return (lo.unsqueeze(1) + r % span).to(torch.int32)


def _bernoulli(gen: torch.Generator, p: float, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) < p


def draw(gen: torch.Generator, table: ScenarioTable, cfg: NSGA2Config) -> Draws:
    """Draw one generation's random numbers from ``gen``."""
    S, P, dev = len(table), cfg.pop_size, table.device

    def idx():
        return torch.randint(0, P, (S, P), generator=gen, device=dev)

    shape = (S, P, N_GENES)
    return Draws(
        ta_i=idx(), ta_j=idx(), tb_i=idx(), tb_j=idx(),
        do_x=_bernoulli(gen, cfg.p_crossover, (S, P, 1), dev),
        xmask=_bernoulli(gen, 0.5, shape, dev),
        mmask=_bernoulli(gen, cfg.p_mutate, shape, dev),
        step=(torch.randint(0, 2, shape, generator=gen, device=dev) * 2 - 1).to(torch.int32),
        reset=_randint_box(gen, table.gene_lo, table.gene_hi, P),
        use_step=_bernoulli(gen, cfg.p_step_mutate, shape, dev),
    )


def _rank_and_crowd(F, v):
    ranks = non_dominated_sort(F, v, dom=kops.dominance_matrix(F, v))
    return ranks, crowding_distance(F, ranks)


def _tournament(i, j, ranks, crowd):
    """Binary tournament between candidates i and j (S, n): lower rank
    wins, ties go to the larger crowding distance, else j."""
    ri, rj = torch.gather(ranks, 1, i), torch.gather(ranks, 1, j)
    ci, cj = torch.gather(crowd, 1, i), torch.gather(crowd, 1, j)
    better_i = (ri < rj) | ((ri == rj) & (ci > cj))
    return torch.where(better_i, i, j)


def _take(pop, idx):
    return torch.gather(pop, 1, idx.unsqueeze(-1).expand(-1, -1, pop.shape[-1]))


def make_children(pop, ranks, crowd, d: Draws, lo, hi):
    """pop (S, P, 3) -> children (S, P, 3) int32, given the draws."""
    pa = _take(pop, _tournament(d.ta_i, d.ta_j, ranks, crowd))
    pb = _take(pop, _tournament(d.tb_i, d.tb_j, ranks, crowd))
    child = torch.where(d.do_x & d.xmask, pb, pa)
    mutated = torch.where(d.use_step, child + d.step, d.reset)
    child = torch.where(d.mmask, mutated, child)
    lo, hi = lo.unsqueeze(1), hi.unsqueeze(1)
    return torch.minimum(torch.maximum(child, lo), hi).to(torch.int32)


def best_first(ranks, crowd):
    """Indices (S, n) ordering each population best first: by rank, then
    by crowding distance, largest first (infinite taken as 1e30), then by
    index: the reference's ``jnp.lexsort((-crowd_c, ranks))``.  Survival
    keeps the head of this order; island migration sends the head and
    overwrites the tail."""
    crowd_c = torch.where(torch.isinf(crowd), 1e30, crowd)
    return _lexsort(-crowd_c, ranks)


def survivors(F, v, comb, P: int):
    """(mu + lambda) survival: the P best of ``comb`` (S, 2P, 3) by rank,
    then by crowding distance.  Returns (indices (S, P), genes (S, P, 3))."""
    keep = best_first(*_rank_and_crowd(F, v))[:, :P]
    return keep, _take(comb, keep)


def make_step(table: ScenarioTable, cfg: NSGA2Config):
    """One NSGA-II generation for every scenario of ``table``:
    ``step(pop, F, v, draws) -> (pop, F, v, children)``, where ``F, v``
    are the objectives and violation of ``pop``.  The survivors'
    objectives are gathered from the evaluated parents+children (the
    evaluation is elementwise, so this equals evaluating them again)."""
    lo, hi = table.gene_lo, table.gene_hi

    def step(pop, F, v, d: Draws):
        ranks, crowd = _rank_and_crowd(F, v)
        children = make_children(pop, ranks, crowd, d, lo, hi)
        comb = torch.cat([pop, children], dim=1)
        Fc, vc = scen_mod.evaluate(table, comb)
        keep, pop = survivors(Fc, vc, comb, cfg.pop_size)
        F = _take(Fc, keep)
        v = torch.gather(vc, 1, keep)
        # Children are kept for the elitist archive: the returned front is
        # extracted from *every candidate ever evaluated*.
        return pop, F, v, children

    return step


def init_population(table: ScenarioTable, cfg: NSGA2Config, gen: torch.Generator):
    """(S, P, 3) int32 genomes uniform in each scenario's gene box."""
    return _randint_box(gen, table.gene_lo, table.gene_hi, cfg.pop_size)


def archive_fronts(table: ScenarioTable, archives: List[np.ndarray]):
    """Evaluate each scenario's deduplicated archive and mask its feasible
    Pareto front, all scenarios in one padded batch.  Padding rows are
    copies of row 0, so they change no real entry's domination status.
    Returns per scenario (F (n, 4), v (n,), mask (n,)) as numpy."""
    bucket = scen_mod._bucket(max(a.shape[0] for a in archives))
    padded = np.stack([scen_mod.pad_to_bucket(a, bucket)[0] for a in archives])
    genes = torch.as_tensor(padded, device=table.device)
    F, v = scen_mod.evaluate(table, genes)
    mask = pareto_front_mask(F, v) & (v <= 0.0)
    F, v, mask = (t.cpu().numpy() for t in (F, v, mask))
    return [
        (F[i, :n], v[i, :n], mask[i, :n])
        for i, n in enumerate(a.shape[0] for a in archives)
    ]


def run_batched(
    table: ScenarioTable, cfg: NSGA2Config = NSGA2Config()
) -> List[NSGA2Result]:
    """Evolve ALL scenarios of ``table`` together on the table's device.

    The front of each scenario is the feasible non-dominated subset of its
    *elitist archive* (every candidate ever evaluated), deduplicated — a
    design visited early and later crowded out is never lost."""
    gen = torch.Generator(device=table.device)
    gen.manual_seed(cfg.seed)
    pop = init_population(table, cfg, gen)
    F, v = scen_mod.evaluate(table, pop)
    step = make_step(table, cfg)
    visited = []
    for _ in range(cfg.generations):
        pop, F, v, children = step(pop, F, v, draw(gen, table, cfg))
        visited.append(children)
    ranks = non_dominated_sort(F, v, dom=kops.dominance_matrix(F, v))
    return results(table, pop, F, v, ranks, torch.cat(visited + [pop], dim=1))


def results(table: ScenarioTable, pop, F, v, ranks, archive) -> List[NSGA2Result]:
    """One ``NSGA2Result`` a scenario of ``table`` from its final
    population ``pop`` (S, n, 3) with their objectives, violations and
    ranks, and its elitist archive (S, m, 3): the front is the archive's
    deduplicated feasible non-dominated subset, evaluated afresh
    (:func:`archive_fronts`)."""
    pops, Fs, vs, ranks = (t.cpu().numpy() for t in (pop, F, v, ranks))
    arches = [np.unique(a, axis=0) for a in archive.cpu().numpy()]
    fronts = archive_fronts(table, arches)
    return [
        NSGA2Result(
            genes=pops[i],
            objectives=Fs[i],
            violation=vs[i],
            ranks=ranks[i].astype(np.int32),
            front_genes=arches[i][mask],
            front_objectives=aF[mask],
        )
        for i, (aF, _, mask) in enumerate(fronts)
    ]


def run(space, cfg: NSGA2Config = NSGA2Config(), device="cuda") -> NSGA2Result:
    """Run NSGA-II for one ``DesignSpace`` (a 1-scenario table)."""
    return run_batched(space.to_table(device), cfg)[0]


# ------------------------------ lint contract --------------------------------
from ..analysis.registry import Built, Replay, register_contract  # noqa: E402


@register_contract(
    "nsga2.run_batched",
    checks=("recompile", "transfers", "precision"),
    description="batched DSE at a tiny budget: two scenario tables with equal shapes but "
                "different contents must run ONE program shape (scenario parameters are "
                "data), every generation too; the pipeline must transfer only explicitly "
                "and wait on the device at most once per 8 fronts a sort (the peel's "
                "checks); the recorded run must hold f32 discipline (no f64 from "
                "python-float scenario parameters)",
)
def _build_nsga2_contract(device) -> Built:
    import math

    from ..analysis.op_trace import canonical_signature, record
    from ..analysis.registry import PrecisionPolicy

    global make_step
    cfg = NSGA2Config(pop_size=16, generations=4)
    t1 = ScenarioTable.from_specs([("int8", 16384), ("int4", 16384)], device=device)
    # Same static metadata as t1 (all-INT => any_fp/all_fp agree), so one
    # program shape must serve both tables.
    t2 = ScenarioTable.from_specs([("int16", 32768), ("int2", 16384)], device=device)

    signatures = []
    real = make_step

    def spy_make_step(table, c):
        step = real(table, c)

        def spied(pop, F, v, d):
            signatures.append(("step", canonical_signature((pop, F, v, d))))
            return step(pop, F, v, d)

        return spied

    make_step = spy_make_step
    try:
        for t in (t1, t2):
            signatures.append(("run_batched", canonical_signature(t)))
            run_batched(t, cfg)
    finally:
        make_step = real
    replay = Replay(signatures=signatures, max_programs={"run_batched": 1, "step": 1})

    def hot():
        return run_batched(t1, cfg)

    # A generation ranks its parents (P) and its parents + children (2P);
    # each peel checks its progress on the host once every 8 fronts
    # (core.pareto._PEEL_CHECK_EVERY), at most ceil(n / 8) times.  The
    # final ranking and the results (their copies to the host) count as
    # one more call.
    P = cfg.pop_size
    return Built(
        hot=hot, hot_label="run_batched pipeline", replay=replay,
        hot_calls=lambda: cfg.generations + 1,
        sync_budget=math.ceil(P / 8) + math.ceil(2 * P / 8),
        programs=[("run_batched", record(hot))],
        precision=PrecisionPolicy(compute_dtype="float32"),
    )
