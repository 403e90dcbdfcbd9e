"""Pareto utilities: dominance, non-dominated sorting, crowding, hypervolume.

Implements Eq. (1) of the paper (Pareto dominance in a minimization
context) plus Deb's constrained-domination rule used by the NSGA-II
explorer.  Every function takes an optional leading scenario axis:
``F`` is ``(P, M)`` or ``(S, P, M)``, and the outputs follow.  On a CUDA
tensor the O(P^2 M) dominance matrix comes from the hand-written kernel
(``kernels.ops.dominance_matrix``); on a CPU tensor from its plain
version — the two are bitwise equal (checked on the card by
``chip_smoke.py``).
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops

# How many fronts the peeling loop assigns between host-side completion
# checks.  Extra iterations change nothing: an empty front assigns no rank.
_PEEL_CHECK_EVERY = 8


def _sanitize(F: torch.Tensor) -> torch.Tensor:
    """Replace NaN with +inf so broken candidates lose every comparison."""
    return torch.where(torch.isnan(F), torch.inf, F)


def dominates(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Eq. (1): u pareto-dominates v (minimization), broadcasting on the
    leading axes; objectives are on the last axis."""
    le = torch.all(u <= v, dim=-1)
    lt = torch.any(u < v, dim=-1)
    return le & lt


def dominance_matrix(F: torch.Tensor, violation: torch.Tensor | None = None) -> torch.Tensor:
    """D[..., i, j] == True iff candidate i (constrained-)dominates j.

    Constrained domination (Deb 2002): a feasible point dominates any
    infeasible point; among infeasible points, smaller total violation
    dominates; among feasible points, plain Pareto dominance applies.
    """
    return kops.dominance_matrix(F, violation)


def pareto_front_mask(F: torch.Tensor, violation: torch.Tensor | None = None) -> torch.Tensor:
    """Boolean mask of globally non-dominated candidates."""
    return ~torch.any(dominance_matrix(F, violation), dim=-2)


def non_dominated_sort(
    F: torch.Tensor,
    violation: torch.Tensor | None = None,
    dom: torch.Tensor | None = None,
) -> torch.Tensor:
    """Front ranks (0 = best, int64) by iterative peeling of the
    dominance matrix.  ``dom`` may be supplied to skip building it."""
    P = F.shape[-2]
    D = dominance_matrix(F, violation) if dom is None else dom
    ranks = torch.full(F.shape[:-1], P, dtype=torch.int64, device=F.device)
    r = 0
    while r < P:
        for _ in range(min(_PEEL_CHECK_EVERY, P - r)):
            unassigned = ranks >= P
            dom_cnt = torch.sum(D & unassigned.unsqueeze(-1), dim=-2)
            front = unassigned & (dom_cnt == 0)
            ranks = torch.where(front, r, ranks)
            r += 1
        if not bool(torch.any(ranks >= P)):
            break
    return ranks


def crowding_distance(F: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """NSGA-II crowding distance, computed per front (objective ranges are
    normalized within each front).  Boundary points get +inf."""
    batched = F.dim() == 3
    if not batched:
        F, ranks = F.unsqueeze(0), ranks.unsqueeze(0)
    F = _sanitize(F)
    S, P, M = F.shape
    ranks = ranks.to(torch.int64)
    # Per-front objective ranges via segment reductions keyed by rank.
    idx = ranks.unsqueeze(-1).expand(S, P, M)
    fmin = torch.zeros_like(F).scatter_reduce(1, idx, F, "amin", include_self=False)
    fmax = torch.zeros_like(F).scatter_reduce(1, idx, F, "amax", include_self=False)
    rng = torch.clamp_min(torch.gather(fmax - fmin, 1, idx), 1e-12)   # (S, P, M)

    pos = torch.arange(P, device=F.device)
    d = torch.zeros((S, P), dtype=torch.float32, device=F.device)
    for mth in range(M):
        order = _lexsort(F[..., mth], ranks)
        f_s = torch.gather(F[..., mth], 1, order)
        r_s = torch.gather(ranks, 1, order)
        same_prev = (torch.roll(r_s, 1, dims=1) == r_s) & (pos > 0)
        same_next = (torch.roll(r_s, -1, dims=1) == r_s) & (pos < P - 1)
        gap = torch.roll(f_s, -1, dims=1) - torch.roll(f_s, 1, dims=1)
        contrib = torch.where(
            same_prev & same_next,
            gap / torch.gather(rng[..., mth], 1, order),
            torch.inf,
        )
        # ``order`` is a permutation, so this adds each entry exactly once.
        d = d.scatter_add(1, order, contrib)
    return d if batched else d[0]


def _lexsort(secondary: torch.Tensor, primary: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((secondary, primary))`` along the last axis: order by
    ``primary``, ties by ``secondary``, remaining ties by index — two
    stable sorts."""
    o1 = torch.sort(secondary, dim=-1, stable=True).indices
    o2 = torch.sort(torch.gather(primary, -1, o1), dim=-1, stable=True).indices
    return torch.gather(o1, -1, o2)


def hypervolume_mc(
    F: torch.Tensor,
    ref: torch.Tensor,
    generator: torch.Generator,
    n_samples: int = 200_000,
) -> torch.Tensor:
    """Monte-Carlo hypervolume (minimization, w.r.t. reference point ``ref``).

    Used as a front-quality metric when comparing NSGA-II to the
    brute-force oracle; exact HV in 4D is unnecessary for that purpose.
    """
    F = _sanitize(F)
    lo = torch.min(F, dim=0).values
    box = torch.clamp_min(ref - lo, 1e-12)
    u = torch.rand((n_samples, F.shape[-1]), generator=generator, device=F.device)
    pts = lo + u * box
    dominated = torch.any(torch.all(F[None, :, :] <= pts[:, None, :], dim=-1), dim=1)
    return torch.mean(dominated.float()) * torch.prod(box)
