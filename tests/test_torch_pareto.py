"""Parity of the port's Pareto utilities with the JAX reference.

The port's plain dominance (what a CPU tensor runs) must equal the
Pallas kernel run in interpret mode bitwise — NaN, +-inf, violations,
P not a multiple of the kernel's tiles, and a scenario batch included.
Ranks, crowding distances and front masks must be bitwise equal given
the reference's own objectives as input.  A numpy emulation of the card
kernel's work split (j-chunks, 16-wide packing, ragged tails) is held to
the Pallas kernel too.
"""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro.core import pareto as jpareto
from repro.core import precision as jprec
from repro.core import space as jspace
from repro.kernels.pareto_rank import dominance_matrix_pallas
from repro_torch.core import pareto as tpareto
from repro_torch.kernels import cuda_lib, ops, pareto_rank, ref


def _objectives(rng, S, P, M=4, special=True):
    F = np.round(rng.normal(size=(S, P, M)), 1).astype(np.float32)  # ties
    if special:
        F[rng.random((S, P, M)) < 0.03] = np.nan
        F[rng.random((S, P, M)) < 0.03] = np.inf
        F[rng.random((S, P, M)) < 0.03] = -np.inf
    F[:, -1] = F[:, 0]            # a duplicate row
    v = np.where(rng.random((S, P)) < 0.3, rng.random((S, P)), 0.0).astype(np.float32)
    v[:, 1:3] = 0.5               # tied violations
    return F, v


@pytest.mark.parametrize("P", [1, 5, 33, 130, 257])
@pytest.mark.parametrize("with_v", [True, False])
def test_plain_dominance_matches_pallas_interpret(P, with_v):
    rng = np.random.default_rng(P)
    F, v = _objectives(rng, 2, P)
    got = ops.dominance_matrix(torch.from_numpy(F), torch.from_numpy(v) if with_v else None)
    assert got.dtype == torch.bool and got.shape == (2, P, P)
    for s in range(2):
        want = np.asarray(dominance_matrix_pallas(
            jnp.asarray(F[s]), jnp.asarray(v[s]) if with_v else None, interpret=True
        )).astype(bool)
        np.testing.assert_array_equal(got[s].numpy(), want)
        unb = ops.dominance_matrix(torch.from_numpy(F[s]),
                                   torch.from_numpy(v[s]) if with_v else None)
        np.testing.assert_array_equal(unb.numpy(), want)


def _spread4(n):
    """Four mask bits -> four bytes of 0/1 in a little-endian word."""
    return (n & 1) | ((n & 2) << 7) | ((n & 4) << 14) | ((n & 8) << 21)


def _tiled_dominance(F, v, jc=None):
    """The card kernel's work split (``plan``'s geometry; ``jc`` overrides
    its chunk): each scenario's rows staged jc at a time with NaN as +inf
    (rows of a chunk past P hold garbage; where ``plan`` stages v alone,
    F[j] is read from F itself, rows past the chunk's as its last row's,
    and NaN turned into +inf on each read); the lanes of row i take the
    4 * wj slots of 16 consecutive j, slot t from j0 = 16 t on in steps of
    64 wj, into a 16-bit mask; written as 16 little-endian bytes where
    P % 16 == 0, else byte by byte up to P.  Unwritten outputs keep a
    sentinel."""
    S, P, M = F.shape
    jc_plan, wj, stage_f = pareto_rank.plan(P, M)
    jc = jc or jc_plan
    garbage = np.random.default_rng(99)
    out = np.full((S, P, P), 7, np.uint8)
    vv = np.zeros((S, P), np.float32) if v is None else v
    for s in range(S):
        Fi = np.where(np.isnan(F[s]), np.inf, F[s])
        for c0 in range(0, P, jc):
            rows = min(jc, P - c0)
            sF = garbage.normal(size=(jc, M)).astype(np.float32)
            sv = garbage.normal(size=jc).astype(np.float32)
            sF[:rows] = Fi[c0:c0 + rows]
            sv[:rows] = vv[s, c0:c0 + rows]
            for slot in range(4 * wj):
                for j0 in range(c0 + 16 * slot, c0 + rows, 64 * wj):
                    bits = np.zeros(P, np.uint32)
                    for q in range(16):
                        jl = j0 - c0 + q
                        b = sF[jl] if stage_f else Fi[c0 + min(jl, rows - 1)]
                        vj = sv[jl]
                        le = np.all(Fi <= b, axis=1)
                        lt = np.any(Fi < b, axis=1)
                        d = ((vv[s] <= 0) & (vj <= 0) & le & lt) | (vv[s] < vj)
                        bits |= d.astype(np.uint32) << q
                    if P % 16 == 0:
                        words = np.stack([_spread4((bits >> (4 * w)) & 0xF) for w in range(4)], 1)
                        out[s, :, j0:j0 + 16] = words.astype("<u4").view(np.uint8)
                    else:
                        for q in range(min(16, P - j0)):
                            out[s, :, j0 + q] = (bits >> q) & 1
    return out.view(bool)


@pytest.mark.parametrize("P", [1, 15, 16, 17, 48, 130, 256])
@pytest.mark.parametrize("M", [1, 4, 5])
@pytest.mark.parametrize("with_v", [True, False])
def test_dominance_tile_walk(P, M, with_v):
    """The kernel's j-chunks (plan's, and 16 rows to force several), its
    16-wide little-endian packing and its ragged tails, bitwise against
    the Pallas kernel in interpret mode."""
    F, v = _objectives(np.random.default_rng(P * M), 2, P, M)
    v = v if with_v else None
    for s in range(2):
        want = np.asarray(dominance_matrix_pallas(
            jnp.asarray(F[s]), None if v is None else jnp.asarray(v[s]), interpret=True)).astype(bool)
        for jc in (None, 16):
            np.testing.assert_array_equal(_tiled_dominance(F, v, jc)[s], want)


@pytest.mark.parametrize("P", [17, 48])
@pytest.mark.parametrize("M", [0, 600])
@pytest.mark.parametrize("with_v", [True, False])
def test_dominance_tile_walk_any_M(P, M, with_v):
    """M = 0 (no objectives: D is v_i < v_j) and M = 600 (too wide to
    stage: v alone goes through shared memory, F[j] is read in place),
    bitwise against the Pallas kernel in interpret mode, and at M = 0,
    where its blocks divide by zero, against the JAX package's plain
    dominance."""
    assert pareto_rank.plan(P, M)[2] == (M == 0)
    F, v = _objectives(np.random.default_rng(P + M), 2, P, M)
    v = v if with_v else None
    for s in range(2):
        vs = None if v is None else jnp.asarray(v[s])
        if M:
            want = dominance_matrix_pallas(jnp.asarray(F[s]), vs, interpret=True)
        else:
            want = jpareto.dominance_matrix(jnp.asarray(F[s]), vs)
        want = np.asarray(want).astype(bool)
        for jc in (None, 16):
            np.testing.assert_array_equal(_tiled_dominance(F, v, jc)[s], want)
        np.testing.assert_array_equal(
            ref.dominance_matrix_ref(torch.from_numpy(F[s]),
                                     None if v is None else torch.from_numpy(v[s])).numpy(), want)


def test_cpu_dominance_never_launches_a_kernel():
    before = dict(cuda_lib.launches)
    F, v = _objectives(np.random.default_rng(0), 3, 17)
    out = ops.dominance_matrix(torch.from_numpy(F), torch.from_numpy(v))
    np.testing.assert_array_equal(
        out.numpy(), ref.dominance_matrix_ref(torch.from_numpy(F), torch.from_numpy(v)).numpy()
    )
    assert cuda_lib.launches == before


def _jax_objectives(prec, w_store, P, seed):
    """Objectives of random genomes (feasible and not) from the JAX cost
    model: realistic ties and duplicates."""
    sp = jspace.DesignSpace(jprec.get(prec), w_store)
    rng = np.random.default_rng(seed)
    genes = rng.integers(sp.gene_lo - 1, sp.gene_hi + 2, size=(P, 3)).astype(np.int32)
    F, v = sp.evaluate(jnp.asarray(genes))
    return np.array(F), np.array(v)


# One population size (the survivor step's 2 x 128), so the reference
# compiles its sort once for all cases.
CASES = [("int8", 16384, 256, 0), ("bf16", 65536, 256, 1), ("fp32", 4096, 256, 2),
         ("int2", 16384, 256, 3)]


@pytest.mark.parametrize("prec,w_store,P,seed", CASES)
def test_sort_crowding_front_match_reference(prec, w_store, P, seed):
    F, v = _jax_objectives(prec, w_store, P, seed)
    Fj, vj = jnp.asarray(F), jnp.asarray(v)
    Ft, vt = torch.from_numpy(F), torch.from_numpy(v)

    rj = np.asarray(jpareto.non_dominated_sort(Fj, vj))
    rt = tpareto.non_dominated_sort(Ft, vt)
    np.testing.assert_array_equal(rt.numpy(), rj)
    np.testing.assert_array_equal(
        tpareto.crowding_distance(Ft, rt).numpy(),
        np.asarray(jpareto.crowding_distance(Fj, jnp.asarray(rj))),
    )
    np.testing.assert_array_equal(tpareto.pareto_front_mask(Ft, vt).numpy(),
                                  np.asarray(jpareto.pareto_front_mask(Fj, vj)))
    np.testing.assert_array_equal(tpareto.pareto_front_mask(Ft).numpy(),
                                  np.asarray(jpareto.pareto_front_mask(Fj)))


def test_batched_sort_and_crowding_match_per_scenario_reference():
    """A scenario batch (S, P, M) gives each scenario's reference result,
    including objectives with NaN and +-inf."""
    rng = np.random.default_rng(7)
    F, v = _objectives(rng, 3, 256)
    Ft, vt = torch.from_numpy(F), torch.from_numpy(v)
    rt = tpareto.non_dominated_sort(Ft, vt)
    ct = tpareto.crowding_distance(Ft, rt)
    for s in range(3):
        rj = np.asarray(jpareto.non_dominated_sort(jnp.asarray(F[s]), jnp.asarray(v[s])))
        np.testing.assert_array_equal(rt[s].numpy(), rj)
        np.testing.assert_array_equal(
            ct[s].numpy(), np.asarray(jpareto.crowding_distance(jnp.asarray(F[s]), jnp.asarray(rj)))
        )


def test_dominates_and_hypervolume():
    rng = np.random.default_rng(4)
    u = rng.normal(size=(20, 4)).astype(np.float32)
    w = rng.normal(size=(20, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tpareto.dominates(torch.from_numpy(u), torch.from_numpy(w)).numpy(),
        np.asarray(jpareto.dominates(jnp.asarray(u), jnp.asarray(w))),
    )
    # Same Monte-Carlo estimator; different random streams, so compare
    # the estimate with the exact value (unit box: HV 1).
    g = torch.Generator().manual_seed(0)
    hv = tpareto.hypervolume_mc(torch.zeros((1, 2)), torch.ones(2), g, n_samples=20000)
    assert float(hv) == pytest.approx(1.0, abs=0.02)
