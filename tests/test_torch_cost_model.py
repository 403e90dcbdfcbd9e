"""Parity of the port's cost model with the JAX reference.

Same genomes (every ``enumerate_feasible()`` genome, and random genomes
that violate the storage box) through both packages, passed as numpy.

Tolerance: the reference takes ``jnp.log2`` of non-power-of-two widths
(``B_x + log2 H``, ``B_r``), which XLA's CPU log2 gets wrong in the last
place for some inputs while ``torch.log2`` is correctly rounded; the
delay terms (and the throughput, power and TOPS derived from them) then
differ by 1-2 float32 ulp.  Measured worst case over this grid: 2.4e-7
relative.  RTOL = 1e-6 holds every float output to ~8 ulp.  Integer
results (decoded N/H/L/k, violation, the scenario table) are bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro.core import macros as jmacros
from repro.core import precision as jprec
from repro.core import scenario as jscen
from repro.core import space as jspace
from repro_torch import bridge
from repro_torch.core import macros as tmacros
from repro_torch.core import precision as tprec
from repro_torch.core import scenario as tscen
from repro_torch.core import space as tspace

RTOL = 1e-6
W_STORES = (4096, 16384, 65536)
GRID = [(p.name, w) for p in jprec.PAPER_SWEEP for w in W_STORES]
BUCKET = 512   # >= every grid space's feasible genome count


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@jax.jit
def _jax_all(row, genes):
    """Everything the grid test compares, from the reference, in one
    compiled program per cost-model kind (the row is traced data)."""
    c = jscen.costs(row, genes)
    return (jscen.decode(row, genes), jscen.violation(row, genes), c,
            jmacros.physical(c, activity=0.1), jscen.evaluate(row, genes))


@pytest.mark.parametrize("prec,w_store", GRID)
def test_costs_physical_evaluate_on_feasible_genomes(prec, w_store):
    js = jspace.DesignSpace(jprec.get(prec), w_store)
    ts = tspace.DesignSpace(tprec.get(prec), w_store)
    genes = js.enumerate_feasible()
    np.testing.assert_array_equal(ts.enumerate_feasible(), genes)
    # One padded shape for every scenario, so the reference compiles once
    # per cost-model kind for the whole grid (padding rows repeat row 0).
    genes, _ = jscen.pad_to_bucket(genes, BUCKET)
    gt = torch.as_tensor(genes)
    dj, vj_, cj, pj, (Fj, vj) = _jax_all(jax.tree.map(jnp.asarray, js.scenario),
                                        jnp.asarray(genes))

    for a, b in zip(dj, ts.decode(gt)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    np.testing.assert_array_equal(_np(ts.violation(gt)), np.asarray(vj_))

    ct = ts.costs(gt)
    for f in dataclasses.fields(cj):
        np.testing.assert_allclose(_np(getattr(ct, f.name)), np.asarray(getattr(cj, f.name)),
                                   rtol=RTOL, err_msg=f.name)
    pt = tmacros.physical(ct, activity=0.1)
    for f in dataclasses.fields(pj):
        np.testing.assert_allclose(_np(getattr(pt, f.name)), np.asarray(getattr(pj, f.name)),
                                   rtol=RTOL, err_msg=f.name)
    Ft, vt = ts.evaluate(gt)
    np.testing.assert_allclose(_np(Ft), np.asarray(Fj), rtol=RTOL)
    np.testing.assert_array_equal(_np(vt), np.asarray(vj))


@pytest.mark.parametrize("prec", ["int8", "bf16", "fp32"])
def test_int_fp_macro_direct(prec):
    """int_macro / fp_macro on raw (N, H, L, k) grids, outside the table."""
    rng = np.random.default_rng(3)
    N, H, L, k = (2.0 ** rng.integers(lo, hi, 64).astype(np.float32)
                  for lo, hi in ((3, 12), (1, 12), (0, 7), (0, 4)))
    jp, tp = jprec.get(prec), tprec.get(prec)
    cj = jmacros.macro_costs(N, H, L, k, jp, include_selection_mux=True)
    ct = tmacros.macro_costs(*(torch.as_tensor(a) for a in (N, H, L, k)), tp,
                             include_selection_mux=True)
    for f in dataclasses.fields(cj):
        np.testing.assert_allclose(_np(getattr(ct, f.name)), np.asarray(getattr(cj, f.name)),
                                   rtol=RTOL, err_msg=f.name)


def test_scenario_table_mixed_batch_with_violations():
    """A mixed INT+FP table evaluated in one call on (S, P, 3) genomes,
    including genomes outside the storage box (violation > 0)."""
    tj = jscen.ScenarioTable.from_specs(GRID)
    tt = tscen.ScenarioTable.from_specs(GRID, device="cpu")
    carried = bridge.scenario_table_from_numpy(
        {f.name: getattr(tj, f.name) for f in dataclasses.fields(tj)}, "cpu"
    )
    for f in tscen.DATA_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tt, f)), np.asarray(getattr(tj, f)))
        np.testing.assert_array_equal(_np(getattr(carried, f)), np.asarray(getattr(tj, f)))
    assert (tt.any_fp, tt.all_fp) == (tj.any_fp, tj.all_fp) == (True, False)

    rng = np.random.default_rng(0)
    lo, hi = np.asarray(tj.gene_lo), np.asarray(tj.gene_hi)
    genes = rng.integers(lo[:, None, :] - 1, hi[:, None, :] + 2,
                         size=(len(GRID), 40, 3)).astype(np.int32)
    Fj, vj = jscen.evaluate(tj, jnp.asarray(genes))
    for table in (tt, carried):
        Ft, vt = tscen.evaluate(table, torch.as_tensor(genes))
        np.testing.assert_allclose(_np(Ft), np.asarray(Fj), rtol=RTOL)
        np.testing.assert_array_equal(_np(vt), np.asarray(vj))
    assert np.any(np.asarray(vj) > 0)
    for a, b in zip(jscen.decode(tj, jnp.asarray(genes)), tscen.decode(tt, torch.as_tensor(genes))):
        np.testing.assert_array_equal(_np(b), np.asarray(a))

    # Row views and the host-side entry point agree with the table.
    Fh, vh = tscen.evaluate_host(tt.row(3), genes[3])
    np.testing.assert_array_equal(Fh, _np(tscen.evaluate(tt, torch.as_tensor(genes))[0])[3])
    np.testing.assert_array_equal(vh, np.asarray(vj)[3])


def test_pad_to_bucket_matches_reference():
    rng = np.random.default_rng(1)
    for n in (1, 5, 64, 65):
        g = rng.integers(0, 8, (n, 3)).astype(np.int32)
        a, na = jscen.pad_to_bucket(g)
        b, nb = tscen.pad_to_bucket(g)
        np.testing.assert_array_equal(a, b)
        assert na == nb == n
    with pytest.raises(ValueError):
        tscen.pad_to_bucket(np.zeros((9, 3), np.int32), bucket=8)


def test_describe_matches_reference():
    js = jspace.DesignSpace(jprec.get("fp16"), 16384)
    ts = tspace.DesignSpace(tprec.get("fp16"), 16384)
    for g in js.enumerate_feasible()[::7]:
        assert ts.describe(g) == js.describe(g)
