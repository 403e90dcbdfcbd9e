"""NSGA-II: one generation against the JAX reference, whole runs against
the brute-force oracle.

The port draws its randomness from a ``torch.Generator`` and does not
reproduce JAX's threefry bits.  So the generation test hands the port's
apply step (:func:`make_children`, :func:`survivors`) the reference's
own random draws — re-derived here from the reference's keys exactly as
``repro.core.nsga2._make_children`` splits them — and the reference's
own objectives, and requires the reference's children and next
population exactly.  Whole runs are held to the port's own
``brute_force_front``: every front genome is oracle-optimal and the
front covers at least 90% of the oracle (the reference's bar).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro.core import nsga2 as jnsga
from repro.core import precision as jprec
from repro.core import scenario as jscen
from repro.core import space as jspace
from repro_torch.core import explorer as texp
from repro_torch.core import nsga2 as tnsga
from repro_torch.core import precision as tprec
from repro_torch.core import space as tspace
from repro_torch.core.scenario import ScenarioTable

SCENARIOS = [("int8", 16384), ("bf16", 65536), ("fp32", 4096)]


def _jax_draws(kc, P, cfg, lo, hi):
    """The random numbers ``_make_children(kc, ...)`` consumes, as numpy."""
    ksa, ksb, kxp, kxm, kmm, kms, kmr, kmp = jax.random.split(kc, 8)

    def tour(k):
        ka, kb = jax.random.split(k)
        return (np.asarray(jax.random.randint(ka, (P,), 0, P)),
                np.asarray(jax.random.randint(kb, (P,), 0, P)))

    ta_i, ta_j = tour(ksa)
    tb_i, tb_j = tour(ksb)
    return dict(
        ta_i=ta_i, ta_j=ta_j, tb_i=tb_i, tb_j=tb_j,
        do_x=np.asarray(jax.random.bernoulli(kxp, cfg.p_crossover, (P, 1))),
        xmask=np.asarray(jax.random.bernoulli(kxm, 0.5, (P, 3))),
        mmask=np.asarray(jax.random.bernoulli(kmm, cfg.p_mutate, (P, 3))),
        step=np.asarray(jax.random.randint(kms, (P, 3), 0, 2) * 2 - 1),
        reset=np.asarray(jax.random.randint(kmr, (P, 3), lo[None, :], hi[None, :] + 1)),
        use_step=np.asarray(jax.random.bernoulli(kmp, cfg.p_step_mutate, (P, 3))),
    )


def _stack_draws(per_scenario):
    dt = {"ta_i": torch.int64, "ta_j": torch.int64, "tb_i": torch.int64, "tb_j": torch.int64,
          "step": torch.int32, "reset": torch.int32}
    return tnsga.Draws(**{
        k: torch.as_tensor(np.stack([d[k] for d in per_scenario]), dtype=dt.get(k, torch.bool))
        for k in per_scenario[0]
    })


def _jax_generation(row, pop, kc, cfg):
    """One reference generation, step by step, keeping what it saw."""
    lo, hi = jnp.asarray(row.gene_lo), jnp.asarray(row.gene_hi)
    F, v = jscen.evaluate(row, pop)
    ranks, crowd = jnsga._rank_and_crowd(F, v, False)
    ch = jnsga._make_children(kc, pop, ranks, crowd, cfg, lo, hi)
    comb = jnp.concatenate([pop, ch], axis=0)
    Fc, vc = jscen.evaluate(row, comb)
    return F, v, ch, comb, Fc, vc, jnsga._survivors(Fc, vc, comb, cfg.pop_size, False)


def test_generations_match_reference_given_its_draws_and_objectives():
    P, n_gen = 32, 2
    jcfg = jnsga.NSGA2Config(pop_size=P, generations=n_gen, use_pallas=False)
    rows = [jspace.DesignSpace(jprec.get(p), w).scenario for p, w in SCENARIOS]
    table = ScenarioTable.from_specs(SCENARIOS, device="cpu")
    lo = [np.asarray(r.gene_lo) for r in rows]
    hi = [np.asarray(r.gene_hi) for r in rows]
    keys = [jax.random.PRNGKey(s) for s in range(len(rows))]
    pops = [jnsga.init_population(r, jcfg, k) for r, k in zip(rows, keys)]
    # Compiled once per cost-model kind (the row is traced data).
    generation = jax.jit(_jax_generation, static_argnums=3)

    for gen in range(n_gen):
        draws, children, nexts, Fs, vs, Fcs, vcs, combs = [], [], [], [], [], [], [], []
        for i, row in enumerate(rows):
            keys[i], kc = jax.random.split(jax.random.fold_in(keys[i], gen))
            F, v, ch, comb, Fc, vc, nxt = generation(
                jax.tree.map(jnp.asarray, row), pops[i], kc, jcfg
            )
            draws.append(_jax_draws(kc, P, jcfg, lo[i], hi[i]))
            children.append(np.asarray(ch))
            nexts.append(nxt)
            Fs.append(np.asarray(F)), vs.append(np.asarray(v))
            Fcs.append(np.asarray(Fc)), vcs.append(np.asarray(vc))
            combs.append(np.asarray(comb))

        # The port's apply step on the reference's draws and objectives.
        pop_t = torch.as_tensor(np.stack([np.asarray(p) for p in pops]))
        F_t, v_t = torch.as_tensor(np.stack(Fs)), torch.as_tensor(np.stack(vs))
        ranks_t, crowd_t = tnsga._rank_and_crowd(F_t, v_t)
        ch_t = tnsga.make_children(pop_t, ranks_t, crowd_t, _stack_draws(draws),
                                   table.gene_lo, table.gene_hi)
        np.testing.assert_array_equal(ch_t.numpy(), np.stack(children))
        _, next_t = tnsga.survivors(torch.as_tensor(np.stack(Fcs)), torch.as_tensor(np.stack(vcs)),
                                    torch.as_tensor(np.stack(combs)), P)
        np.testing.assert_array_equal(next_t.numpy(), np.stack([np.asarray(n) for n in nexts]))
        pops = nexts


def test_run_batched_fronts_hold_to_the_oracle():
    table = ScenarioTable.from_specs(SCENARIOS, device="cpu")
    cfg = tnsga.NSGA2Config()
    results = tnsga.run_batched(table, cfg)
    for (p, w), res in zip(SCENARIOS, results):
        sp = tspace.DesignSpace(tprec.get(p), w)
        oracle = {tuple(g) for g in texp.brute_force_front(sp, "cpu")}
        got = {tuple(g) for g in res.front_genes}
        assert got <= oracle, (p, w, sorted(got - oracle))
        assert len(got) >= 0.9 * len(oracle), (p, w, len(got), len(oracle))
        assert res.genes.shape == (cfg.pop_size, 3) and res.ranks.dtype == np.int32
        # Front objectives are the cost model's, evaluated afresh.
        F, v = sp.evaluate(torch.as_tensor(res.front_genes))
        np.testing.assert_array_equal(res.front_objectives, F.numpy())
        assert np.all(v.numpy() == 0)


def test_run_is_deterministic_and_matches_a_one_row_batch():
    sp = tspace.DesignSpace(tprec.get("int4"), 16384)
    cfg = tnsga.NSGA2Config(pop_size=32, generations=8, seed=3)
    a = tnsga.run(sp, cfg, "cpu")
    b = tnsga.run(sp, cfg, "cpu")
    c = tnsga.run_batched(sp.to_table("cpu"), cfg)[0]
    for r in (b, c):
        np.testing.assert_array_equal(a.genes, r.genes)
        np.testing.assert_array_equal(a.front_genes, r.front_genes)


def test_explore_multi_brute_matches_reference_oracle_and_distill():
    """The oracle path (no randomness) against the reference's oracle."""
    from repro.core import explorer as jexp

    scen = [("int4", 16384), ("fp8", 65536)]
    pts_t = texp.explore_multi(scen, method="brute", device="cpu", activity=0.1)
    pts_j = jexp.explore_multi(scen, method="brute", batched=False, activity=0.1)
    key = lambda p: (p.precision, p.w_store, tuple(int(x) for x in p.genes))  # noqa: E731
    assert sorted(map(key, pts_t)) == sorted(map(key, pts_j))
    by_key = {key(p): p for p in pts_j}
    for p in pts_t:
        q = by_key[key(p)]
        assert (p.N, p.H, p.L, p.k) == (q.N, q.H, q.L, q.k)
        np.testing.assert_allclose(
            [p.area_mm2, p.delay_ns, p.energy_nJ, p.tops, p.tops_per_w, p.tops_per_mm2],
            [q.area_mm2, q.delay_ns, q.energy_nJ, q.tops, q.tops_per_w, q.tops_per_mm2],
            rtol=1e-6,   # test_torch_cost_model.py: 1-2 ulp from the reference's log2
        )
    for sort_by in ("edp", "area", "tops_per_w"):
        a = texp.distill(pts_t, sort_by=sort_by, top=3)
        b = jexp.distill(pts_j, sort_by=sort_by, top=3)
        assert [key(p) for p in a] == [key(p) for p in b]
    joint_t = texp.explore_multi(scen, method="brute", cross_dominate=True, device="cpu")
    joint_j = jexp.explore_multi(scen, method="brute", batched=False, cross_dominate=True)
    assert sorted(map(key, joint_t)) == sorted(map(key, joint_j))


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        texp.explore_multi([("int8", 4096)], tnsga.NSGA2Config(pop_size=8, generations=1))
    with pytest.raises(RuntimeError, match="cuda"):
        ScenarioTable.from_specs([("int8", 4096)])
