"""Island-model NSGA-II: migration against the JAX reference, whole runs
against the brute-force oracle.

The reference lays its islands on a device mesh (one island a device,
ring migration by ``lax.ppermute``); the port runs S scenarios x I
islands as one batch of populations on one device.  The port does not
reproduce JAX's threefry bits, so migration is held on the reference's
own populations: a fresh interpreter with 4 forced CPU devices runs the
reference's ``run_islands`` and ``run_islands_multi`` for one round of 0
generations (migration alone), and returns its initial populations,
re-derived from its keys exactly as the runners derive them, their
objectives, and its pooled final genes.  The port's :func:`migrate` on
those populations and objectives must give the reference's genes
exactly.  Whole runs are held to the port's ``brute_force_front`` at the
reference's bars (``tests/test_pareto_nsga2.py``,
``tests/test_scenario_batched.py``): more than 5 front points, none
dominated by an oracle point.

The ``mesh=`` layout: one ``torch.multiprocessing`` spawn of a world of 4
gloo ranks runs ``run_islands_multi(mesh=)`` on (scenario, island)
meshes (1, 4), (2, 2), (4, 1), and (1, 2) and (2, 1) as two sub-meshes
of the world each, and ``run_islands(mesh=)`` over (1, 4); every rank's
results must be bitwise the parent's one-process run.  The ranks also
record the ``ValueError`` s of a scenario count and an island count that
their axes do not divide.
"""
import datetime
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import explorer as texp
from repro_torch.core import nsga2 as tnsga
from repro_torch.core import precision as tprec
from repro_torch.core import scenario as tscen
from repro_torch.core import space as tspace
from repro_torch.core.pareto import pareto_front_mask
from repro_torch.core.scenario import ScenarioTable
from repro_torch.launch.mesh import make_local_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ISLANDS = 4
ONE = [("int8", 16384)]
MULTI = [("int8", 16384), ("bf16", 8192), ("int4", 65536)]

# Runs the reference's migration alone (rounds=1, gens_per_round=0) on 4
# forced CPU devices: one island a device.  The initial populations are
# re-derived from the runners' keys (src/repro/core/explorer.py, lines
# 384-386 for run_islands, 448-456 for run_islands_multi), and their
# objectives evaluated per island as the island body evaluates them.
_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
import numpy as np
from repro.core import explorer, nsga2, scenario
from repro.core import precision as prec
from repro.core.scenario import ScenarioTable
from repro.core.space import DesignSpace

P, NM, SEED, OUT = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
ONE, MULTI = json.loads(sys.argv[5]), json.loads(sys.argv[6])
cfg = nsga2.NSGA2Config(pop_size=P, generations=0, seed=SEED)
assert len(jax.devices()) == 4
evaluate = jax.jit(scenario.evaluate)
out = {}

sp = DesignSpace(prec.get(ONE[0][0]), ONE[0][1])
res = explorer.run_islands(sp, cfg, rounds=1, gens_per_round=0, n_migrants=NM)
keys = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)
pops = jax.vmap(lambda k: nsga2.init_population(sp.scenario, cfg, k))(keys)
row = jax.tree.map(jnp.asarray, sp.scenario)
Fv = [evaluate(row, p) for p in pops]
out["one"] = dict(pops=np.asarray(pops)[None], F=np.stack([np.asarray(f) for f, _ in Fv])[None],
                  v=np.stack([np.asarray(v) for _, v in Fv])[None], genes=res.genes[None])

table = ScenarioTable.from_specs([tuple(s) for s in MULTI])
results = explorer.run_islands_multi(table, cfg, rounds=1, gens_per_round=0, n_migrants=NM)
keys = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)
keys = jnp.broadcast_to(keys, (len(table),) + keys.shape)
pops = jax.vmap(lambda row, k: jax.vmap(lambda kk: nsga2.init_population(row, cfg, kk))(k))(
    table, keys)
F, v = [], []
for i in range(len(table)):
    r = jax.tree.map(jnp.asarray, table.row(i))
    Fv = [evaluate(r, p) for p in pops[i]]
    F.append(np.stack([np.asarray(f) for f, _ in Fv]))
    v.append(np.stack([np.asarray(x) for _, x in Fv]))
out["multi"] = dict(pops=np.asarray(pops), F=np.stack(F), v=np.stack(v),
                    genes=np.stack([r.genes for r in results]))
np.savez(OUT, **{f"{k}_{f}": a for k, d in out.items() for f, a in d.items()})
"""


@pytest.fixture(scope="module")
def reference_migration(tmp_path_factory):
    """(P, n_migrants, {"one": ..., "multi": ...}) from the reference."""
    P, nm, seed = 32, 5, 3
    out = tmp_path_factory.mktemp("islands") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, "-c", _REFERENCE, str(P), str(nm), str(seed), str(out),
                    json.dumps(ONE), json.dumps(MULTI)],
                   check=True, env=env, cwd=ROOT, timeout=300)
    z = np.load(out)
    return P, nm, {k: {f: z[f"{k}_{f}"] for f in ("pops", "F", "v", "genes")}
                   for k in ("one", "multi")}


@pytest.mark.parametrize("which", ["one", "multi"])
def test_migration_matches_reference_bitwise(reference_migration, which):
    P, nm, ref = reference_migration
    d = ref[which]
    S = d["pops"].shape[0]
    assert d["pops"].shape == (S, N_ISLANDS, P, 3)
    pop = torch.as_tensor(d["pops"].reshape(S * N_ISLANDS, P, 3))
    F = torch.as_tensor(d["F"].reshape(S * N_ISLANDS, P, 4))
    v = torch.as_tensor(d["v"].reshape(S * N_ISLANDS, P))
    got, _, _ = texp.migrate(pop, F, v, N_ISLANDS, nm)
    np.testing.assert_array_equal(got.reshape(S, N_ISLANDS * P, 3).numpy(), d["genes"])
    # Migration moved something, and only within each scenario's islands.
    assert not np.array_equal(d["genes"], d["pops"].reshape(S, N_ISLANDS * P, 3))


def test_migrants_carry_their_objectives():
    """The objectives and violations gathered with the migrants equal the
    evaluation of the migrated population, bit for bit."""
    table = ScenarioTable.from_specs(MULTI, device="cpu")
    islands = texp.island_table(table, N_ISLANDS, "cpu")
    gen = torch.Generator().manual_seed(0)
    pop = tnsga.init_population(islands, tnsga.NSGA2Config(pop_size=24), gen)
    F, v = tscen.evaluate(islands, pop)
    new, F2, v2 = texp.migrate(pop, F, v, N_ISLANDS, 6)
    Fe, ve = tscen.evaluate(islands, new)
    assert torch.equal(F2, Fe) and torch.equal(v2, ve)
    # Each island received exactly its ring predecessor's 6 best.
    order = tnsga.best_first(*tnsga._rank_and_crowd(F, v))
    for s in range(len(MULTI)):
        for i in range(N_ISLANDS):
            dst, src = s * N_ISLANDS + i, s * N_ISLANDS + (i - 1) % N_ISLANDS
            np.testing.assert_array_equal(new[dst, order[dst, -6:]].numpy(),
                                          pop[src, order[src, :6]].numpy())
            keep = order[dst, :-6]
            np.testing.assert_array_equal(new[dst, keep].numpy(), pop[dst, keep].numpy())


def test_migrate_rejects_a_bad_count():
    pop = torch.zeros((4, 8, 3), dtype=torch.int32)
    F, v = torch.zeros((4, 8, 4)), torch.zeros((4, 8))
    for nm in (0, 9):
        with pytest.raises(ValueError, match="n_migrants"):
            texp.migrate(pop, F, v, 4, nm)


def _assert_sound(p, w, res):
    """The reference's bar: more than 5 front points, none dominated by a
    point of the scenario's oracle front; front objectives evaluated
    afresh; the pooled population ranked 0 on its own front, 1 elsewhere."""
    sp = tspace.DesignSpace(tprec.get(p), w)
    oracle = texp.brute_force_front(sp, "cpu")
    oF, _ = tscen.evaluate_host(sp.to_table("cpu"), oracle)
    assert res.front_genes.shape[0] > 5, (p, w, res.front_genes.shape)
    for fo in res.front_objectives:
        assert not np.any(np.all(oF <= fo, axis=1) & np.any(oF < fo, axis=1)), (p, w, fo)
    F, v = sp.evaluate(torch.as_tensor(res.front_genes))
    np.testing.assert_array_equal(res.front_objectives, F.numpy())
    assert np.all(v.numpy() == 0)
    Fp, vp = sp.evaluate(torch.as_tensor(res.genes))
    np.testing.assert_array_equal(res.objectives, Fp.numpy())
    np.testing.assert_array_equal(res.violation, vp.numpy())
    on_front = pareto_front_mask(Fp, vp).numpy()
    assert res.ranks.dtype == np.int32
    np.testing.assert_array_equal(res.ranks, (~on_front).astype(np.int32))


def test_run_islands_fronts_hold_to_the_oracle():
    cfg = tnsga.NSGA2Config(pop_size=64, generations=0)
    sp = tspace.DesignSpace(tprec.get("int8"), 16384)
    res = texp.run_islands(sp, cfg, rounds=3, gens_per_round=12, n_migrants=4, device="cpu")
    assert res.genes.shape == (N_ISLANDS * 64, 3)
    _assert_sound("int8", 16384, res)


def test_run_islands_multi_fronts_hold_to_the_oracle():
    scens = [("int8", 16384), ("bf16", 8192)]
    results = texp.run_islands_multi(scens, tnsga.NSGA2Config(pop_size=64, generations=0),
                                     rounds=3, gens_per_round=12, n_migrants=4, device="cpu")
    assert len(results) == len(scens)
    for (p, w), res in zip(scens, results):
        _assert_sound(p, w, res)


@pytest.mark.parametrize("n_scenarios", [1, 3, 5])
def test_islands_are_deterministic_for_any_scenario_count(n_scenarios):
    """One seed gives one run, for any S (no mesh to divide), and a
    scenario's islands depend on the seed."""
    scens = [("int8", 16384), ("bf16", 8192), ("int4", 65536), ("fp8", 16384),
             ("int2", 16384)][:n_scenarios]
    kw = dict(n_islands=3, rounds=2, gens_per_round=2, n_migrants=2, device="cpu")
    cfg = tnsga.NSGA2Config(pop_size=16, seed=5)
    a = texp.run_islands_multi(scens, cfg, **kw)
    b = texp.run_islands_multi(ScenarioTable.from_specs(scens, device="cpu"), cfg, **kw)
    c = texp.run_islands_multi(scens, tnsga.NSGA2Config(pop_size=16, seed=6), **kw)
    assert len(a) == n_scenarios
    for ra, rb, rc in zip(a, b, c):
        assert ra.genes.shape == (3 * 16, 3)
        for f in ("genes", "objectives", "violation", "ranks", "front_genes",
                  "front_objectives"):
            np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
        assert not np.array_equal(ra.genes, rc.genes)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = tnsga.NSGA2Config(pop_size=8)
    with pytest.raises(RuntimeError, match="cuda"):
        texp.run_islands_multi([("int8", 4096)], cfg, rounds=1, gens_per_round=1)
    with pytest.raises(RuntimeError, match="cuda"):
        texp.run_islands(tspace.DesignSpace(tprec.get("int8"), 4096), cfg, rounds=1,
                         gens_per_round=1)
    with pytest.raises(RuntimeError, match="cuda"):
        texp.run_islands_multi(ScenarioTable.from_specs([("int8", 4096)], device="cpu"), cfg,
                               rounds=1, gens_per_round=1)


# ------------------------------- the mesh layout ------------------------------
WORLD = 4
MESH_SCENS = [("int8", 16384), ("bf16", 8192), ("int4", 65536), ("fp8", 16384)]
MESH_CFG = tnsga.NSGA2Config(pop_size=16, seed=7)
MESH_KW = dict(n_islands=4, rounds=2, gens_per_round=2, n_migrants=2, device="cpu")
MESHES = [(1, 4), (2, 2), (4, 1), (1, 2), (2, 1)]     # (scenario, island)
MESH_RUNS = [(m, S) for m in MESHES for S in (2, 4) if S % m[0] == 0]
FIELDS = ("genes", "objectives", "violation", "ranks", "front_genes", "front_objectives")
# Every collective of the spawned ranks fails past this, so a broken rank
# fails the test instead of hanging it.
TIMEOUT = datetime.timedelta(seconds=120)


def _mesh(m):
    """The world's (scenario, island) = ``m`` mesh of this rank, its
    groups bounded by TIMEOUT."""
    mesh = make_local_mesh(m[1], m[0], names=("scenario", "island"))
    for name in mesh.mesh_dim_names:
        mesh.get_group(name).set_timeout(TIMEOUT)
    return mesh


def _islands_rank(rank, world, init, out_dir):
    """One rank: every mesh run, its results saved as arrays, and the
    errors of the sizes its axes do not divide."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        out, errors = {}, {}
        for m, S in MESH_RUNS:
            res = texp.run_islands_multi(MESH_SCENS[:S], MESH_CFG, mesh=_mesh(m), **MESH_KW)
            for i, r in enumerate(res):
                out.update({f"{m}/{S}/{i}/{f}": getattr(r, f) for f in FIELDS})
        sp = tspace.DesignSpace(tprec.get(ONE[0][0]), ONE[0][1])
        r = texp.run_islands(sp, MESH_CFG, mesh=_mesh((1, 4)), axis="island", **MESH_KW)
        out.update({f"one/{f}": getattr(r, f) for f in FIELDS})
        for key, call in (
                ("scenarios", lambda: texp.run_islands_multi(
                    MESH_SCENS[:2], MESH_CFG, mesh=_mesh((4, 1)), **MESH_KW)),
                ("islands", lambda: texp.run_islands_multi(
                    MESH_SCENS[:2], MESH_CFG, mesh=_mesh((1, 4)),
                    **{**MESH_KW, "n_islands": 6}))):
            try:
                call()
            except ValueError as e:
                errors[key] = str(e)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(errors, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs():
    """(one-process results by S, one-process run_islands result, each
    rank's (arrays, errors)), the ranks running while the parent computes
    the one-process runs."""
    with tempfile.TemporaryDirectory() as d:
        procs = mp.start_processes(_islands_rank, args=(WORLD, "file://" + os.path.join(d, "store"),
                                                        d), nprocs=WORLD, join=False,
                                   start_method="spawn")
        want = {S: texp.run_islands_multi(MESH_SCENS[:S], MESH_CFG, **MESH_KW) for S in (2, 4)}
        one = texp.run_islands(tspace.DesignSpace(tprec.get(ONE[0][0]), ONE[0][1]), MESH_CFG,
                               **MESH_KW)
        while not procs.join(timeout=TIMEOUT.total_seconds()):
            pass
        ranks = []
        for r in range(WORLD):
            with np.load(os.path.join(d, f"rank{r}.npz")) as z:
                arrays = dict(z)
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append((arrays, json.load(f)))
    return want, one, ranks


@pytest.mark.parametrize("mesh,n_scenarios", MESH_RUNS,
                         ids=[f"{m[0]}x{m[1]}-S{S}" for m, S in MESH_RUNS])
def test_mesh_islands_bitwise_one_process(mesh_runs, mesh, n_scenarios):
    want, _, ranks = mesh_runs
    for r, (arrays, _) in enumerate(ranks):
        for i, res in enumerate(want[n_scenarios]):
            for f in FIELDS:
                got = arrays[f"{mesh}/{n_scenarios}/{i}/{f}"]
                np.testing.assert_array_equal(got, getattr(res, f), err_msg=f"rank {r} {f}")
                assert got.dtype == getattr(res, f).dtype


def test_mesh_run_islands_bitwise_one_process(mesh_runs):
    _, one, ranks = mesh_runs
    for r, (arrays, _) in enumerate(ranks):
        for f in FIELDS:
            np.testing.assert_array_equal(arrays[f"one/{f}"], getattr(one, f),
                                          err_msg=f"rank {r} {f}")


def test_mesh_refuses_sizes_its_axes_do_not_divide(mesh_runs):
    for _, errors in mesh_runs[2]:
        assert errors.get("scenarios") == "2 scenarios not divisible by scenario mesh axis 4"
        assert errors.get("islands") == "6 islands not divisible by island mesh axis 4"


def test_mesh_without_a_process_group_refuses():
    """A mesh whose process group is gone raises; nothing falls back to
    the one-process run."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(d, "s"),
                                rank=0, world_size=1)
        try:
            mesh = make_local_mesh(1, names=("scenario", "island"))
        finally:
            dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="process group"):
        texp.run_islands_multi(MESH_SCENS[:1], MESH_CFG, mesh=mesh, **MESH_KW)
