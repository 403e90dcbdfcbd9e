"""Island-model NSGA-II on the PyTorch port: the paper's DSE scaled
across ranks of a process group.

    PYTHONPATH=src python examples/torch_distributed_dse.py               # one card
    PYTHONPATH=src python examples/torch_distributed_dse.py --device cpu

The port of ``examples/distributed_dse.py``, at its sizes.  Two layouts:

  * single scenario, ``--ranks`` islands with ring migration, batched in
    this process (``run_islands``), and
  * the scenario x island 2-D mesh (``run_islands_multi(mesh=)``) over
    ``--ranks`` gloo processes, laid out as the reference lays out its
    devices: gcd(scenarios, ranks) along "scenario", the rest along
    "island", one island a rank; migration never crosses scenarios.

Every rank returns the one-process run's results bit for bit.  On one
card the ranks share it, time-sliced; on the card each rank's survivor
selection runs the ``dominance`` kernel.  ``--device cuda`` (the
default) raises without a card.
"""
import argparse
import json
import math
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.core import explorer, nsga2
from repro_torch.core.precision import get
from repro_torch.core.space import DesignSpace
from repro_torch.device import resolve
from repro_torch.kernels import cuda_lib
from repro_torch.launch.mesh import make_local_mesh

SCENARIOS = [("int8", 65536), ("bf16", 65536), ("int4", 16384), ("fp16", 32768)]
CFG = nsga2.NSGA2Config(pop_size=64, generations=0, seed=3)
ROUNDS = dict(rounds=4, gens_per_round=16, n_migrants=8)


def _rank(rank, world, init, device, layout, out_dir):
    """One rank of the scenario x island run; its record (seconds,
    dominance launches, and on rank 0 the fronts) goes to
    ``out_dir/rank{rank}.json``."""
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device)
            # The ranks share the host's cores; their batches are small.
            torch.set_num_threads(1)
        s_n, i_n = layout
        mesh = make_local_mesh(i_n, s_n, names=("scenario", "island"))
        n0 = cuda_lib.launches["dominance"]
        t0 = time.perf_counter()
        results = explorer.run_islands_multi(SCENARIOS, CFG, n_islands=i_n, device=dev,
                                             mesh=mesh, **ROUNDS)
        rec = {"seconds": time.perf_counter() - t0,
               "dominance": cuda_lib.launches["dominance"] - n0}
        if rank == 0:
            rec["fronts"] = [r.front_genes.tolist() for r in results]
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _coverage(front_genes, space, dev):
    got = {tuple(g) for g in front_genes}
    want = {tuple(g) for g in explorer.brute_force_front(space, dev).tolist()}
    return len(got & want), len(want)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    space = DesignSpace(prec=get("int8"), w_store=65536)
    t0 = time.perf_counter()
    res = explorer.run_islands(space, CFG, n_islands=args.ranks, device=dev, **ROUNDS)
    dt = time.perf_counter() - t0
    single = _coverage(res.front_genes.tolist(), space, dev)
    print(f"islands DSE ({args.ranks} islands): {dt:.2f}s wall, "
          f"front={len(res.front_genes)}, oracle coverage {single[0]}/{single[1]}")
    print("sample front points:")
    pts = explorer._points_from_genes(
        space, res.front_genes[:5], explorer.CALIBRATED, 1.0, dev
    )
    for p in pts:
        print("  " + p.summary())

    # Scenario x island sharding: all scenarios evolve concurrently, each
    # with its own migration ring, over the ranks of a gloo group.
    s_n = math.gcd(len(SCENARIOS), args.ranks)
    layout = (s_n, args.ranks // s_n)
    if dev.type == "cuda":
        cuda_lib.build()        # once, before the ranks load the library
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        torch.multiprocessing.start_processes(
            _rank, args=(args.ranks, "file://" + os.path.join(d, "store"), dev.type, layout, d),
            nprocs=args.ranks, join=True, start_method="spawn")
        dt = time.perf_counter() - t0
        ranks = []
        for r in range(args.ranks):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    print(f"\nscenario x island DSE ({len(SCENARIOS)} scenarios) over {args.ranks} gloo "
          f"ranks, (scenario, island) = {layout}: {dt:.2f}s wall")
    coverage = {}
    for (prec, w), front in zip(SCENARIOS, ranks[0]["fronts"]):
        hit, n = _coverage(front, DesignSpace(prec=get(prec), w_store=w), dev)
        coverage[f"{prec}/{w}"] = (hit, n)
        print(f"  {prec:>5} W={w:<6} front={len(front):<3} "
              f"oracle coverage {hit}/{n}")
    return {"islands_coverage": single, "coverage": coverage, "layout": layout,
            "rank_seconds": [r["seconds"] for r in ranks],
            "rank_dominance": [r["dominance"] for r in ranks]}


if __name__ == "__main__":
    main()
