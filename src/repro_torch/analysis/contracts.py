"""Contract loading, the multi-rank runner, and the cross-module
data-parallel contract.

Per-program contracts live next to their code (``serve.scheduler``,
``models.lm``, ``train.train_step``, ``core.nsga2``, ``kernels.ops``,
``sim.functional``) — importing those modules registers them.  The
data-parallel training contract lives here because it spans the train
step and ``dist``.

A multi-rank contract (``ranks`` > 1) needs a gloo process group of that
many ranks: in one process it skips with an ``info`` finding, and
``run_lint(ranks=N)`` / the CLI's ``--ranks N`` spawns N ranks
(:func:`run_in_ranks`; on the card, time-sliced on the one card) that
build and check it, each writing its report for the parent to merge.
"""
from __future__ import annotations

import datetime
import importlib
import json
import os
import tempfile
import time
from typing import List, Sequence

from .registry import Built, CollectiveUnit, ContractSkip, DonationUnit, register_contract

# Importing these modules registers their contracts (decorator side
# effect at module scope).
CONTRACT_MODULES = (
    "repro_torch.serve.scheduler",
    "repro_torch.models.lm",
    "repro_torch.train.train_step",
    "repro_torch.core.nsga2",
    "repro_torch.kernels.ops",
    "repro_torch.sim.functional",
)

# Every wait of a spawned rank is bounded by this.
RANK_TIMEOUT = datetime.timedelta(seconds=180)


def load_contracts() -> None:
    for mod in CONTRACT_MODULES:
        importlib.import_module(mod)


def require_group(n: int):
    """The world's size when this process is a rank of an initialized
    process group of at least ``n`` ranks, else :class:`ContractSkip`."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise ContractSkip(
            f"needs a process group of >= {n} ranks (this process: {world}); run "
            f"`python -m repro_torch.analysis.lint --ranks {n}`"
        )
    return world


def bound_groups(ctx) -> None:
    """Bound every process group of a mesh context by
    :data:`RANK_TIMEOUT` (a ``DeviceMesh``'s groups take torch's default
    of 30 minutes)."""
    for axis in ctx.axis_names:
        group = ctx.group(axis)
        if group is not None:
            group.set_timeout(RANK_TIMEOUT)


def counter_calls(counter) -> List[dict]:
    """One {"op", "bytes"} a collective call, from a ``MeshContext``
    counter."""
    return [{"op": kind, "bytes": b} for kind, rec in counter.items() for b in rec["calls"]]


def _rank_main(rank: int, n: int, init: str, device_type: str, contracts: Sequence[str],
               checks: Sequence[str], out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from .lint import run_lint

    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=n,
                            timeout=RANK_TIMEOUT)
    try:
        report = run_lint(checks=checks, contracts=contracts, device=device_type)
        with open(os.path.join(out_dir, f"lint{rank}.json"), "w") as f:
            json.dump(report.to_json(), f)
    finally:
        dist.destroy_process_group()


def run_in_ranks(contracts: Sequence[str], checks: Sequence[str], device, n: int) -> List[dict]:
    """Spawn ``n`` gloo ranks (on ``device``'s type; on the card each on
    the card of its rank modulo the count) that run ``contracts``; return
    each rank's ``Report.to_json()``.  Raises if a rank fails or the
    ranks outlast ``RANK_TIMEOUT`` twice over."""
    import torch.multiprocessing as mp

    if device.type == "cuda":
        from ..kernels import cuda_lib

        cuda_lib.build()            # once, before the ranks load the library
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        procs = mp.start_processes(
            _rank_main, args=(n, init, device.type, list(contracts), list(checks), d),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + 2 * RANK_TIMEOUT.total_seconds()
        while not procs.join(timeout=5):
            if time.monotonic() > deadline:
                for p in procs.processes:
                    p.kill()
                raise TimeoutError(f"lint ranks still running after "
                                   f"{2 * RANK_TIMEOUT.total_seconds():.0f} s")
        out = []
        for r in range(n):
            with open(os.path.join(d, f"lint{r}.json")) as f:
                out.append(json.load(f))
    return out


@register_contract(
    "dist.train_dp",
    checks=("collectives", "donation"),
    description="data-parallel train step over a (data, model) = (2, 1) gloo group at a smoke "
                "config: replicated state updated in place, rows split over the data ranks; "
                "gradient sync must stay all-reduce — no all-gather over 64 KiB a call "
                "(involuntary remat), no all-to-all, and a gather of a leaf with no sharded "
                "dim must not communicate",
    ranks=2,
)
def _build_train_dp(device) -> Built:
    world = require_group(2)
    import torch

    from ..configs import get_smoke_config
    from ..dist.fsdp import TrainContext
    from ..dist.sharding import param_sharding_tree, state_sharding_tree, tree_paths
    from ..launch.mesh import make_local_mesh
    from ..models import lm
    from ..optim import get_optimizer
    from ..train.train_step import init_state, make_train_step, state_shapes

    cfg = get_smoke_config("qwen2.5-3b")
    opt = get_optimizer("adamw", 1e-3)
    counter: dict = {}
    ctx = TrainContext(make_local_mesh(1), lm.init(cfg, torch.Generator("cpu"), "meta"),
                       counter=counter)
    bound_groups(ctx)
    # Replicated state: no rule splits a parameter or a moment; the rows
    # still split over the data axis.
    ctx.rules["fsdp"] = ()
    ctx.param_specs = {p: ls.spec for p, ls in tree_paths(
        param_sharding_tree(lm.init(cfg, torch.Generator("cpu"), "meta"), ctx))}
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_state(gen, cfg, opt, device=device, mesh=ctx)
    step = make_train_step(cfg, opt, mesh=ctx)
    B, S = world, 16
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32).to(device)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1),
             "loss_mask": torch.ones((B, S), dtype=torch.float32, device=device)}
    step(state, batch)                  # warm
    counter.clear()
    step(state, batch)
    step_calls = counter_calls(counter)

    counter.clear()
    specs = state_sharding_tree(state_shapes(cfg, opt), ctx)
    leaves = dict(tree_paths(state))
    for path, ls in tree_paths(specs):
        if path in leaves:
            ctx.gather_block(leaves[path], ls.spec)
    gather_calls = counter_calls(counter)
    return Built(
        donation=[DonationUnit("train_dp_step", lambda: step(state, batch), lambda: state)],
        collectives=[
            # the gradient sync is all-reduce (unbudgeted here); a FULL
            # all-gather of a replicated operand is the involuntary-remat
            # signature — nothing in a clean data-parallel step gathers
            # more than control scalars
            CollectiveUnit("train_dp_step", step_calls, {"all-gather": 1 << 16,
                                                          "all-to-all": 0}),
            CollectiveUnit("replicated_gather", gather_calls, {"all-gather": 0}),
        ],
    )
