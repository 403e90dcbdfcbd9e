"""The contract lint's multi-rank contracts on two gloo CPU ranks.

* ``run_lint(ranks=2)`` spawns two ranks that build and check
  ``serve.scheduler_tp`` and ``dist.train_dp``; both must be ``ok`` on
  both ranks, every collective call within its budget;
* a seeded whole-leaf all-gather of a replicated operand over a real
  gloo group is an ``error`` carrying its per-call bytes, and a gather
  of the same leaf under its replicated spec moves nothing.

Every wait is bounded: the ranks' groups by ``contracts.RANK_TIMEOUT``,
the parent's join by twice that.
"""
import json
import os
import tempfile
import time

import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.analysis import load_builtin_checks
from repro_torch.analysis.contracts import RANK_TIMEOUT, bound_groups, counter_calls
from repro_torch.analysis.registry import CHECKS, Built, CollectiveUnit

MULTI = ("dist.train_dp", "serve.scheduler_tp")


def test_multi_rank_contracts_ok_on_two_gloo_ranks():
    from repro_torch.analysis.lint import run_lint

    report = run_lint(contracts=list(MULTI), device="cpu", ranks=2)
    errors = [f"{f.check}/{f.contract}: {f.message}" for f in report.findings
              if f.severity == "error"]
    assert report.ok, errors
    assert sorted(set(report.contracts_executed)) == sorted(MULTI)
    for contract in MULTI:
        ranks = {f.data["rank"] for f in report.findings if f.contract == contract}
        assert ranks == {0, 1}, contract
    coll = [f for f in report.findings if f.check == "collectives"]
    by = {(f.data["rank"], f.data["unit"]): f for f in coll}
    for r in (0, 1):
        assert "within budget" in by[(r, "decode_tp")].message
        assert by[(r, "decode_tp")].data["n_calls"] > 0         # the step gathers
        assert by[(r, "replicated_gather")].data["n_calls"] == 0
        assert by[(r, "train_dp_step")].data["n_calls"] > 0      # all-reduces
    # in one process, without a group, both skip
    solo = run_lint(contracts=list(MULTI), device="cpu")
    assert solo.ok and all(f.message.startswith("skipped") for f in solo.findings)


def _seeded_rank(rank: int, n: int, init: str, out_dir: str) -> None:
    from repro_torch.dist.sharding import MeshContext
    from repro_torch.launch.mesh import make_local_mesh

    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=n,
                            timeout=RANK_TIMEOUT)
    try:
        load_builtin_checks()
        counter = {}
        ctx = MeshContext(make_local_mesh(1), counter=counter)
        bound_groups(ctx)
        leaf = torch.full((64, 512), float(rank))           # a replicated operand, 128 KiB
        whole = ctx.all_gather(leaf, 0, axis="data")        # gathered whole: the remat
        bad = counter_calls(counter)
        counter.clear()
        same = ctx.gather_block(leaf, (None, None))         # under its replicated spec
        clean = counter_calls(counter)
        findings = CHECKS["collectives"]("seeded", Built(collectives=[
            CollectiveUnit("whole_gather", bad, {"all-gather": 1 << 16, "all-to-all": 0}),
            CollectiveUnit("replicated_gather", clean, {"all-gather": 0})]))
        with open(os.path.join(out_dir, f"seeded{rank}.json"), "w") as f:
            json.dump({"findings": [x.to_json() for x in findings],
                       "rows": whole.shape[0], "other": float(whole[-1, 0]),
                       "same": same is leaf}, f)
    finally:
        dist.destroy_process_group()


def test_seeded_whole_leaf_gather_is_an_error_with_its_bytes():
    with tempfile.TemporaryDirectory() as d:
        procs = mp.start_processes(_seeded_rank, args=(2, "file://" + os.path.join(d, "s"), d),
                                   nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + 2 * RANK_TIMEOUT.total_seconds()
        while not procs.join(timeout=5):
            if time.monotonic() > deadline:
                for p in procs.processes:
                    p.kill()
                pytest.fail("seeded ranks did not finish")
        recs = []
        for r in range(2):
            with open(os.path.join(d, f"seeded{r}.json")) as f:
                recs.append(json.load(f))
    for r, rec in enumerate(recs):
        assert rec["rows"] == 128 and rec["other"] == 1.0 and rec["same"]
        errs = [f for f in rec["findings"] if f["severity"] == "error"]
        assert len(errs) == 1 and "oversized collective all-gather" in errs[0]["message"]
        site = errs[0]["data"]["site"]
        assert site["bytes"] == 2 * 64 * 512 * 4 and site["budget"] == 1 << 16
        infos = [f for f in rec["findings"] if f["data"]["unit"] == "replicated_gather"]
        assert len(infos) == 1 and infos[0]["severity"] == "info"
