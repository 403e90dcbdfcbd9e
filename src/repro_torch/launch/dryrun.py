"""Dry-run: one device's work per step, counted on fake tensors.

For every (architecture x input shape) cell, build the step's state and
inputs as fake tensors (shapes and dtypes only, nothing allocated) and
run the port's own step on them:

  train:   ``train.make_train_step`` (``lm.loss_fn``, autograd, the
           global-norm clip and the optimizer's in-place update; AdamW,
           or Adafactor for ``ADAFACTOR_ARCHS``);
  prefill: ``lm.prefill``;
  decode:  the serving decode, ``lm.decode_step_paged``, the program
           ``serve.Scheduler`` runs: every slot at the shape's last
           position over its own pages of a ``lm.init_paged_pool`` pool
           (qwen2-vl, which no Scheduler serves, runs it on its
           embeddings: at decode M-RoPE's three streams are equal, so
           its work is the same).

Matmul FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``,
by aten op; bytes by a dispatch mode that adds each aten op's input and
output bytes, ops that move nothing (views, metadata) excluded: the
eager, unfused traffic.  A size that
depends on the data would count at its upper bound (the training MoE's
dispatch has none: a dropped choice goes to a spare row).  The argument
bytes (state, caches, batch) say whether the cell fits one 80 GB card
(``fits``); a cell that does not is still counted.  Every cell runs
under ``FakeTensorMode(shape_env=ShapeEnv())``: the ShapeEnv lets such
shapes stay symbolic instead of raising.

The step runs on fake CPU tensors, so every kernel call takes its plain
PyTorch version: the counts are the work of each function, not of a
hand-written kernel's implementation of it.

One record a cell goes into a ``core.results.ResultStore`` under
``--out``, named ``{arch}__{shape}__h100x1``, with the fields
``roofline.analyze_record`` reads.

The decode step always runs under a group-less serving context of
``tp`` ranks (1 for ``h100x1``): params and pool laid out by the
serving rules, one rank's work at its local shapes, its gathers
returning uninitialised tensors and counting their bytes
(``analysis["collectives"]["all-gather"]``).  ``--tp N`` counts the
decode cells at N ranks, as ``serve.Scheduler(tp=N)`` runs them, into
records named ``{arch}__{shape}__tp{N}``.  ``--mesh multi`` counts one
rank of the reference's multi-pod mesh ``{"pod": 2, "data": 16, "model":
16}`` (``{arch}__{shape}__multi``): a train cell the FSDP step
(``make_train_step(mesh=)``) on the rank's blocks of the state and its
global_batch / 32 rows, its gathers and gradient reductions counted
(the model axis splits storage, not compute); a prefill or decode cell
one rank of 32 data replicas of a tp=16 serving group, the Scheduler's
``lm.prefill_paged`` / ``lm.decode_step_paged`` at the rank's rows.
Each record states its ``execution``, its per-rank argument bytes and
``fits``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k --out build/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --out build/dryrun
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import math
import pathlib
import time
import traceback
from typing import Any, Dict, Mapping, Optional

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.symbolic_shapes import ShapeEnv
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..core.results import ResultStore
from ..dist import sharding as shd
from ..models import lm
from ..models.config import LMConfig
from ..optim import get_optimizer
from ..train import make_train_step
from ..train.train_step import shard_state, train_context
from . import specs
from .mesh import make_production_mesh
from .roofline import DEVICE_BYTES

# Archs whose parameter count makes full-Adam moments unaffordable at
# the reference's 512 chips: factored second moments, as the reference.
ADAFACTOR_ARCHS = {"qwen2-vl-72b", "deepseek-v3-671b", "jamba-v0.1-52b"}
MESH = "h100x1"
TOP_OPS = 12


def _numel(t: torch.Tensor) -> int:
    """Elements of ``t``; a size that depends on the data counts at its
    upper bound (0 where it has none)."""
    n = t.numel()
    if not isinstance(n, torch.SymInt):
        return n
    try:
        return int(n)
    except Exception:
        hi = n.node.shape_env.bound_sympy(n.node.expr).upper
        return int(hi) if hi.is_finite else 0


def _nbytes(t: torch.Tensor) -> int:
    return _numel(t) * t.element_size()


def tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor))


# Ops that return a tensor but move no data: a reshape autograd does not
# track as a view, and allocations left uninitialised.
_NO_TRAFFIC = {"aten._unsafe_view", "aten.empty", "aten.empty_strided", "aten.new_empty",
               "aten.new_empty_strided", "aten.lift_fresh"}


class ByteCounter(TorchDispatchMode):
    """Adds each aten op's input and output tensor bytes, by op.  Views,
    the ops of ``_NO_TRAFFIC`` and ops that return no tensor (metadata
    queries) move nothing and are left out."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, int] = collections.Counter()
        self.data_dependent = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if outs and not func.is_view and name not in _NO_TRAFFIC:
            leaves = outs + [t for t in pytree.tree_leaves((args, kwargs))
                             if isinstance(t, torch.Tensor)]
            self.by_op[name] += sum(_nbytes(t) for t in leaves)
            self.data_dependent += any(isinstance(t.numel(), torch.SymInt) for t in leaves)
        return out


def _top(counts: Dict[str, float], n: int = TOP_OPS):
    return [[k, float(v)] for k, v in sorted(counts.items(), key=lambda kv: -kv[1])[:n]]


def count_step(cfg: LMConfig, kind: str, batch: int, seq: int,
               optimizer: Optional[str] = None, tp: int = 1,
               page_size: int = 16, mesh: Optional[Mapping[str, int]] = None) -> Dict[str, Any]:
    """Count one step of ``kind`` at (batch, seq) on fake tensors, a
    decode step as one rank of ``tp`` (pages of ``page_size``).  With
    ``mesh`` ({axis: size}, as ``launch.mesh.make_production_mesh``) the
    step is one rank's of that mesh: a train step the FSDP step
    (``make_train_step(mesh=)``) on the rank's blocks of the state and
    its rows of the batch; a prefill or decode step one rank of a
    ``mesh["model"]``-wide serving group, ``lm.prefill_paged`` or
    ``lm.decode_step_paged`` at the rank's rows (the data axes' replicas
    split the batch; a batch they do not divide is whole on each).
    A prefill's SSM layers are counted on the associative scan.
    Returns the record's counted fields: ``analysis`` (``dot_flops``,
    ``mem_bytes``, ``collectives``: the step's all-gathers and
    reductions, none on one rank), ``memory`` (``argument_size_in_bytes``,
    the rank's), ``fits``, the top aten ops by FLOPs and by bytes, and the
    seconds the count took."""
    if tp != 1 and (kind != "decode" or mesh is not None):
        raise ValueError(f"only the decode step is counted at tp={tp}")
    t0 = time.perf_counter()
    if kind == "prefill" and cfg.ssm_impl == "pallas":
        # K7's plain version walks the sequence one position at a time, S
        # dispatches a layer on fake tensors; the recurrence's other form,
        # the associative scan, has the same products in a few ops a chunk.
        cfg = dataclasses.replace(cfg, ssm_impl="assoc")
    counter: Dict[str, Dict[str, float]] = {}
    rows = batch
    if mesh is not None:
        tp = int(mesh.get("model", 1))
        data = math.prod(int(v) for k, v in mesh.items() if k != "model")
        rows = batch // data if batch % data == 0 else batch
    ctx = shd.serving_context({"model": tp}, counter=counter)
    with FakeTensorMode(shape_env=ShapeEnv()) as mode:
        params = lm.init(cfg, torch.Generator("cpu"), device="cpu")
        inputs = specs.batch_struct(cfg, kind, rows, seq, mode)
        if kind == "train":
            opt = get_optimizer(optimizer or "adamw", 1e-4)
            args = {"params": params, "opt": opt.init(params),
                    "step": torch.zeros((), dtype=torch.int32)}
            if mesh is not None:
                ctx = train_context(dict(mesh), cfg, counter)
                args = shard_state(args, shd.state_sharding_tree(args, ctx))
                inputs = specs.batch_struct(cfg, kind, batch, seq, mode)
            step = make_train_step(cfg, opt, mesh=None if mesh is None else ctx)

            def run():
                step(args, inputs)
        elif kind == "prefill" and mesh is None:
            args = params

            def run():
                lm.prefill(params, inputs, cfg, max_len=seq)
        else:
            params = shd.shard_tree(params, shd.serve_param_sharding_tree(params, ctx), ctx)
            nb = -(-seq // page_size)
            pool = shd.local_pool(lambda dev: lm.init_paged_pool(
                cfg, rows, 1 + rows * nb, page_size, dev), "cpu", ctx)
            tables = (1 + torch.arange(rows * nb, dtype=torch.int32)).reshape(rows, nb)
            args = (params, pool, tables)
            if kind == "decode":
                pos = torch.full((rows,), seq - 1, dtype=torch.int32)
                args = (params, pool, pos, tables)

                def run():
                    lm.decode_step_paged(params, inputs, pos, pool, tables, cfg)
            elif cfg.external_embed:        # no Scheduler serves it: the monolithic prefill
                def run():
                    lm.prefill(params, inputs, cfg, max_len=seq)
            else:
                slots = torch.arange(rows, dtype=torch.int32)
                zero = torch.zeros((rows,), dtype=torch.int32)
                full = torch.full((rows,), seq, dtype=torch.int32)

                def run():
                    lm.prefill_paged(params, inputs, cfg, pool, tables, slots, zero, full,
                                     page_size, use_context=True)
        in_bytes = tree_bytes(inputs)
        if kind == "train" and mesh is not None:     # the global batch; the rank reads its rows
            in_bytes = in_bytes * rows // batch
        arg_bytes = tree_bytes(args) + in_bytes
        t1 = time.perf_counter()
        flops = FlopCounterMode(display=False)
        nbytes = ByteCounter()
        with flops, nbytes, shd.use_mesh(ctx):
            run()
    return _record(flops, nbytes, counter, arg_bytes, t0, t1)


def _record(flops: FlopCounterMode, nbytes: ByteCounter, collectives, arg_bytes: int,
            t0: float, t1: float) -> Dict[str, Any]:
    """A counted step's record fields (``count_step`` says which)."""
    by_flops = {str(k): int(v) for k, v in flops.get_flop_counts().get("Global", {}).items()}
    return {
        "analysis": {
            "dot_flops": float(sum(by_flops.values())),
            "mem_bytes": float(sum(nbytes.by_op.values())),
            "collectives": shd.counter_totals(collectives),
            "data_dependent_ops": nbytes.data_dependent,
        },
        "memory": {"argument_size_in_bytes": arg_bytes},
        "fits": arg_bytes <= DEVICE_BYTES,
        "top_flops": _top(by_flops),
        "top_bytes": _top(nbytes.by_op),
        "build_s": round(t1 - t0, 2),
        "count_s": round(time.perf_counter() - t1, 2),
    }


# How a multi-pod cell runs, recorded beside its counts.
MULTI_EXECUTION = {
    "train": "FSDP: the state's blocks by state_sharding_tree, the batch's rows split over "
             "pod x data; the model axis splits storage only (a rank computes its rows with "
             "whole weights, gathered a layer group at a time)",
    "prefill": "pod x data replicas of a model-wide exact serving group "
               "(Scheduler(tp=model)'s lm.prefill_paged), at the rank's rows",
    "decode": "pod x data replicas of a model-wide exact serving group "
              "(Scheduler(tp=model)'s lm.decode_step_paged), at the rank's rows",
}


def run_cell(arch: str, shape_name: str, out_dir: pathlib.Path, force: bool = False,
             mesh: str = MESH) -> Dict[str, Any]:
    """Count one (arch x shape) cell and persist its record: on ``MESH``
    the step of the shape's kind; on ``tp{N}`` the serving decode at N
    ranks (other kinds ``skipped:tp-decode-only``); on ``multi`` one rank
    of the reference's multi-pod mesh (``make_production_mesh(multi_pod=
    True)``), as ``MULTI_EXECUTION`` says."""
    store = ResultStore(out_dir)
    name = f"{arch}__{shape_name}__{mesh}"
    if name in store and not force:
        return store.get(name)
    entry = configs.entry(arch)
    shape = configs.SHAPES[shape_name]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch, "status": "pending",
    }
    if shape_name not in entry.shape_names():
        rec["status"] = "skipped:full-attention-500k"
    elif mesh.startswith("tp") and shape.kind != "decode":
        rec["status"] = "skipped:tp-decode-only"
    elif mesh not in (MESH, "multi") and not mesh.startswith("tp"):
        raise ValueError(f"unknown mesh {mesh!r}")
    if rec["status"] != "pending":
        store.put(name, rec, kind="dryrun")
        return rec
    cfg = entry.config()
    t0 = time.perf_counter()
    tp = int(mesh[2:]) if mesh.startswith("tp") else 1
    sizes = make_production_mesh(multi_pod=True) if mesh == "multi" else None
    try:
        rec.update(count_step(cfg, shape.kind, shape.global_batch, shape.seq_len,
                              "adafactor" if arch in ADAFACTOR_ARCHS else "adamw", tp,
                              mesh=sizes))
        rec["n_devices"] = math.prod(sizes.values()) if sizes else tp
        if sizes:
            rec["mesh_shape"] = sizes
            rec["execution"] = MULTI_EXECUTION[shape.kind]
        rec["status"] = "ok"
        print(f"[{arch} x {shape_name} x {mesh}] OK flops={rec['analysis']['dot_flops']:.3e} "
              f"bytes={rec['analysis']['mem_bytes']:.3e} fits={rec['fits']} "
              f"build={rec['build_s']}s count={rec['count_s']}s")
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[{arch} x {shape_name} x {mesh}] FAILED: {rec['error']}")
    store.put(name, rec, kind="dryrun", wall_s=time.perf_counter() - t0)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single",
                    help="single: one H100; multi: one rank of the reference's multi-pod "
                         "mesh (pod 2, data 16, model 16): the FSDP train step, the "
                         "tensor-parallel serving steps")
    ap.add_argument("--tp", type=int, default=0,
                    help="decode cells as the tensor-parallel serving program over N cards, "
                         "one rank counted")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    if args.tp:
        meshes = [f"tp{args.tp}"]
    else:
        meshes = {"single": [MESH], "multi": ["multi"], "both": [MESH, "multi"]}[args.mesh]
    archs = [args.arch] if args.arch else configs.ARCH_NAMES
    shapes = [args.shape] if args.shape else list(configs.SHAPES)
    n = collections.Counter()
    for arch in archs:
        for shape_name in shapes:
            for mesh in meshes:
                s = run_cell(arch, shape_name, out_dir, args.force, mesh)["status"]
                n["ok" if s == "ok" else "failed" if s == "error" else "skipped"] += 1
    print(f"dry-run summary: ok={n['ok']} failed={n['failed']} skipped={n['skipped']}")
    return 0 if n["failed"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
