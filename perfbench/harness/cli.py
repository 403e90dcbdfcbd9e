"""``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell, its result as the last line of
standard output.

The run needs the card: without CUDA, or with fewer cards than the cell
asks for, it prints no result and exits 2.  With ``--trace 0`` the
result holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, ``device.busy_s`` and ``window_s`` and a
``breakdown``.  The numbers that decide ``correct`` are printed beside
their limits as the last lines of standard error and under ``checks``,
the result's last key.  A run whose process holds JAX or the JAX package
once the window has closed prints no result and exits 3.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import sys

from . import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
METRICS = pathlib.Path(__file__).resolve().parents[1] / "metrics"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reader(name: str):
    path = METRICS / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def passed(check: dict) -> bool:
    v, lim = check["value"], check["limit"]
    ok = v >= lim if check.get("least") else v <= lim
    return bool(ok) and v == v            # a NaN never passes


def result(cell, seed: int, seconds: float, trace: bool, device, t_process: float) -> dict:
    """Run the cell and assemble its result line (no look for a card here)."""
    import torch

    runner = importlib.import_module(f"harness.{cell.traffic['kind']}")
    run = runner.run(cell, seed, seconds, trace, device, t_process)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": all(passed(c) for c in run.checks.values()),
           "attempted": int(run.attempted), "failed": int(run.failed), "metrics": metrics}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace and run.trace is not None:
        from . import trace as tr

        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.span_s
        out["device"] = dev
        out["breakdown"] = tr.breakdown(run.trace)
    else:
        out["device"] = dev
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in run.checks.items()}
    out["_run"] = run
    return out


def main(argv, t_process: float) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.Cell.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = result(cell, args.seed, args.seconds, bool(args.trace), device, t_process)
    run = out.pop("_run")
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process holds {bad} after the window", file=sys.stderr)
        return 3
    detail = {k: {kk: vv for kk, vv in c.items() if kk not in ("value", "limit")}
              for k, c in run.checks.items()}
    print(f"perfbench: {cell.name} seed {args.seed}: {json.dumps(detail)}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
