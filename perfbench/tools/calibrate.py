"""The readings the limits of ``cells/<cell>.json`` were set from, on the
card at the cell's own size (not part of a benchmark run; PERF.md keeps
the readings and the limits):

    python3 perfbench/tools/calibrate.py --workload <cell> --seconds 15 \
        --seeds 11,12,...  [--control 3] [--faults 3]

For each seed a whole run of the cell (set-up, a window of ``--seconds``
at the cell's own load, the reference, the comparison): the lower
readings.  For the first ``--control`` seeds the control (the reference
in fp8 in the program's place): the upper readings.  For a training
cell, on the first ``--faults`` seeds, the planted faults of
``tests/test_pb_faults.py`` (half the batch left out; a state left
unchanged reads 1 and needs no run).  One JSON line a reading.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src"), str(ROOT / "perfbench/tests")]

from harness import cli, control, spec, train_closed_loop  # noqa: E402


def _values(checks):
    return {k: c["value"] for k, c in checks.items()}


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    device = torch.device("cuda", 0)
    cell = spec.Cell.load(ROOT, args.workload, spec.load_bench(ROOT, parked=True))
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        out = cli.result(cell, seed, args.seconds, False, device, t)
        run = out.pop("_run")
        line = {"seed": seed, "kind": "sound", **_values(run.checks),
                "metrics": {k: m["value"] for k, m in out["metrics"].items()},
                "seconds": time.perf_counter() - t}
        if cell.traffic["kind"] == "train_closed_loop":
            line["leaves"] = {k: c.get("leaf") for k, c in run.checks.items()}
            line["program"], line["reference"] = run.program, run.reference
        print(json.dumps(line), flush=True)
        if i < args.control:
            t = time.perf_counter()
            if cell.traffic["kind"] == "serve_open_loop":
                c = {"worst_gap": control.serve_gap(cell, run, seed, device)}
            else:
                c = _values(control.train_checks(cell, seed, device))
            print(json.dumps({"seed": seed, "kind": "control", **c,
                              "seconds": time.perf_counter() - t}), flush=True)
        del run
        if i < args.faults and cell.traffic["kind"] == "train_closed_loop":
            from test_pb_faults import _faulty

            t = time.perf_counter()
            bad = train_closed_loop.run(cell, seed, 1.0, False, device, t,
                                        make_step=_faulty("half_batch"))
            print(json.dumps({"seed": seed, "kind": "half_batch", **_values(bad.checks),
                              "seconds": time.perf_counter() - t}), flush=True)
            del bad
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
