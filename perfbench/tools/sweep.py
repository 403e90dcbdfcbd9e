"""The knee of a serving cell: its traffic at several fixed rates, one
window each, on the card.  Not part of a benchmark run: it is how the
rate in ``cells/<cell>.json`` was chosen (PERF.md keeps the sweep).

    python3 perfbench/tools/sweep.py --workload <cell> --seconds 30 --rates 2,3,4,5

For each rate it prints the requests due, their first tokens and
completions by the close, the backlog (due, no first token) at the
close, the time to first token of the first and the last third of the
arrivals (a growing queue shows as the last third's being far larger),
and the two tails.
"""
import argparse
import dataclasses
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]

from harness import serve_open_loop, spec, stats  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=4242)
    args = ap.parse_args(argv)
    import torch

    device = torch.device("cuda", 0)
    base = spec.Cell.load(ROOT, args.workload)
    for rate in [float(x) for x in args.rates.split(",")]:
        cell = dataclasses.replace(base, data={**base.data, "rate_per_s": rate})
        run = serve_open_loop.run(cell, args.seed, args.seconds, False, device,
                                  time.perf_counter(), judge=False)
        recs, end = run.records, run.end
        ttft = stats.ttft_samples([r.due for r in recs], [r.first for r in recs], end)
        itl = stats.itl_samples([r.times for r in recs], [r.done_by(end) for r in recs], end)
        third = max(1, len(ttft) // 3)
        out = {"rate": rate, "due": len(recs),
               "first_tokens": sum(r.first is not None and r.first <= end for r in recs),
               "done": sum(r.done_by(end) for r in recs),
               "backlog": sum(r.first is None or r.first > end for r in recs),
               "ttft_first_third_ms": 1e3 * statistics.median(ttft[:third]),
               "ttft_last_third_ms": 1e3 * statistics.median(ttft[-third:]),
               "ttft_p95_ms": 1e3 * stats.percentile(ttft, 95),
               "itl_p95_ms": 1e3 * stats.percentile(itl, 95),
               "decode_step_ms": 1e3 * statistics.mean(run.decode_step_s),
               "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30}
        print(json.dumps(out), flush=True)
        del run
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


if __name__ == "__main__":
    main(sys.argv[1:])
