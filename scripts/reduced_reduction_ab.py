#!/usr/bin/env python3
"""qwen2.5-3b's float serve on one card with cuBLAS's bf16/f16
reduced-precision reduction allowed (PyTorch's default) and off (what
``repro_torch.device.resolve`` sets on a CUDA device), in turns.

    python3 scripts/reduced_reduction_ab.py [--order on,off,off,on] [--root DIR] [--skip-lint]

One set of full-size params (bf16, 36 layers, drawn from seed 0) serves
``chip_smoke.py``'s step-4 trace (8 requests over a shared 256-token
prefix) once per entry of ``--order``; each run is held to the ``Engine``
teacher-forced on the served sequences under the same setting.  The
setting is pinned for the whole run: the port's entry points call
``resolve``, which would turn the reduction off again, so the script
holds cuBLAS's two setters to the run's value while it serves.  Prints
one line a run (decode-step median, tokens/s, worst logit gap, exact
argmax share) beside the card's name and power limit.  Then the contract
lint's ``train.train_step`` (bf16 params and compute) under each
setting: its precision check's error count (the fault the repair
removes).  Last, a JSON line.  ``--root DIR`` imports the port from
another checkout (another commit unpacked under ``build/``; its serve
helpers only, with ``--skip-lint`` where it has no lint), so that two
commits can be compared in turns within one call.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def pinned_reduction(allow: bool):
    """Hold cuBLAS's bf16 and f16 reduced-precision-reduction flags at
    ``allow`` until the block ends, whatever sets them meanwhile."""
    import torch

    m = torch.backends.cuda.matmul
    m.allow_bf16_reduced_precision_reduction = allow
    m.allow_fp16_reduced_precision_reduction = allow
    names = ("_set_cublas_allow_bf16_reduced_precision_reduction",
             "_set_cublas_allow_fp16_reduced_precision_reduction")
    real = {n: getattr(torch._C, n) for n in names}
    for n in names:
        setattr(torch._C, n, lambda *a, _n=n: real[_n](allow, *a[1:]))
    try:
        yield
    finally:
        for n in names:
            setattr(torch._C, n, real[n])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", default="on,off,off,on",
                    help="reduced-precision reduction per run: on (allowed) or off")
    ap.add_argument("--root", default=ROOT, help="the checkout whose port is imported")
    ap.add_argument("--skip-lint", action="store_true", help="skip the contract lint part")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("reduced_reduction_ab: needs a card", file=sys.stderr)
        return 1
    from repro_torch import smoke
    from repro_torch.device import resolve

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0)
    dev = resolve("cuda")
    sizes = smoke.SERVE_FULL
    cfg = smoke._family_cfg(smoke.ARCH, True)
    params, _ = smoke._draw_params("reduced_reduction_ab", smoke.ARCH, cfg, dev)
    reqs = smoke.serve_trace(sizes, cfg.vocab_size)
    runs = []
    for i, mode in enumerate(args.order.split(",")):
        with pinned_reduction(mode == "on"):
            m = torch.backends.cuda.matmul
            flags = (m.allow_bf16_reduced_precision_reduction,
                     m.allow_fp16_reduced_precision_reduction)
            chk = smoke._serve_and_check(f"float reduced={mode} #{i}", cfg, params, sizes, reqs,
                                         None)
            after = (m.allow_bf16_reduced_precision_reduction,
                     m.allow_fp16_reduced_precision_reduction)
            if not after == flags == ((mode == "on"),) * 2:
                raise RuntimeError(f"the reduction setting moved during the run: {flags} -> "
                                   f"{after}")
        dec = np.asarray(chk.stats.decode_step_s)
        tokens = [list(map(int, r.generated)) for r in chk.results]
        run = {"mode": mode, "decode_median_ms": float(np.median(dec) * 1e3),
               "tokens_per_s": chk.stats.generated_tokens / chk.seconds,
               "worst_gap": chk.worst_gap, "exact_share": chk.exact_share, "tokens": tokens}
        runs.append(run)
        print(f"reduced_reduction_ab on {card}: reduced reduction {mode}: decode median "
              f"{run['decode_median_ms']:.2f} ms over {dec.size} steps, "
              f"{run['tokens_per_s']:.1f} tokens/s, worst logit gap {chk.worst_gap:.4g}, "
              f"exact argmax {chk.exact_share:.3f}")
    same = {m: [r["tokens"] for r in runs if r["mode"] == m] for m in ("on", "off")}
    for m, toks in same.items():
        if toks:
            print(f"reduced_reduction_ab: reduced {m}: runs' tokens equal to each other: "
                  f"{all(t == toks[0] for t in toks)}")
    if same["on"] and same["off"]:
        a, b = same["on"][0], same["off"][0]
        eq = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
        n = sum(len(r) for r in a)
        print(f"reduced_reduction_ab: {eq} of {n} served tokens equal between on and off")
    lint = {}
    for mode in () if args.skip_lint else ("on", "off"):
        from repro_torch.analysis.lint import run_lint

        with pinned_reduction(mode == "on"):
            rep = run_lint(checks=["precision"], contracts=["train.train_step"], device="cuda")
        errs = rep.by_severity("error")
        lint[mode] = len(errs)
        print(f"reduced_reduction_ab: lint train.train_step, reduced reduction {mode}: "
              f"{len(errs)} precision error(s)" + (f"; first: {errs[0].message}" if errs else ""))
    print(json.dumps({"card": card, "root": os.path.abspath(args.root), "lint_errors": lint,
                      "runs": [{k: v for k, v in r.items() if k != "tokens"} for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
