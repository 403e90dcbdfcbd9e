#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card, and hold every
hand-written kernel on that path against its plain PyTorch version.

    python3 chip_smoke.py            # from the root of a checkout, one card

Steps, each of which raises on failure (the exit code is then non-zero
and no result line is printed):

  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  3. with every launch count set to 0, run ``repro_torch.smoke.run``: the
     16-scenario DSE at the default NSGA-II config with oracle coverage,
     ``dcimmap.plan("qwen2.5-3b", ...)``, the best int8 and bf16 designs,
     and every qwen2.5-3b GEMM class at full width through both designs;
     then read the counts, each of which must be > 0;
  4. at the main path's shapes, compare each kernel with its plain
     version on the card (bitwise) and time both with CUDA events, beside
     the card's bound and, where one exists, a single PyTorch call that
     computes the same function;
  5. print the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
     line last.

It imports neither ``jax`` nor the ``repro`` package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s,
# int8 tensor-core ops/s, float32 (non-tensor) ops/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up,
    by CUDA events around the batch of runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(nbytes: float, ops: float, ops_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want) -> float:
    import torch

    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    if not same:
        raise AssertionError(f"{name}: kernel differs from its plain version (max |diff| {err})")
    return err


def check_kernels(result, launches, dev) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from repro_torch.core import nsga2, scenario
    from repro_torch.core.scenario import ScenarioTable
    from repro_torch.kernels import ref
    from repro_torch.kernels.dcim_mvm import dcim_mvm
    from repro_torch.kernels.fp_prealign import fp_prealign
    from repro_torch.kernels.pareto_rank import dominance_matrix
    from repro_torch.sim.functional import quantize_sym
    from repro_torch.smoke import SCENARIOS

    rows = []
    rng = np.random.default_rng(1)

    # K1 at the survivor-selection shape: 16 scenarios x (parents + children).
    table = ScenarioTable.from_specs(SCENARIOS, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    pop = nsga2.init_population(table, nsga2.NSGA2Config(pop_size=256), gen)
    F, v = scenario.evaluate(table, pop)
    S, P, M = F.shape
    err = compare("dominance", [dominance_matrix(F, v)], [ref.dominance_matrix_ref(F, v)])
    b_ms, b_by = bound(S * P * M * 4 + S * P * 4 + S * P * P, S * P * P * (2 * M + 3),
                       F32_OPS_PER_S)
    rows.append(dict(
        name="dominance", route="cuda", source="src/repro_torch/csrc/dominance.cu",
        replaces="src/repro/kernels/pareto_rank.py:44", launches=launches["dominance"],
        max_abs_err=err, ms=time_ms(lambda: dominance_matrix(F, v), 200),
        plain_ms=time_ms(lambda: ref.dominance_matrix_ref(F, v), 200),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"F {tuple(F.shape)}",
    ))

    d_int, d_fp = result.designs["int8"], result.designs["bf16"]
    K, N, Mr = 2048, 151936, 128                 # the lm_head GEMM, 128 token rows
    x = torch.from_numpy(rng.standard_normal((Mr, K), dtype=np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32) * np.float32(0.02)).to(dev)

    # K2 at the int8 design's lm_head call, and at the bf16 design's
    # batched group call (attn_q's width, to keep the plain version small).
    qx, _ = quantize_sym(x, 8)
    qw, _ = quantize_sym(w, 8)
    args = dict(B_x=8, B_w=8, k=d_int.k)
    err = compare("dcim_mvm", [dcim_mvm(qx, qw, **args)], [ref.dcim_mvm_ref(qx, qw, **args)])
    # The bound is the function's own (x @ w mod 2^32 on int32 codes): its
    # bytes, and one multiply-add per (m, k, n) at the int8 peak.  The
    # plane x slice decomposition does `pairs` times those operations;
    # that figure is printed beside it, not used as the bound.
    b_ms, b_by = bound(4 * (Mr * K + K * N + Mr * N), 2 * Mr * K * N, INT8_OPS_PER_S)
    pairs = 8 * math.ceil(8 / d_int.k) + 3
    decomp_ms, _ = bound(0.0, 2 * Mr * K * N * pairs, INT8_OPS_PER_S)
    # Yardstick only (the port never calls it): cuBLAS's int8 product of
    # the same codes, which computes the same function for these widths.
    qx8, qw8 = qx.to(torch.int8), qw.to(torch.int8)
    library_ms = time_ms(lambda: torch._int_mm(qx8, qw8), 5)
    rows.append(dict(
        name="dcim_mvm", route="cuda", source="src/repro_torch/csrc/dcim_mvm.cu",
        replaces="src/repro/kernels/dcim_mvm.py:92", launches=launches["dcim_mvm"],
        max_abs_err=err, ms=time_ms(lambda: dcim_mvm(qx, qw, **args), 3),
        plain_ms=time_ms(lambda: ref.dcim_mvm_ref(qx, qw, **args), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        shape=f"x {tuple(qx.shape)} w {tuple(qw.shape)} int8 k={d_int.k}",
        note=f"; the decomposition's {pairs} plane x slice dots alone take "
             f"{decomp_ms:.4f} ms at the int8 peak",
    ))
    H = math.gcd(d_fp.H, K)
    G = K // H
    mant_x, _ = fp_prealign(x.reshape(Mr, G, H).contiguous(), 8)
    mant_w, _ = fp_prealign(w[:, :2048].t().reshape(2048, G, H).contiguous(), 8)
    mx = mant_x.permute(1, 0, 2).contiguous()
    mw = mant_w.permute(1, 2, 0).contiguous()
    fargs = dict(B_x=9, B_w=9, k=d_fp.k)
    compare("dcim_mvm batched", [dcim_mvm(mx, mw, **fargs)], [ref.dcim_mvm_ref(mx, mw, **fargs)])
    print(f"check dcim_mvm batched {tuple(mx.shape)} @ {tuple(mw.shape)} bf16 k={d_fp.k}: "
          f"bitwise, {time_ms(lambda: dcim_mvm(mx, mw, **fargs), 3):.3f} ms")

    # K3 at the bf16 design's lm_head weight pre-alignment.
    wt = w.t().reshape(N, G, H).contiguous()
    err = compare("fp_prealign", list(fp_prealign(wt, 8)), list(ref.fp_prealign_ref(wt, 8)))
    n_el = N * G * H
    b_ms, b_by = bound(4 * n_el + 4 * n_el + 4 * N * G, 0.0, F32_OPS_PER_S)
    rows.append(dict(
        name="fp_prealign", route="cuda", source="src/repro_torch/csrc/fp_prealign.cu",
        replaces="src/repro/kernels/fp_prealign.py:54", launches=launches["fp_prealign"],
        max_abs_err=err, ms=time_ms(lambda: fp_prealign(wt, 8), 10),
        plain_ms=time_ms(lambda: ref.fp_prealign_ref(wt, 8), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"w^T {tuple(wt.shape)} B_M=8",
    ))
    for r in rows:
        print(f"check {r['name']} {r['shape']}: bitwise, max|diff| {r['max_abs_err']}, "
              f"launches {r['launches']}, {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library {r['library_ms']})"
              f"{r.get('note', '')}")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda_lib
    from repro_torch import smoke

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)

    build_s = cuda_lib.build(force=True)
    print(f"kernels built in {build_s:.2f} s into {cuda_lib.LIB_PATH}")
    cuda_lib.lib()

    t0 = time.perf_counter()
    cuda_lib.reset_launches()
    result = smoke.run(dev, full=True)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    print(f"main path: {time.perf_counter() - t0:.2f} s; launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = check_kernels(result, launches, dev)
    print(card)
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k not in ("shape", "note")}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
