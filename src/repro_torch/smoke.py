"""The port's main path, end to end, through its normal entry points.

    1. DSE: ``explore_multi`` over ``PAPER_SWEEP`` x W_store in
       {16384, 65536} (16 scenarios), with each scenario's front held to
       the brute-force oracle;
    2. provisioning: ``dcimmap.plan("qwen2.5-3b", ...)``;
    3. designs: ``distill`` the front to the best int8 and the best bf16
       point by energy-delay product;
    4. macro numerics at full width: every GEMM class of
       ``extract(qwen2.5-3b)`` through ``DCIMMacroSim.matmul`` of both
       designs on M = 128 token rows (weights N(0, 0.02), activations
       N(0, 1), from ``SEED`` with numpy).  The int8 path must equal the
       dequantized exact integer product of the quantized codes bitwise;
       the bf16 path's p90 relative error against the float32 product
       must stay under :func:`fp_error_bound` of the design's H.

``full=False`` runs the same steps at the smoke sizes (a short NSGA-II,
the reduced qwen2.5-3b config, 8 rows) — the CPU rehearsal the tests run.
``chip_smoke.py`` runs ``full=True`` on the card.  Every check raises.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from . import configs
from .core import precision
from .core.explorer import ParetoPoint, brute_force_front, distill, explore_multi
from .core.nsga2 import NSGA2Config
from .core.space import DesignSpace
from .dcimmap import extract, plan
from .kernels import cuda_lib, ref
from .device import resolve
from .sim.functional import DCIMMacroSim, quantize_sym

ARCH = "qwen2.5-3b"
W_STORES = (16384, 65536)
SCENARIOS = [(p.name, w) for p in precision.PAPER_SWEEP for w in W_STORES]
MIN_COVERAGE = 0.9     # the reference's own bar (test_front_coverage_vs_oracle)
SEED = 0


def fp_error_bound(H: int) -> float:
    """p90 bound on |y - x@w| / max(|x@w|, 1) for the bf16 (B_M = 8)
    design: 0.08 up to H = 32 (the reference's test_accuracy_vs_f32 bar
    at B_M = 8, H = 32), growing with log2 H beyond, since a larger group
    shifts its small members further below the group maximum."""
    return 0.08 * max(1.0, math.log2(H) / 5.0)


@dataclasses.dataclass
class GemmCheck:
    name: str
    K: int
    N: int
    int_exact: bool
    fp_p90: float
    fp_bound: float
    seconds: float


@dataclasses.dataclass
class SmokeResult:
    device: str
    front_sizes: Dict[str, int]
    coverage: Dict[str, float]
    plan_summary: str
    designs: Dict[str, ParetoPoint]
    gemms: List[GemmCheck]
    seconds: Dict[str, float]
    peak_bytes: int
    launches: Dict[str, int]   # kernel launches during this run (0 on the CPU)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _p90(rel: torch.Tensor) -> float:
    flat = rel.flatten()
    return float(torch.kthvalue(flat, max(1, math.ceil(0.9 * flat.numel()))).values)


def check_gemm(name, x, w, sim_int, sim_fp) -> GemmCheck:
    """One GEMM class through both designs, with its checks."""
    t0 = time.perf_counter()
    p = sim_int.precision
    y_int = sim_int.matmul(x, w)
    qx, sx = quantize_sym(x, p.B_x)
    qw, sw = quantize_sym(w, p.B_w)
    # Every partial sum of the codes is an integer below 2^53: exact in f64.
    exact = torch.matmul(qx.to(torch.float64), qw.to(torch.float64)).to(torch.int32)
    int_exact = torch.equal(y_int, exact.to(torch.float32) * (sx * sw))

    y_fp = sim_fp.matmul(x, w)
    want = ref.fp_matmul_f32_ref(x, w)
    rel = torch.abs(y_fp - want) / torch.clamp_min(torch.abs(want), 1.0)
    H = math.gcd(sim_fp.H, x.shape[-1])
    chk = GemmCheck(name, x.shape[1], w.shape[1], bool(int_exact), _p90(rel),
                    fp_error_bound(H), 0.0)
    _sync(x.device)
    chk.seconds = time.perf_counter() - t0
    if not chk.int_exact:
        raise AssertionError(f"{name}: int8 path differs from the exact integer product")
    if not chk.fp_p90 < chk.fp_bound:
        raise AssertionError(
            f"{name}: bf16 p90 rel err {chk.fp_p90:.4g} >= bound {chk.fp_bound:.4g} (H={H})"
        )
    return chk


def run(device="cuda", full: bool = True) -> SmokeResult:
    dev = resolve(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    # The float32 yardstick of the bf16 path must be a full-precision product.
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _run(dev, full)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _run(dev, full) -> SmokeResult:
    seconds: Dict[str, float] = {}
    launches0 = dict(cuda_lib.launches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # 1. DSE over 16 scenarios, fronts held to the brute-force oracle.
    cfg = NSGA2Config() if full else NSGA2Config(pop_size=32, generations=8)
    t0 = time.perf_counter()
    pts = explore_multi(SCENARIOS, cfg, device=dev)
    seconds["explore_multi"] = time.perf_counter() - t0
    dse_launches = cuda_lib.launches["dominance"] - launches0["dominance"]
    by_scen = Counter((p.precision, p.w_store) for p in pts)
    front_sizes, coverage = {}, {}
    t0 = time.perf_counter()
    for prec, w in SCENARIOS:
        key = f"{prec}/{w}"
        oracle = brute_force_front(DesignSpace(precision.get(prec), w), dev)
        want = {tuple(g) for g in oracle}
        got = {tuple(p.genes) for p in pts if (p.precision, p.w_store) == (prec, w)}
        front_sizes[key] = by_scen[(prec, w)]
        coverage[key] = len(got & want) / len(want)
        if full and coverage[key] < MIN_COVERAGE:
            raise AssertionError(f"{key}: NSGA-II covers {coverage[key]:.2f} of the oracle front")
    seconds["oracle"] = time.perf_counter() - t0
    print(f"explore_multi: {len(pts)} points over {len(SCENARIOS)} scenarios in "
          f"{seconds['explore_multi']:.2f} s (pop {cfg.pop_size}, {cfg.generations} generations, "
          f"{dse_launches} dominance launches)")
    print("front sizes: " + " ".join(f"{k}={v}" for k, v in front_sizes.items()))
    print("oracle coverage: " + " ".join(f"{k}={v:.3f}" for k, v in coverage.items()))

    # 2. Provisioning.
    t0 = time.perf_counter()
    mp = plan(ARCH, precision=["int8", "bf16"], w_store=list(W_STORES),
              cfg_nsga=None if full else cfg, device=dev)
    seconds["plan"] = time.perf_counter() - t0
    print(f"plan: {mp.summary()}")
    print(f"plan: chosen macro {mp.point.summary()}")

    # 3. Designs.
    designs = {
        prec: distill([p for p in pts if p.precision == prec], sort_by="edp")[0]
        for prec in ("int8", "bf16")
    }
    sims = {prec: DCIMMacroSim.from_point(p) for prec, p in designs.items()}
    for prec, p in designs.items():
        print(f"design {prec}: {p.summary()}")

    # 4. Macro numerics at full width.
    lmcfg = configs.get_config(ARCH) if full else configs.get_smoke_config(ARCH)
    M = 128 if full else 8
    rng = np.random.default_rng(SEED)
    gemms: List[GemmCheck] = []
    seconds["weights"] = 0.0
    for g in extract(lmcfg).gemms:
        t0 = time.perf_counter()
        x = torch.from_numpy(rng.standard_normal((M, g.K), dtype=np.float32)).to(dev)
        w = rng.standard_normal((g.K, g.N), dtype=np.float32)
        w *= np.float32(0.02)
        w = torch.from_numpy(w).to(dev)
        seconds["weights"] += time.perf_counter() - t0
        chk = check_gemm(g.name, x, w, sims["int8"], sims["bf16"])
        gemms.append(chk)
        print(f"gemm {g.name:<9} {M}x{g.K}x{g.N}: int8 exact={chk.int_exact} "
              f"bf16 p90 rel err {chk.fp_p90:.4g} < {chk.fp_bound:.4g} "
              f"(H={math.gcd(sims['bf16'].H, g.K)}) [{chk.seconds:.2f} s]")
        del x, w
    seconds["numerics"] = sum(c.seconds for c in gemms)
    print("host seconds: " + " ".join(f"{k} {v:.2f}" for k, v in seconds.items()))

    launches = {k: n - launches0[k] for k, n in cuda_lib.launches.items()}
    peak = 0
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"peak device memory: {peak / 2**30:.2f} GiB")
        print("kernel launches: " + " ".join(f"{k}={n}" for k, n in launches.items()))
        idle = [k for k, n in launches.items() if n == 0]
        if idle:
            raise AssertionError(f"the main path never launched {idle}")
    return SmokeResult(
        device=str(dev), front_sizes=front_sizes, coverage=coverage,
        plan_summary=mp.summary(), designs=designs, gemms=gemms,
        seconds=seconds, peak_bytes=int(peak), launches=launches,
    )
