"""DCIM functional simulator: execute real MVM workloads *as the
generated macro would*, bit-exactly, with cycle/energy accounting from
the cost model.

``DCIMMacroSim`` wraps one explored design point:

  * ``mvm(x, w)`` — integer path: per-tensor symmetric quantization to
    B_x/B_w bits, exact bit-serial MAC (``kernels.ops.dcim_mvm``, the K2
    kernel on the card), dequantize.
  * ``mvm_fp(x, w)`` — pre-aligned block-FP path
    (``kernels.ops.dcim_fp_matmul``: K3 on x and w^T, then K2 over all
    groups) with group height H from the design.
  * ``account(M, K, N)`` — cycles / latency / energy for that workload on
    this macro (tiling over N columns x H rows, B_x/k cycles per pass),
    which is what the dcimmap layer aggregates per architecture.

The numerics run on the device of their inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from ..core.cells import CALIBRATED, TechParams, TSMC28
from ..core.explorer import ParetoPoint
from ..core.macros import macro_costs, physical
from ..core.precision import Precision, get as get_precision
from ..dist.sharding import group_amax
from ..kernels import ops
from ..models import common as _common


def quantize_sym(x: torch.Tensor, bits: int, amax=None):
    """Per-tensor symmetric quantization -> (int32 codes, scale), the
    scale from ``amax`` (by default ``max |x|``).

    The clip range is symmetric ([-qmax, qmax], NOT the two's-complement
    [-qmax-1, qmax]): the scale is ``amax / qmax``, so the ``-qmax-1``
    code would dequantize outside the representable range the scale
    promises."""
    amax = torch.clamp_min(torch.max(torch.abs(x)) if amax is None else amax, 1e-12)
    qmax = 2 ** (bits - 1) - 1
    scale = amax / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)
    return q, scale


@dataclasses.dataclass
class DCIMMacroSim:
    precision: Precision
    N: int
    H: int
    L: int
    k: int
    tech: TechParams = CALIBRATED
    activity: float = 1.0

    @classmethod
    def from_point(cls, p: ParetoPoint, **kw) -> "DCIMMacroSim":
        return cls(precision=get_precision(p.precision), N=p.N, H=p.H, L=p.L,
                   k=p.k, **kw)

    @property
    def w_store(self) -> int:
        return self.N * self.H * self.L // self.precision.B_w

    # --- numerics -----------------------------------------------------------
    def mvm(self, x: torch.Tensor, w: torch.Tensor, shard: bool = False) -> torch.Tensor:
        """Integer DCIM execution of y = x @ w (float in/out).  ``shard``:
        ``w`` is this rank's block of a weight's columns under a serving
        mesh, whose scale is the whole weight's, from the group maximum
        of ``|w|`` (x is whole at every product)."""
        p = self.precision
        if p.is_fp:
            raise ValueError(f"mvm: {p.name} is a floating-point design; use mvm_fp")
        qx, sx = quantize_sym(x, p.B_x)
        qw, sw = quantize_sym(w, p.B_w, group_amax(w) if shard else None)
        y = ops.dcim_mvm(qx, qw, B_x=p.B_x, B_w=p.B_w, k=self.k)
        return y.to(torch.float32) * (sx * sw)

    def mvm_fp(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Pre-aligned block-FP DCIM execution (group height = H)."""
        p = self.precision
        if not p.is_fp:
            raise ValueError(f"mvm_fp: {p.name} is an integer design; use mvm")
        H = math.gcd(self.H, x.shape[-1])
        return ops.dcim_fp_matmul(x, w, H=H, B_M=p.B_M, B_w=p.B_w, k=self.k)

    def __call__(self, x, w, shard: bool = False):
        # The block-FP design's pre-alignment groups run along K, which
        # no serving mesh shards: a block of columns needs nothing more.
        return self.mvm_fp(x, w) if self.precision.is_fp else self.mvm(x, w, shard)

    def matmul(self, x: torch.Tensor, w: torch.Tensor, shard: bool = False) -> torch.Tensor:
        """Rank-polymorphic ``x @ w`` through the macro's numerics:
        x (..., K) @ w (K, N) -> (..., N) (the shape contract of a dense
        projection, so the sim can stand in for every model projection;
        ``shard`` as :meth:`mvm`'s).  Any layout is taken, as
        ``torch.matmul`` takes it: the operands are made contiguous for
        the kernels (an einsum's output, such as the SSM decode's conv,
        may come transposed)."""
        K = x.shape[-1]
        y = self(x.reshape(-1, K).to(torch.float32).contiguous(),
                 w.to(torch.float32).contiguous(), shard)
        return y.reshape(x.shape[:-1] + (w.shape[-1],))

    # --- cost accounting ------------------------------------------------------
    def account(self, M: int, K: int, N_out: int) -> dict:
        """Latency/energy for an (M, K) x (K, N_out) MVM stream on this
        macro.  The array holds H*L rows x (N/B_w) weight columns per
        load; weights are streamed in tiles; inputs take ceil(B_x/k)
        cycles per row-pass (the paper's throughput model).  Scalar cost
        model evaluation, on the CPU."""
        p = self.precision
        costs = macro_costs(
            float(self.N), float(self.H), float(self.L), float(self.k), p, TSMC28
        )
        phys = physical(costs, self.tech, self.activity)
        cols_per_load = self.N // p.B_w          # output channels resident
        rows_per_pass = self.H                   # reduction rows per pass
        passes_k = math.ceil(K / rows_per_pass)
        loads_n = math.ceil(N_out / (cols_per_load * self.L))
        cycles_per_pass = math.ceil(p.B_x / self.k)
        total_cycles = M * passes_k * loads_n * cycles_per_pass * self.L
        delay_ns = float(phys.delay_ns)
        energy_nJ = float(phys.energy_nJ)
        lat_ns = total_cycles * delay_ns
        return {
            "cycles": int(total_cycles),
            "latency_us": lat_ns * 1e-3,
            "energy_uJ": total_cycles * energy_nJ * 1e-3,
            "macs": M * K * N_out,
            "tops_effective": (2.0 * M * K * N_out) / max(lat_ns, 1e-9) * 1e-3,
            "weight_loads": loads_n * passes_k,
        }


@contextlib.contextmanager
def dcim_numerics(sim: DCIMMacroSim):
    """Route every ``models.common.dense`` matmul through ``sim`` while
    the context is active: Engine prefill / decode and the Scheduler's
    programs then run their projections (the lm_head included) with the
    macro's numerics (bit-serial integer, or pre-aligned block-FP)
    instead of the float path.  The hook is read at call time."""
    prev = _common.set_mvm_impl(sim.matmul)
    try:
        yield sim
    finally:
        _common.set_mvm_impl(prev)


# ------------------------------ lint contract --------------------------------
from ..analysis.registry import Built, ExactnessGate, PrecisionPolicy, register_contract  # noqa: E402,E501


@register_contract(
    "sim.dcim_serve",
    checks=("precision",),
    description="dcim_sim-routed serve programs recorded at int8 and fp8 under a bf16 "
                "lossless-cache config: every dense MVM must provably route through the "
                "quantize->dcim_mvm/dcim_fp_matmul pipeline (zero raw float products in the "
                "dense island), the quantizer clip / pre-align constants must recover the "
                "core.precision bit widths, and the exactness gates must re-derive from the "
                "bf16 pool leaves.  Always recorded on the CPU, whatever the device: on the "
                "card the pre-align scale lives inside K3, as the reference's constants "
                "were read from its kernels in interpret mode",
)
def _build_dcim_serve_contract(device) -> Built:
    import numpy as np

    from ..analysis.op_trace import pool_leaf_specs, record
    from ..configs import get_smoke_config
    from ..models import lm
    from ..serve.scheduler import _burst_prefill_fn, _decode_paged_fn

    dev = torch.device("cpu")
    # bf16 compute with a bf16 (lossless, cache == compute) pool: the gates
    # claim enabled and the precision check re-derives that.
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), param_dtype="bfloat16",
                              compute_dtype="bfloat16", cache_dtype="bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, dev)
    S, page_size, pages_per_slot = 2, 8, 4
    pool = lm.init_paged_pool(cfg, S, S * pages_per_slot + 1, page_size, dev)
    B, T = 2, 8

    def z(n, dtype=torch.int32):
        return torch.zeros(n, dtype=dtype)

    def decode():
        return _decode_paged_fn(params, pool, z(S), z(S), z(S, torch.bool),
                                z((S, pages_per_slot)), np.zeros(S, np.int64),
                                np.zeros(S, np.int64), np.zeros(S, np.float32), cfg=cfg)

    def prefill():
        return _burst_prefill_fn(params, pool, z((B, T)), z((B, pages_per_slot)),
                                 torch.arange(B, dtype=torch.int32), z(B),
                                 torch.full((B,), T, dtype=torch.int32),
                                 np.zeros(B, np.int64), np.zeros(B, np.float32), cfg=cfg,
                                 page_size=page_size, use_context=True)

    # One integer and one FP design point, macro dims matching the model
    # widths (fp group height 16 divides every reduction dim here).
    sims = {
        "int8": DCIMMacroSim(precision=get_precision("int8"), N=64, H=64, L=4, k=4),
        "fp8": DCIMMacroSim(precision=get_precision("fp8"), N=64, H=16, L=4, k=4),
    }
    programs, dcim_programs = [], {}
    with torch.no_grad():
        for name, sim in sims.items():
            with dcim_numerics(sim):
                programs += [(f"decode_{name}", record(decode)),
                             (f"prefill_{name}", record(prefill))]
            dcim_programs[f"decode_{name}"] = dcim_programs[f"prefill_{name}"] = name
    pool_leaves = pool_leaf_specs(pool)
    return Built(programs=programs, precision=PrecisionPolicy(
        compute_dtype=cfg.compute_dtype, dcim_programs=dcim_programs,
        gates=[ExactnessGate("prefix_reuse", True, "prefill_int8", pool_leaves),
               ExactnessGate("preempt", True, "decode_int8", pool_leaves)],
    ))
