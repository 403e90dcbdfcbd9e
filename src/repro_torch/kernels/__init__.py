"""Hand-written Hopper kernels for the SEGA-DCIM hot spots, each beside
its plain PyTorch version: pareto_rank (NSGA-II dominance), dcim_mvm
(the DCIM MAC: base-256 digit products on the int8 tensor cores; the
plain version keeps the bit-serial dataflow), fp_prealign (FP
pre-alignment), paged_attention (paged GQA decode, [context ; causal
tail] prefill and paged absorbed-MLA decode), selective_scan (the
Mamba-1 recurrence).  CUDA sources are in ``repro_torch/csrc`` and are
built at first use (``cuda_lib``)."""
from . import cuda_lib, ops, ref  # noqa: F401
