"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet,
dense rates without sparsity, at the 700 W limit).  Every roofline share
and ``mfu`` of the benchmark is stated against these numbers, with the
card's power limit printed beside them."""

BF16_FLOPS = 989e12          # tensor cores, bf16 / fp16
FP32_FLOPS = 67e12           # CUDA cores, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
