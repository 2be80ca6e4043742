"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): float32 on the CUDA cores, TF32 on
the tensor cores, the HBM3 rate, and int32 on the CUDA cores (132 SMs x 64
INT32 lanes x the 1.98 GHz boost clock that gives the float32 figure)."""

FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12
INT32_OPS = 132 * 64 * 1.98e9
