"""cuDNN's convolution kernels are classed by their names wherever the CPU
ops they were launched under name no class: a traced round on the card
links a few of them to the profiler's own ``Buffer Flush`` record, or to a
convolution op without the ``aten::convolution`` above it, and those
counted as ``other`` would leave the convolutions' device time short of
their work."""

import pytest

from benchmark import trace
from benchmark.tests.test_bench_trace import CUDNN_FPROP

NCHW_TO_NHWC = "void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false, true>"
CUBLAS_GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3_execute_kernel__5x_cublas"


@pytest.mark.parametrize("kernel,ops,kind", [
    (CUDNN_FPROP, ["Buffer Flush", "cudaEventSynchronize"], "conv_forward"),
    (CUDNN_FPROP, ["aten::cudnn_convolution"], "conv_forward"),
    (CUDNN_FPROP, ["aten::copy_"], "conv_forward"),
    (NCHW_TO_NHWC, ["aten::add"], "conv_forward"),
    ("sm80_xmma_dgrad_implicit_gemm_f32", ["aten::mul"], "conv_backward"),
    ("void cudnn::winograd_nonfused::winogradWgradData4x4<float, float>",
     ["autograd::engine::evaluate_function: ConvolutionBackward0",
      "aten::convolution_backward"], "conv_backward"),
    (CUDNN_FPROP, ["aten::convolution_backward"], "conv_backward"),
    (CUBLAS_GEMM, ["aten::mm"], "other"),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor>", ["aten::add"], "other"),
])
def test_a_cudnn_kernel_under_ops_that_name_no_class(kernel, ops, kind):
    assert trace.kind_of(kernel, ops) == kind
