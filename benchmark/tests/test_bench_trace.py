"""The trace reader's classes and its idle gaps, on names and intervals
given by hand (the card's profiler runs only in a chip run)."""

import pytest

from benchmark import trace

CUDNN_FPROP = ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize256x64x8"
               "_stage3_warpsize2x2x1_g1_ffma_aligna4_alignc4_execute_kernel__5x_cudnn")


@pytest.mark.parametrize("kernel,ops,kind", [
    ("void (anonymous namespace)::gdn_kernel<192, true>(CUtensorMap_st, ...)", [], "K1"),
    ("void gdn_general_tma_kernel<float>(...)", [], "gdn_general"),
    ("rans_fields_kernel", [], "K3"), ("rans_encode_kernel", [], "K3"),
    ("rans_decode_on_chip", [], "K2"), ("Memcpy HtoD (Pinned -> Device)", [], "copies"),
    (CUDNN_FPROP, ["aten::cudnn_convolution", "aten::convolution", "aten::conv2d"], "conv_forward"),
    (CUDNN_FPROP, [], "conv_forward"),  # launched from a pipeline worker thread
    ("sm80_xmma_dgrad_implicit_gemm_f32", [], "conv_backward"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<float>", [], "conv_forward"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<float>",
     ["aten::convolution_backward"], "conv_backward"),
    ("void at::native::vectorized_elementwise_kernel<4, MulFunctor>", ["Optimizer.step#Adam.step"],
     "adam"),
    ("void at::native::vectorized_elementwise_kernel<4, MulFunctor>", [], "other"),
])
def test_kind_of(kernel, ops, kind):
    assert trace.kind_of(kernel, ops) == kind


def test_union_gaps():
    assert trace._union_gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [(0, 2), (6, 8), (9, 10)]
    assert trace._union_gaps([], 0, 5) == [(0, 5)]
    assert trace._union_gaps([(0, 10)], 0, 10) == []


def test_spans_are_kept_only_while_recording():
    rec = trace.Recorder("cpu")
    with rec.span("feed"):
        pass
    assert rec.spans == []
    with rec.record(), rec.span("train_step"):
        pass
    assert [s[2] for s in rec.spans] == ["train_step"] and rec.spans[0][0] <= rec.spans[0][1]
