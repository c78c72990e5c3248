"""The kernel classifier and labels on sample names from the card's traces."""

import pytest

from portbench.kernels import kernel_class, kernel_label

K1 = ("void attn_fwd_kernelILi128ELb1ELb0ELi1ELb0ELb1ELb0EEvPK13__nv_bfloat16S2_S2_PS0_"
      "Pf14CUtensorMap_st")
K3 = "void attn_fwd_kernelILi128ELb0ELb0ELi1ELb0ELb1ELb0EEvPK13__nv_bfloat16"


@pytest.mark.parametrize("name,cls", [
    (K1, "attention"), (K3, "attention"), ("void rope_rotate_kernel<128>(...)", "attention"),
    ("void attn_bwd_kernelILi128ELb0ELb0EE", "attention_backward"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_warpgroupsize2x1x1", "gemm"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>", "gemm"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel", "elementwise"),
    ("sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw", "convolution"),
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", "collective"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>",
     "elementwise"),
    ("Memcpy DtoH (Device -> Pageable)", "elementwise"),
])
def test_class(name, cls):
    assert kernel_class(name) == cls


def test_labels():
    assert kernel_label(K1) == "K1 clamped D128"
    assert kernel_label(K3) == "K2/K3 clamped D128"
    assert kernel_label("void attn_fwd_kernelILi64ELb0ELb1ELi1ELb1ELb1ELb1EE") == \
        "K5 online D64 fp32"
    assert kernel_label("void attn_bwd_kernelILi128ELb1ELb0EE") == "K4 main online D128"
    assert kernel_label("x" * 100) == "x" * 60


def test_labels_of_demangled_names():
    name = ("void (anonymous namespace)::attn_fwd_kernel<128, true, false, 1, false, true, false>"
            "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, float*)")
    assert kernel_class(name) == "attention"
    assert kernel_label(name) == "K1 clamped D128"
    assert kernel_label("void attn_bwd_kernel<64, false, true>(...)") == "K4 main clamped D64 fp32"


@pytest.mark.parametrize("name,label", [
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
     "at::native::BinaryFunctor<float, float, float, at::native::binary_internal::MulFunctor<"
     "float> > >(at::TensorIteratorBase&)::{lambda(int)#1}>(int)", "elementwise_kernel MulFunctor"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<"
     "float, float, float, float>, unsigned int, float, 4> >(...)", "reduce_kernel MeanOps"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous "
     "namespace)::OpaqueType<2u>, unsigned int, 4, 64, 64>(...)", "CatArrayBatchedCopy"),
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN",
     "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN"),
])
def test_library_labels(name, label):
    assert kernel_label(name) == label
