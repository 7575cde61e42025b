"""profile_step's trace reduction: kernel classification against an HLO
excerpt of the GPU train step, and the least-work model."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import profile_step  # noqa: E402

HLO = """
  %p.1 = s8[8192,2048]{1,0} parameter(0)
  %p.2 = bf16[8192,2048]{1,0} parameter(1)
  %gemm_fusion_dot_general.113 = f32[8192,2048]{1,0} fusion(%p.1, %p.1), kind=kCustom, calls=%c, metadata={op_name="jit(train_step)/jvp()/while/body/closed_call/dot_general"}
  %gemm_fusion_dot_general.7 = f32[8192,2048]{1,0} fusion(%p.2, %p.2), kind=kCustom, calls=%c, metadata={op_name="jit(train_step)/jvp()/dot_general"}
  %input_convert_reduce_fusion.4 = (bf16[64,5632]{1,0}) fusion(%p.2), kind=kInput, calls=%f, metadata={op_name="jit(train_step)/transpose(jvp())/while/body/closed_call/checkpoint/quantize/reduce_max"}
  %loop_convert_multiply_fusion = bf16[8192,5632]{1,0} fusion(%p.2), kind=kLoop, calls=%g, metadata={op_name="jit(train_step)/jvp()/while/body/silu_mul/jit(silu)/mul"}
  %input_add_convert_reduce_fusion.1 = f32[30976]{0} fusion(%p.2), kind=kInput, calls=%h, metadata={op_name="jit(train_step)/optimizer/add"}
  %loop_add_fusion.3 = bf16[8192,2048]{1,0} fusion(%p.2), kind=kLoop, calls=%i, metadata={op_name="jit(train_step)/jvp()/add"}
"""


@pytest.mark.parametrize("kernel,bucket", [
    ("sm90_xmma_gemm_i8i32_i8i32_i32_tn_n_tilesize128x256x64_cublas", "int8 GEMM"),
    ("nvjet_tss_320x128_64x3_1x2_h_bz_coopB_TNT", "bf16/f32 GEMM"),
    ("cudnn_generated_fort_native_sdpa_sm90_flash_bprop_wgmma_f16", "attention (cuDNN)"),
    ("gemm_fusion_dot_general_113", "int8 GEMM"),
    ("gemm_fusion_dot_general_7", "bf16/f32 GEMM"),
    ("input_convert_reduce_fusion_4", "quantize"),
    ("loop_convert_multiply_fusion", "silu_mul"),
    ("input_add_convert_reduce_fusion_1", "optimizer"),
    ("loop_add_fusion.3", "other"),
    ("some_kernel_not_in_the_hlo", "unmatched"),
])
def test_classify(kernel, bucket):
    hlo = profile_step.parse_hlo(HLO)
    assert profile_step.classify(kernel, hlo.get(kernel, ""), hlo) == bucket


def test_least_work_of_the_llama2_1b_step():
    work = profile_step.step_work({"bs": 4, "seq": 2048})
    # 4 GEMM passes x 2 FLOP x 8192 tokens x 969 M decoder linear weights
    assert work["int8 GEMM"] == ("flops", 4 * 2 * 8192 * 22 * 44040192)
    assert work["optimizer"][0] == "bytes" and 24e9 < work["optimizer"][1] < 24.5e9
    assert set(work) == {"int8 GEMM", "attention (cuDNN)", profile_step.FAMILY, "optimizer"}
