"""Kernel-level ops (the gn_kernels analog).

Exports mirror kernels/gn_kernels/__init__.py:1-25, implemented as
XLA-lowered jnp paths.
"""

from .conv import conv2d, int8_conv2d, scaled_int8_conv2d
from .fp8 import (
    fp8_mm,
    quantize_fp8,
    quantize_fp8_block,
    quantize_fp8_tile,
    scaled_fp8_mm,
)
from .int4_mm import int4_mm, scaled_int4_mm, unpack_int4
from .mx import (
    dequantize_mxfp4,
    dequantize_nvfp4,
    mxfp4_mm,
    nvfp4_mm,
    pack_block_scales_nv,
    quantize_mx,
    quantize_nvfp4,
)
from .scaled_mm import int8_mm, scaled_mm, scaled_mm_general, scaled_mm_ref

__all__ = [
    "int8_mm",
    "scaled_mm",
    "scaled_mm_general",
    "scaled_mm_ref",
    "int4_mm",
    "scaled_int4_mm",
    "unpack_int4",
    "fp8_mm",
    "scaled_fp8_mm",
    "quantize_fp8",
    "quantize_fp8_tile",
    "quantize_fp8_block",
    "quantize_mx",
    "quantize_nvfp4",
    "dequantize_mxfp4",
    "dequantize_nvfp4",
    "mxfp4_mm",
    "nvfp4_mm",
    "pack_block_scales_nv",
    "conv2d",
    "int8_conv2d",
    "scaled_int8_conv2d",
]
