"""Quantization schemes (the subclasses/ analog).

Export parity with subclasses/__init__.py:1-18: weight wrapper types,
tree-transform converters, and scheme configs.
"""

from .api import (
    commit_params,
    is_quant_weight,
    merge_masters,
    prequantize_step,
    qlinear,
    qlinear_multi,
    quantize_params,
    virtual_params,
)
from .bitnet import BitNetPackedWeight, BitNetWeight
from .configs import Int8QTConfig, MixedPrecisionConfig
from .core import (
    bf16_stochastic_round,
    dequantize_int8,
    get_bitnet_scale,
    pack_i2_in_i8,
    quantize_bitnet_weight,
    quantize_int4_groupwise,
    quantize_int4_rowwise_absmax,
    quantize_int8,
    unpack_i2_in_i8,
)
from .int4 import Int4Weight
from .int8 import Int8Weight
from .mixed_precision import MixedPrecisionWeight, PreQuantMPWeight

__all__ = [
    "qlinear",
    "qlinear_multi",
    "quantize_params",
    "virtual_params",
    "merge_masters",
    "commit_params",
    "is_quant_weight",
    "Int8Weight",
    "Int4Weight",
    "BitNetWeight",
    "BitNetPackedWeight",
    "MixedPrecisionWeight",
    "PreQuantMPWeight",
    "prequantize_step",
    "Int8QTConfig",
    "MixedPrecisionConfig",
    "quantize_int8",
    "dequantize_int8",
    "quantize_int4_groupwise",
    "quantize_int4_rowwise_absmax",
    "get_bitnet_scale",
    "quantize_bitnet_weight",
    "pack_i2_in_i8",
    "unpack_i2_in_i8",
    "bf16_stochastic_round",
]
