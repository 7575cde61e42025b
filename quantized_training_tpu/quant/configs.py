"""Scheme configuration records (static pytree aux data).

Mirrors the reference NamedTuple configs:
  - Int8QTConfig           subclasses/int8.py:29-30
  - MixedPrecisionConfig   subclasses/mixed_precision.py:15-20
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal


@dataclass(frozen=True)
class Int8QTConfig:
    """INT8 quantized-training config.

    ``activation``: 'none' = weight-only (mixed bf16 matmul), 'int8' =
    dynamic row-wise activation quant + int8 matmul, 'int8_sr' = same
    with stochastic rounding of activations.
    """

    activation: Literal["none", "int8", "int8_sr"] = "none"


@dataclass(frozen=True)
class MixedPrecisionConfig:
    """Per-matmul dynamic quantization toggles (the flagship scheme).

    Each of output / grad_input / grad_weight independently selects whether
    that matmul runs as dynamic row-wise quantized INT8 (or INT4/FP8) with
    both operands re-quantized per matmul, or as plain bf16.

    ``dtype='fp8_e4m3'`` selects dynamic FP8 training (BASELINE config #3):
    with ``scale='row'`` both operands get absmax row scales along the
    contraction axis; ``scale='tile'`` uses the DeepSeek-V3 recipe —
    1x128-group activation scales and 128x128-block weight scales —
    routed through the tile-scaled matmul. The fp8 dot upcasts its
    operands to bf16 (numerics are the fp8 ones: every e4m3 value is
    exactly representable in bf16).

    ``scale`` is ignored for int8/int4 (always row-wise, the reference's
    layout, subclasses/mixed_precision.py:100-134).
    """

    output: bool = True
    grad_input: bool = True
    grad_weight: bool = True
    dtype: Literal["int8", "int4", "fp8_e4m3"] = "int8"
    stochastic_rounding: bool = False
    scale: Literal["row", "tile"] = "row"
