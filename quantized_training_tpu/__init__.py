"""quantized_training_tpu — a quantized training framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
gau-nernst/quantized-training: INT8 / INT4 / BitNet-1.58b / FP8 / MXFP4 /
NVFP4 quantized LLM + ViT training and inference, scaled low-precision
matmul kernels used in the forward and both backward passes, stochastic-
rounding low-precision optimizers, and pjit/shard_map distribution
(DP / FSDP with a quantized 2-bit all-gather) over GPU meshes.
"""

from .utils.runtime import configure_xla

configure_xla()

from . import data, models, ops, optim, parallel, quant, utils  # noqa: E402
from . import train as training

__version__ = "0.1.0"

__all__ = ["ops", "quant", "models", "optim", "data", "utils", "training", "__version__"]
