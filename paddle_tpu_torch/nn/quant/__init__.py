"""Weight-only quantization (counterpart of paddle_tpu.nn.quant)."""
from .quantized_linear import (ALGOS, weight_dequantize,  # noqa: F401
                               weight_quantize)
