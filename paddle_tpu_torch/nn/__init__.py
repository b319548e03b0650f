"""Layers of the port beyond ``torch.nn`` (counterpart of the weight-only
serving part of ``paddle_tpu/nn``)."""

from .quant import (WeightOnlyLinear, quantize_for_inference,
                    weight_dequantize, weight_only_linear, weight_quantize)

__all__ = ["WeightOnlyLinear", "quantize_for_inference", "weight_quantize",
           "weight_dequantize", "weight_only_linear"]
