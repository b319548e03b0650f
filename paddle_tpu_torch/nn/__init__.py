"""Layers of the port beyond ``torch.nn`` (counterpart of
``paddle_tpu/nn``): the weight-only quantized linears of serving, and the
conv, BatchNorm and pooling layers, functional ops and layout transforms
of the ResNet path."""

from . import functional
from .layers_conv_norm import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D,
                               MaxPool2D, ReLU, conv_bn, fused_conv_enabled)
from .layout import space_to_depth_stem, to_channels_last
from .quant import (WeightOnlyLinear, quantize_for_inference,
                    weight_dequantize, weight_only_linear, weight_quantize)

__all__ = ["WeightOnlyLinear", "quantize_for_inference", "weight_quantize",
           "weight_dequantize", "weight_only_linear", "functional", "Conv2D",
           "BatchNorm2D", "MaxPool2D", "AdaptiveAvgPool2D", "ReLU", "conv_bn",
           "fused_conv_enabled", "to_channels_last", "space_to_depth_stem"]
