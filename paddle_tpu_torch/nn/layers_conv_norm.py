"""Conv, pooling and BatchNorm layers of the ResNet path (counterpart of
``paddle_tpu/nn/layers_conv_norm.py``), and the Conv2D -> BatchNorm2D
(-> ReLU) fusion dispatch.

In the JAX package a qualifying ``Conv2D`` tags its output and the
consuming ``BatchNorm`` re-dispatches the pair from the conv's input;
``jit`` then drops the conv it computed first, and the relu (eval) or the
normalized activation (training) that the fused call makes dead. Eager
PyTorch drops nothing, so here the caller of a Conv2D -> BatchNorm2D pair
(the ResNet blocks and their downsample) asks ``conv_bn`` for the unit:
it takes the fused route exactly where the JAX predicate does, computes
each conv once, and in training hands the unit to the next conv of the
block as a ``PendingBN`` (the chain the JAX package builds with its
pending tag; a residual add ends it there too). A bare Conv2D followed by
a BatchNorm2D outside such a caller runs unfused.

``FUSED_CONV_DISPATCH`` counts the outcomes under the JAX package's
``paddle_tpu_fused_conv_dispatch_total`` labels: ("hit", "train" |
"eval") per fused unit; ("fallback", "disabled" | "ineligible") per
Conv2D forward that did not qualify; ("fallback", "bn_mismatch") per
qualifying conv whose BatchNorm did not match.
"""

from __future__ import annotations

import math
import os
from collections import Counter

import torch
from torch import nn

from ..kernels.fused_conv import conv_qualifies
from . import functional as F

__all__ = ["Conv2D", "BatchNorm2D", "MaxPool2D", "AdaptiveAvgPool2D", "ReLU",
           "conv_bn", "fused_conv_enabled", "FUSED_CONV_DISPATCH",
           "reset_dispatch_counter"]

_FUSED_CONV_ENV = "PADDLE_TPU_FUSED_CONV"
FUSED_CONV_DISPATCH: Counter = Counter()


def reset_dispatch_counter() -> None:
    FUSED_CONV_DISPATCH.clear()


def fused_conv_enabled() -> bool:
    """On unless ``PADDLE_TPU_FUSED_CONV=0`` (the JAX package's switch).
    On every device: on the CPU the fused route runs the kernels' plain
    versions."""
    return os.environ.get(_FUSED_CONV_ENV, "1") != "0"


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def _kaiming_uniform_(t, fan_in):
    """The JAX package's KaimingUniform: U(-sqrt(6 / fan_in), +)."""
    bound = math.sqrt(6.0 / fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound)


class Conv2D(nn.Module):
    """2-D convolution with an OIHW ``weight`` and optional ``bias``
    (``bias_attr=False`` drops it), Paddle's argument names."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None,
                 data_format="NCHW", device=None, dtype=None):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _pair(kernel_size)
        self._stride = _pair(stride)
        self._padding = padding
        self._dilation = _pair(dilation)
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels // groups * self._kernel_size[0] \
            * self._kernel_size[1]
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(_kaiming_uniform_(torch.empty(
            (out_channels, in_channels // groups) + self._kernel_size, **kw),
            fan_in))
        if bias_attr is False:
            self.bias = None
        else:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias = nn.Parameter(torch.empty(out_channels, **kw)
                                     .uniform_(-bound, bound))

    def forward(self, x):
        if not fused_conv_enabled():
            FUSED_CONV_DISPATCH["fallback", "disabled"] += 1
        elif not _conv_eligible(self, x):
            FUSED_CONV_DISPATCH["fallback", "ineligible"] += 1
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class BatchNorm2D(nn.Module):
    """BatchNorm with Paddle's momentum convention; running statistics in
    the buffers ``_mean`` and ``_variance``."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, **kw))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, **kw))
        self.register_buffer("_mean", torch.zeros(num_features, device=device,
                                                  dtype=torch.float32))
        self.register_buffer("_variance", torch.ones(
            num_features, device=device, dtype=torch.float32))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW"):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


def _conv_eligible(conv: Conv2D, x) -> bool:
    """The JAX package's ``_conv_tag_eligible``."""
    return (conv._data_format == "NHWC" and conv.bias is None
            and x.dim() == 4 and x.dtype in (torch.float32, torch.bfloat16)
            and conv_qualifies(conv._kernel_size, conv._stride,
                               _pair(conv._padding), conv._dilation,
                               conv._groups))


def _bn_matches(bn, conv: Conv2D) -> bool:
    return (isinstance(bn, BatchNorm2D) and bn._data_format == "NHWC"
            and bn.weight is not None and bn.bias is not None
            and conv._out_channels == bn._num_features)


def conv_bn(conv: Conv2D, bn: BatchNorm2D, x, relu: bool = False):
    """``relu?(bn(conv(x)))`` for one Conv2D -> BatchNorm2D unit, fused
    where the JAX package fuses it. ``x`` may be the previous unit's
    ``PendingBN``. Returns a tensor, or in training a ``PendingBN`` when
    the unit was fused (``F.value`` gives its tensor)."""
    # a PendingBN stands for a tensor of its raw conv output's shape
    probe = x.co if isinstance(x, F.PendingBN) else x
    fuse = fused_conv_enabled() and _conv_eligible(conv, probe)
    if fuse and _bn_matches(bn, conv):
        FUSED_CONV_DISPATCH["hit", "train" if bn.training else "eval"] += 1
        return F.fused_conv_bn(x, conv.weight, bn._mean, bn._variance,
                               bn.weight, bn.bias, training=bn.training,
                               momentum=bn._momentum, epsilon=bn._epsilon,
                               use_global_stats=bn._use_global_stats,
                               relu=relu)
    if fuse:
        FUSED_CONV_DISPATCH["fallback", "bn_mismatch"] += 1
    y = bn(conv(F.value(x)))
    return F.relu(y) if relu else y
