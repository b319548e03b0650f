"""Channels-last model conversion (counterpart of
``paddle_tpu/nn/layout.py``).

``to_channels_last(model)`` flips every layout-carrying sublayer
(``data_format``/``_data_format`` "NCHW" -> "NHWC") in place and wraps
``model.forward`` so that the public contract stays NCHW: 4-D tensor
inputs are transposed to NHWC on entry and 4-D outputs back on exit.
Parameters are untouched (conv weights stay OIHW), so the state dict is
the NCHW model's.

``space_to_depth_stem(model)`` rewrites the 7x7 stride-2 pad-3 stem conv
on 3 channels as a 2x2 space-to-depth reshape and an exactly equivalent
4x4 stride-1 conv on 12 channels with padding ((2, 1), (2, 1)), the
weights rearranged from the same parameter at every call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from . import functional as F
from .layers_conv_norm import _pair

__all__ = ["to_channels_last", "space_to_depth_stem"]

_FORMAT_ATTRS = ("data_format", "_data_format")


def _flip_layer(layer, unsupported: list) -> bool:
    hit = False
    for attr in _FORMAT_ATTRS:
        fmt = getattr(layer, attr, None)
        if fmt is None:
            continue
        if fmt in ("NCHW", "NHWC"):
            setattr(layer, attr, "NHWC")
            hit = True
        else:
            unsupported.append(f"{type(layer).__name__}({attr}={fmt!r})")
    return hit


def to_channels_last(model):
    """Convert ``model`` to run internally in NHWC; mutates in place and
    returns it. Raises ``ValueError`` for a layer with a layout other than
    NCHW/NHWC, or when no layer carries a layout."""
    if getattr(model, "_channels_last", False):
        return model
    unsupported: list = []
    flipped = sum(_flip_layer(m, unsupported) for m in model.modules())
    if unsupported:
        raise ValueError(
            "to_channels_last: model contains layers with non-NCHW/NHWC "
            f"layouts that have no channels-last form: {unsupported}")
    if not flipped:
        raise ValueError("to_channels_last: no layout-carrying layer found")

    inner_forward = model.forward

    def _to_nhwc(a):
        return a.permute(0, 2, 3, 1).contiguous() if (
            isinstance(a, torch.Tensor) and a.dim() == 4) else a

    def _to_nchw(a):
        return a.permute(0, 3, 1, 2) if (
            isinstance(a, torch.Tensor) and a.dim() == 4) else a

    def forward(*args, **kwargs):
        args = tuple(_to_nhwc(a) for a in args)
        kwargs = {k: _to_nhwc(v) for k, v in kwargs.items()}
        out = inner_forward(*args, **kwargs)
        if isinstance(out, (tuple, list)):
            return type(out)(_to_nchw(o) for o in out)
        return _to_nchw(out)

    model.forward = forward
    model._channels_last = True
    return model


def space_to_depth_stem(model, conv_attr: str = "conv1"):
    """Rewrite the stem conv as a space-to-depth 4x4 conv. Identity: with
    u = 2a + p - 1 (a in 0..3, p in 0..1) and X[m, n, (p, q, c)] = x[2m +
    p, 2n + q, c], y = conv(X, W4) with padding (2, 1) and W4[o, (p, q,
    c), a, b] = w_padded[o, c, 2a + p, 2b + q], w_padded padding one zero
    row and column at the top and left. Requires ``to_channels_last``
    first; mutates the conv's ``forward`` in place, returns the model."""
    conv = getattr(model, conv_attr)
    if (_pair(conv._kernel_size) != (7, 7) or _pair(conv._stride) != (2, 2)
            or _pair(conv._padding) != (3, 3) or conv.weight.shape[1] != 3
            or conv._groups != 1 or _pair(conv._dilation) != (1, 1)
            or conv._data_format != "NHWC"):
        raise ValueError(
            "space_to_depth_stem expects a channels-last 7x7 stride-2 "
            "pad-3 dense undilated conv on 3 input channels; got "
            f"kernel={conv._kernel_size} stride={conv._stride} "
            f"padding={conv._padding} in_ch={conv.weight.shape[1]} "
            f"groups={conv._groups} dilation={conv._dilation} "
            f"data_format={conv._data_format!r}")

    def stem_forward(x):
        n, h, wd, c = x.shape
        if h % 2 or wd % 2:
            raise ValueError(
                "space_to_depth_stem requires even spatial input dims (got "
                f"{h}x{wd}); call the untransformed model for odd sizes")
        xp = x.reshape(n, h // 2, 2, wd // 2, 2, c).permute(
            0, 1, 3, 2, 4, 5).reshape(n, h // 2, wd // 2, 4 * c)
        w = conv.weight   # read at call time: the live (or swapped) param
        wp = TF.pad(w, (1, 0, 1, 0))
        w4 = wp.reshape(w.shape[0], c, 4, 2, 4, 2).permute(
            0, 3, 5, 1, 2, 4).reshape(w.shape[0], 4 * c, 4, 4)
        return F.conv2d(xp, w4, conv.bias, 1, ((2, 1), (2, 1)),
                        data_format="NHWC")

    conv.forward = stem_forward
    model._space_to_depth_stem = True
    return model
