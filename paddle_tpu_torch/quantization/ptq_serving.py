"""One-shot weight-only PTQ for serving (counterpart of
``paddle_tpu/quantization/ptq_serving.py``).

``convert_for_serving`` walks the model's ``nn.Linear`` layers (q/k/v/o
projections, MLP, lm_head: every Linear unless filtered), observes each
weight's per-output-channel absmax with ``PerChannelAbsmaxObserver``,
packs it through ``intx.pack_absmax`` and installs a
``nn.quant.WeightOnlyLinear`` whose forward runs the hand-written
``quant_matmul`` kernel (K9). Its dequant scale is ``absmax / bound``;
the rounding is ``pack_absmax``'s, not ``weight_quantize``'s, as in the
JAX package. Weights are static, so one observer pass over each tensor
is the calibration. Each replaced Linear is dropped as soon as its twin
is installed, so converting a model on the card in place needs only one
layer's full-precision weight beside the narrow ones.
"""

from __future__ import annotations

from torch import nn

from .observers import PerChannelAbsmaxObserver

__all__ = ["convert_for_serving"]


def convert_for_serving(model, fmt: str = "int8", include=None):
    """Replace every ``nn.Linear`` (modulo ``include(name, layer)``)
    with a real-int8/fp8 ``WeightOnlyLinear``, scales observed per output
    channel. Returns the model (modified in place, eval mode)."""
    from ..nn.quant import WeightOnlyLinear
    from .intx import format_dtype

    format_dtype(fmt)  # actionable error for an unavailable fp8

    def _walk(layer, prefix):
        for name, sub in list(layer.named_children()):
            qual = f"{prefix}.{name}" if prefix else name
            if isinstance(sub, nn.Linear):
                if include is None or include(qual, sub):
                    # torch weights are [out, in]: output channels on axis 0
                    ob = PerChannelAbsmaxObserver(quant_axis=0)
                    ob.observe(sub.weight)
                    setattr(layer, name, WeightOnlyLinear.from_linear(
                        sub, fmt=fmt, scale=ob.scales()))
                    del sub
            else:
                _walk(sub, qual)

    _walk(model, "")
    model.eval()
    return model
