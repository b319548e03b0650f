"""The per-channel absmax observer that calibrates weight-only serving
(counterpart of ``PerChannelAbsmaxObserver`` and its base in
``paddle_tpu/quantization/observers.py``). The other observers serve
QAT/PTQ of activations and come with that part of ``quantization``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["BaseObserver", "PerChannelAbsmaxObserver"]


class BaseObserver:
    """Tracks statistics of every tensor passed through ``observe``."""

    def __init__(self, quant_bits: int = 8):
        self.quant_bits = quant_bits
        self._scale: Optional[float] = None

    def observe(self, x):
        raise NotImplementedError

    def scales(self):
        if self._scale is None:
            raise RuntimeError("observer has no data; run calibration first")
        return self._scale

    def quant_axis(self):
        return -1

    def zero_points(self) -> float:
        return 0.0

    def bound(self) -> int:
        return (1 << (self.quant_bits - 1)) - 1


class PerChannelAbsmaxObserver(BaseObserver):
    """Per-channel absmax along ``quant_axis``, kept in the observed
    tensor's dtype and device (a torch weight is [out, in]: the output
    channels are axis 0)."""

    def __init__(self, quant_bits: int = 8, quant_axis: int = 0):
        super().__init__(quant_bits)
        self._axis = quant_axis
        self._scale_vec: Optional[torch.Tensor] = None

    def observe(self, x):
        with torch.no_grad():
            d = x.detach()
            dims = tuple(i for i in range(d.dim()) if i != self._axis)
            m = d.abs().amax(dim=dims)
        self._scale_vec = m if self._scale_vec is None \
            else torch.maximum(self._scale_vec, m)
        return x

    def scales(self):
        if self._scale_vec is None:
            raise RuntimeError("observer has no data; run calibration first")
        return self._scale_vec

    def quant_axis(self):
        return self._axis
