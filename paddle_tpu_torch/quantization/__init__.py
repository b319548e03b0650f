"""Serving-side quantization (counterpart of the weight-only and KV parts
of ``paddle_tpu/quantization``): int8/fp8 absmax pack/unpack, the
per-channel absmax observer and ``convert_for_serving``. QAT and
activation PTQ (``qat.py``, ``quanters.py``) come with a later slice."""

from . import intx
from .intx import pack_absmax, unpack_absmax
from .observers import BaseObserver, PerChannelAbsmaxObserver
from .ptq_serving import convert_for_serving

__all__ = ["convert_for_serving", "BaseObserver", "PerChannelAbsmaxObserver",
           "intx", "pack_absmax", "unpack_absmax"]
