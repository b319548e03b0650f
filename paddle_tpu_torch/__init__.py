"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside the JAX one, with the same module names:
``models.llama``, ``models.gpt``, ``generation``, ``serving`` (the
engine, its lifecycle and its HTTP front end), ``observability`` (the
metrics registry and request tracing) and ``kernels`` (the counterpart
of ``pallas_kernels``). It imports ``torch``, numpy and the standard
library only. Its attention kernels are hand-written CUDA for
Hopper (``kernels/csrc``), built with ``nvcc`` at first use.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from . import observability
from .device import resolve_device

__all__ = ["resolve_device", "observability"]
