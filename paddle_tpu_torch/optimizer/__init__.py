"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``): the
functional AdamW and momentum the training step runs, and the ``AdamW``
and ``Momentum`` objects that carry their hyperparameters."""

from . import functional
from .optimizer import AdamW, Momentum

__all__ = ["AdamW", "Momentum", "functional"]
