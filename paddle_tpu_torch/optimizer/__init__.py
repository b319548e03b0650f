"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``): the
functional AdamW the training step runs, and the ``AdamW`` object that
carries its hyperparameters."""

from . import functional
from .optimizer import AdamW

__all__ = ["AdamW", "functional"]
