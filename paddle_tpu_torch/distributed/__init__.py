"""Training engine of the port (counterpart of ``paddle_tpu/distributed``):
the single-device whole-step trainer. Meshes, data/tensor parallelism,
ZeRO and remat come with the distributed slice."""

from .engine import ShardedTrainStep

__all__ = ["ShardedTrainStep"]
