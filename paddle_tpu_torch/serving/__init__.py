"""Paged continuous-batching serving (counterpart of
``paddle_tpu/serving``): the engine, its request handles, the admission
scheduler, the KV block pool and plain-integer metrics."""

from .block_pool import (DUMP_BLOCK, BlockPool, BlockPoolError,
                         PoolExhaustedError, PrefixCache)
from .engine import ServingConfig, ServingEngine
from .request import Request, RequestStatus, SamplingParams
from .scheduler import DeadlineInfeasibleError, QueueFullError, Scheduler

__all__ = ["ServingConfig", "ServingEngine", "Request", "RequestStatus",
           "SamplingParams", "Scheduler", "QueueFullError",
           "DeadlineInfeasibleError", "BlockPool", "PrefixCache",
           "PoolExhaustedError", "BlockPoolError", "DUMP_BLOCK"]
