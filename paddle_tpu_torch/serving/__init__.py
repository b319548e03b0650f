"""Paged continuous-batching serving (counterpart of
``paddle_tpu/serving``): the engine with its lifecycle (warmup, the
background loop, drain/stop, health), its request handles, the admission
scheduler, the KV block pool, the serving metrics, the HTTP front end
and the chaos fault injector.

Quick start::

    from paddle_tpu_torch import serving
    eng = serving.ServingEngine(model, max_slots=8, max_len=512)
    eng.warmup()                     # load the kernels before the loop
    srv = serving.ServingHTTPServer(eng, port=8000)   # starts the loop
    req = eng.submit(prompt_ids, max_new_tokens=64, eos_token_id=2)
    for tok in req.stream():         # tokens as the decode lands them
        ...
"""

from . import metrics  # registers the serving instruments at import
from .block_pool import (DUMP_BLOCK, BlockPool, BlockPoolError,
                         PoolExhaustedError, PrefixCache)
from .chaos import ChaosEngine, ChaosError
from .engine import (EngineDrainingError, EngineStoppedError, ServingConfig,
                     ServingEngine)
from .http import (ServingHTTPServer, start_serving_http_server,
                   stop_serving_http_server)
from .request import (PRIORITY_CLASSES, Request, RequestStatus,
                      SamplingParams, request_fingerprint)
from .scheduler import DeadlineInfeasibleError, QueueFullError, Scheduler

__all__ = ["ServingConfig", "ServingEngine", "SamplingParams", "Request",
           "RequestStatus", "Scheduler", "QueueFullError",
           "DeadlineInfeasibleError", "PRIORITY_CLASSES",
           "request_fingerprint", "EngineStoppedError",
           "EngineDrainingError", "BlockPool", "PrefixCache",
           "PoolExhaustedError", "BlockPoolError", "DUMP_BLOCK",
           "ServingHTTPServer", "start_serving_http_server",
           "stop_serving_http_server", "ChaosEngine", "ChaosError"]
