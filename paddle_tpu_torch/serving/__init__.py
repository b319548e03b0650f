"""Paged continuous-batching serving (counterpart of
``paddle_tpu/serving``): the engine with its lifecycle (warmup, the
background loop, drain/stop, health), its request handles, the admission
scheduler, the KV block pool, the serving metrics, the HTTP front end,
and above the engine:

- ``supervisor``: ``EngineSupervisor``, warm in-process restart after a
  decode-loop crash (innocent requests requeued on the seed-deterministic
  replay), a crash-loop breaker and poison-request quarantine
  (``PoisonedRequestError``).
- ``router``: ``Router`` over ``LocalReplica`` / ``HTTPReplica``
  clients: load-aware admission, health-gated ejection and
  re-admission, deadline-aware retries bit-identical to one engine,
  optional hedging, graceful drain, the fleet observability plane.
- ``router_http``: the router's HTTP front end (``RouterHTTPServer``)
  and SIGTERM -> fleet drain.
- ``chaos``: deterministic fault injection (``ChaosEngine``,
  ``ChaosReplica``, the restart-surviving ``SupervisedChaos``).

Two supervised replicas of one model on one card, behind a router::

    sups = [serving.EngineSupervisor(model, cfg, device="cuda")
            for _ in range(2)]
    router = serving.Router([serving.LocalReplica(s, f"r{i}")
                             for i, s in enumerate(sups)]).start()
    rr = router.submit(prompt_ids, max_new_tokens=64)

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
from .chaos import ChaosEngine, ChaosError, ChaosReplica, SupervisedChaos
from .engine import (EngineDrainingError, EngineStoppedError, ServingConfig,
                     ServingEngine)
from .http import (ServingHTTPServer, start_serving_http_server,
                   stop_serving_http_server)
from .request import (PRIORITY_CLASSES, Request, RequestStatus,
                      SamplingParams, request_fingerprint)
from .router import (HTTPReplica, LocalReplica, NoReplicaError, ReplicaState,
                     Router, RouterConfig, RouterRequest)
from .router_http import (RouterHTTPServer, install_sigterm_drain,
                          uninstall_sigterm_drain)
from .scheduler import DeadlineInfeasibleError, QueueFullError, Scheduler
from .supervisor import EngineSupervisor, PoisonedRequestError

__all__ = [
    "ServingConfig", "ServingEngine", "SamplingParams", "Request",
    "RequestStatus", "Scheduler", "QueueFullError",
    "DeadlineInfeasibleError", "PRIORITY_CLASSES", "request_fingerprint",
    "EngineSupervisor", "PoisonedRequestError",
    "EngineStoppedError", "EngineDrainingError",
    "BlockPool", "PrefixCache", "PoolExhaustedError", "BlockPoolError",
    "DUMP_BLOCK",
    "ServingHTTPServer", "start_serving_http_server",
    "stop_serving_http_server",
    "Router", "RouterConfig", "RouterRequest", "ReplicaState",
    "LocalReplica", "HTTPReplica", "NoReplicaError",
    "RouterHTTPServer", "install_sigterm_drain", "uninstall_sigterm_drain",
    "ChaosEngine", "ChaosReplica", "ChaosError", "SupervisedChaos",
]
