"""paddle_tpu_torch.fault_tolerance: the preemption handler (counterpart
of ``paddle_tpu/fault_tolerance``, its serving half).

- preemption handler: SIGTERM/SIGINT (or ``request_preemption()``) flip
  a process-wide flag, take a flight-recorder dump and notify listeners;
  the serving router's graceful drain (``serving.router_http.
  install_sigterm_drain``) is one such listener.

The handler is metered (``paddle_tpu_preemptions_total``) through the
observability registry. The JAX package's training half (the async
checkpointer, the ``FaultTolerantCheckpoint`` callback and the loss-spike
sentinel) has no counterpart yet.
"""

from . import metrics
from .preemption import (PreemptionHandler, add_preemption_listener,
                         clear_preemption, install_preemption_handler,
                         preemption_requested, remove_preemption_listener,
                         request_preemption, uninstall_preemption_handler)

__all__ = [
    "PreemptionHandler", "install_preemption_handler",
    "uninstall_preemption_handler", "preemption_requested",
    "request_preemption", "clear_preemption", "add_preemption_listener",
    "remove_preemption_listener", "metrics",
]
