"""Fault-tolerance metrics (counterpart of
``paddle_tpu/fault_tolerance/metrics.py``), registered at import so a
scrape shows the preemption count without anyone taking a snapshot
first. The checkpoint and loss-spike instruments come with the training
half of the package.
"""

from __future__ import annotations

from ..observability import metrics as _m

__all__ = ["preemptions_total"]

preemptions_total = _m.counter(
    "paddle_tpu_preemptions_total",
    "preemption signals observed by the handler", ("signal",))
