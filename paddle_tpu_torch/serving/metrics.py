"""Serving counters as plain integers (the JAX package's
``serving/metrics.py`` registers Prometheus instruments; the registry
comes to the port with the host-stack slice).

``COUNTERS`` holds monotonic counts, keyed by name (a label, where the
JAX instrument has one, is appended after a colon:
``requests_total:completed``). ``GAUGES`` holds the latest value of a
level (``queue_depth``, ``kv_blocks_in_use``), keyed the same way
(``kv_bytes_per_token:int8``: the device bytes one cached token costs
across all layers, K + V values plus a quantized format's scales, set
by each engine at construction and labelled by its KV format). Queue
waits are kept for the scheduler's deadline check (``queue_wait_p50``).

Speculative engines count ``spec_drafted_tokens``,
``spec_accepted_tokens`` and ``spec_rejected_tokens`` (draft tokens
proposed to verify rounds, accepted by the target, rejected), on the
tree lane also ``spec_tree_nodes_drafted`` / ``spec_tree_nodes_accepted``
(nodes, of which at most the depth can be accepted a round), and
``observe`` the accepted drafts of each round into the
``spec_accept_len`` digest (``spec_accept_depth`` on the tree lane):
exact p50/p95/p99 over the recent window (``digest``).
"""

from __future__ import annotations

import threading
from collections import Counter, deque
from typing import Optional

__all__ = ["COUNTERS", "GAUGES", "inc", "set_gauge", "observe_queue_wait",
           "queue_wait_p50", "observe", "digest"]

COUNTERS: Counter = Counter()
GAUGES: dict = {}
_waits: deque = deque(maxlen=1024)
_samples: dict = {}         # digest name -> recent observations
_lock = threading.Lock()


def inc(name: str, n: int = 1, label: Optional[str] = None) -> None:
    key = name if label is None else f"{name}:{label}"
    with _lock:
        COUNTERS[key] += n


def set_gauge(name: str, value, label: Optional[str] = None) -> None:
    key = name if label is None else f"{name}:{label}"
    with _lock:
        GAUGES[key] = value


def observe_queue_wait(seconds: float) -> None:
    with _lock:
        _waits.append(float(seconds))


def observe(name: str, value) -> None:
    """One observation of the ``name`` digest (a sliding window of the
    last 1024)."""
    with _lock:
        _samples.setdefault(name, deque(maxlen=1024)).append(float(value))


def digest(name: str) -> dict:
    """p50/p95/p99 and count of the ``name`` digest's window (count 0 and
    no percentiles before the first observation)."""
    with _lock:
        w = sorted(_samples.get(name, ()))
    out = {"count": len(w)}
    for p in (0.5, 0.95, 0.99):
        if w:
            out[f"p{round(p * 100)}"] = w[min(len(w) - 1, int(p * len(w)))]
    return out


def queue_wait_p50() -> Optional[float]:
    """Median of the recent queue waits, None before the first one."""
    with _lock:
        if not _waits:
            return None
        w = sorted(_waits)
    return w[len(w) // 2]
