"""The kernel wrappers' launch and dispatch counters, made safe across
threads.

Engines on several threads (two replicas in one process) launch at
once, and a bare ``+= 1`` on a shared dict loses a count when a thread
switch falls between its read and its store. Every wrapper counts
through ``count`` and every reset holds ``COUNT_LOCK``: one lock for
all of them.
"""

from __future__ import annotations

import threading

__all__ = ["COUNT_LOCK", "count"]

COUNT_LOCK = threading.Lock()


def count(counts, key) -> None:
    """Add one to ``counts[key]`` under ``COUNT_LOCK``."""
    with COUNT_LOCK:
        counts[key] += 1
