"""Admission control for the serving engine (counterpart of
``paddle_tpu/serving/scheduler.py``): FCFS queue with bounded depth,
priority shedding when full, per-request deadlines, cancellation.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from . import metrics as _sm
from .request import Request, RequestStatus

__all__ = ["Scheduler", "QueueFullError", "DeadlineInfeasibleError"]


class QueueFullError(RuntimeError):
    """Backpressure: the admission queue is at max depth."""


class DeadlineInfeasibleError(QueueFullError):
    """The request's deadline cannot beat the live queue-wait estimate;
    ``retry_after_s`` carries the estimate."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class Scheduler:
    def __init__(self, max_queue_depth: int = 64):
        self.max_queue_depth = int(max_queue_depth)
        self._q: deque = deque()
        self._lock = threading.Lock()

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def submit(self, req: Request):
        """FCFS enqueue. When the queue is full, the newest request of a
        strictly lower priority class is shed to make room; with none,
        the arrival is rejected (``QueueFullError``). A deadline that
        cannot beat the queue-wait p50 is rejected at once
        (``DeadlineInfeasibleError``)."""
        with self._lock:
            if req.deadline_ts is not None and self._q:
                est = _sm.queue_wait_p50()
                remaining = req.deadline_ts - time.perf_counter()
                if est is not None and remaining <= est:
                    req.finish(RequestStatus.REJECTED,
                               error=f"deadline infeasible: {remaining:.3f}s "
                                     f"remain but the queue-wait p50 is "
                                     f"{est:.3f}s")
                    _sm.inc("requests_total", label="rejected")
                    raise DeadlineInfeasibleError(
                        f"deadline cannot beat the queue: {remaining:.3f}s "
                        f"remain, queue-wait p50 is {est:.3f}s",
                        retry_after_s=round(est, 3))
            if len(self._q) >= self.max_queue_depth:
                victim = None
                rank = req.params.priority_rank
                for cand in reversed(self._q):  # newest lowest class
                    if cand.params.priority_rank < rank and \
                            (victim is None or cand.params.priority_rank
                             < victim.params.priority_rank):
                        victim = cand
                        if victim.params.priority_rank == 0:
                            break
                if victim is None:
                    req.finish(RequestStatus.REJECTED,
                               error=f"queue full "
                                     f"(depth {self.max_queue_depth})")
                    _sm.inc("requests_total", label="rejected")
                    raise QueueFullError(
                        f"serving queue is full ({self.max_queue_depth} "
                        f"requests waiting); retry later or raise "
                        f"max_queue_depth")
                self._q.remove(victim)
                victim.finish(RequestStatus.REJECTED,
                              error=f"shed under queue pressure: class "
                                    f"{victim.priority} yielded its place "
                                    f"to an arriving {req.priority} request")
                _sm.inc("requests_total", label="rejected")
                _sm.inc("requests_shed_total", label=victim.priority)
            req.status = RequestStatus.QUEUED
            self._q.append(req)
            _sm.set_gauge("queue_depth", len(self._q))

    def requeue(self, req: Request):
        """Push a request back to the FRONT of the queue (preemption /
        admission backoff); exempt from the depth bound."""
        with self._lock:
            if req.status != RequestStatus.QUEUED:
                req.queued_since_ts = time.perf_counter()
            req.status = RequestStatus.QUEUED
            self._q.appendleft(req)
            _sm.set_gauge("queue_depth", len(self._q))

    def depth_spec_opted_out(self) -> int:
        """Queued requests that opted out of speculation
        (``SamplingParams.spec_k == 0``)."""
        with self._lock:
            return sum(1 for r in self._q if r.params.spec_k == 0)

    def cancel(self, req: Request) -> bool:
        """Queued: removed now. Running: flagged; the engine frees the
        slot at the next step. Returns True while the request is live."""
        req.cancel_requested = True
        with self._lock:
            if req in self._q:
                self._q.remove(req)
                _sm.set_gauge("queue_depth", len(self._q))
                req.finish(RequestStatus.CANCELLED)
                _sm.inc("requests_total", label="cancelled")
                return True
        return req.status not in RequestStatus.FINAL

    def pop_ready(self, now: Optional[float] = None) -> Optional[Request]:
        """Next admissible request (FCFS), finishing the cancelled and
        expired entries it skips over."""
        if now is None:
            now = time.perf_counter()
        with self._lock:
            while self._q:
                req = self._q.popleft()
                _sm.set_gauge("queue_depth", len(self._q))
                if req.cancel_requested:
                    req.finish(RequestStatus.CANCELLED)
                    _sm.inc("requests_total", label="cancelled")
                    continue
                if req.deadline_ts is not None and now > req.deadline_ts:
                    req.finish(RequestStatus.EXPIRED,
                               error="deadline passed while queued")
                    _sm.inc("requests_total", label="expired")
                    continue
                return req
            return None
