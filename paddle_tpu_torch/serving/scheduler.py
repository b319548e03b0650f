"""Admission control for the serving engine (counterpart of
``paddle_tpu/serving/scheduler.py``): FCFS queue with bounded depth
(backpressure), per-request deadlines, and cancellation.

Iteration-level scheduling (Orca) splits serving into two loops: the
ADMISSION decision (this module — which request gets the next free slot)
and the ITERATION itself (engine.py — one decode step for every running
slot). FCFS within a priority class is the whole policy; a fancier one
is a drop-in swap of ``pop_ready``.

Overload control (the DAGOR shape — Zhou et al., SoCC'18): when the
queue is FULL and a higher-priority request arrives, the newest
lowest-class queued request is SHED (rejected with an explicit error)
to make room — batch work absorbs the pressure before interactive work
ever bounces. And a request whose deadline cannot beat the live
queue-wait p50 is rejected AT ADMISSION (429 + Retry-After) instead of
queued: work that will expire in the queue is load with zero goodput.
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
    """Backpressure: the admission queue is at max depth. Callers should
    shed load or retry later — the engine NEVER buffers unboundedly."""


class DeadlineInfeasibleError(QueueFullError):
    """Admission-time rejection: the request's deadline cannot beat the
    live queue-wait estimate, so queueing it would only produce an
    EXPIRED request later. Subclasses ``QueueFullError`` so every
    existing backpressure surface (HTTP 429 + Retry-After, the
    router's saturated-backoff path) handles it for free;
    ``retry_after_s`` carries the wait estimate the deadline lost to."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class Scheduler:
    GUARDED_BY = {"_q": "_lock"}

    def __init__(self, max_queue_depth: int = 64):
        self.max_queue_depth = int(max_queue_depth)
        self._q: deque = deque()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def submit(self, req: Request):
        """FCFS enqueue with priority-aware overload control.

        Raises ``QueueFullError`` (and marks the request REJECTED) when
        the queue is at max depth and holds nothing of a strictly lower
        priority class — the clear-rejection contract: the caller knows
        immediately, nothing is dropped silently. When a LOWER class is
        queued, the newest such request is shed instead (it is the one
        that has invested the least wait) and the arrival is admitted.
        Raises ``DeadlineInfeasibleError`` when the queue is non-empty
        and the request's remaining deadline cannot beat the live
        queue-wait p50 — failing fast at admission beats queueing work
        that will expire before a slot frees."""
        with self._lock:
            if req.deadline_ts is not None and self._q:
                est = _sm.queue_wait_p50()
                remaining = req.deadline_ts - time.perf_counter()
                if est is not None and remaining <= est:
                    req.finish(
                        RequestStatus.REJECTED,
                        error=f"deadline infeasible: {remaining:.3f}s "
                              f"remain but the queue-wait p50 is "
                              f"{est:.3f}s")
                    _sm.requests_total.labels("rejected").inc()
                    _sm.deadline_rejected_total.labels(req.priority).inc()
                    raise DeadlineInfeasibleError(
                        f"deadline cannot beat the queue: {remaining:.3f}s "
                        f"remain, queue-wait p50 is {est:.3f}s — retry "
                        f"with a later deadline or back off",
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
                    _sm.requests_total.labels("rejected").inc()
                    raise QueueFullError(
                        f"serving queue is full ({self.max_queue_depth} "
                        f"requests waiting); retry later or raise "
                        f"max_queue_depth")
                self._q.remove(victim)
                victim.finish(
                    RequestStatus.REJECTED,
                    error=f"shed under queue pressure: class "
                          f"{victim.priority} yielded its place to an "
                          f"arriving {req.priority} request — retry "
                          f"later")
                _sm.requests_total.labels("rejected").inc()
                _sm.requests_shed_total.labels(victim.priority).inc()
            req.status = RequestStatus.QUEUED
            self._q.append(req)
            _sm.queue_depth.set(len(self._q))

    def requeue(self, req: Request):
        """Push a request back to the FRONT of the queue (paged-engine
        preemption / admission backoff): it keeps its FCFS position and
        is retried before anything newer. Deliberately exempt from the
        depth bound — the request was already admitted once; bouncing it
        with a rejection now would turn pool pressure into data loss."""
        with self._lock:
            if req.status != RequestStatus.QUEUED:
                # preemption: a fresh queue-wait window + a fresh
                # `queued` span, so the trace shows each wait separately
                # (queued → preempted → requeued/queued → resume). An
                # admission-BACKOFF requeue (popped, no free blocks, put
                # straight back) keeps the running wait window — the
                # request has been waiting the whole time.
                req.queued_since_ts = time.perf_counter()
                req._tr_event("requeued")
            req._tr_begin("queued")
            req.status = RequestStatus.QUEUED
            self._q.appendleft(req)
            _sm.queue_depth.set(len(self._q))

    def snapshot(self) -> list:
        """Queued requests, FCFS order (the /debug/requests live
        table's waiting section)."""
        with self._lock:
            return list(self._q)

    def detach_all(self) -> list:
        """Remove and return every queued request WITHOUT finishing
        them (FCFS order) — the supervisor's crash-capture hook. A
        queued request was never touched by the crashing step; handing
        it to a rebuilt engine instead of failing it is the whole
        point of supervised restart (``Request.finish`` is idempotent
        and irreversible, so capture must happen BEFORE the crash
        path's ``_fail_inflight`` can reach the queue)."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
            _sm.queue_depth.set(0)
            return out

    def depth_spec_opted_out(self) -> int:
        """Queued requests that opted OUT of speculation
        (``SamplingParams.spec_k == 0``). A draft-model engine whose
        queue is mostly opt-outs is paying verify-bundle width for
        plain decode — ``/stats`` surfaces this so the operator can see
        the mismatch between the engine's spec config and the actual
        admission mix."""
        with self._lock:
            return sum(1 for r in self._q if r.params.spec_k == 0)

    def cancel(self, req: Request) -> bool:
        """Cancel a request. Queued: removed immediately. Running: flag
        it; the engine frees the slot at the next step boundary. Returns
        True when the request was still live."""
        req.cancel_requested = True
        with self._lock:
            if req in self._q:
                self._q.remove(req)
                _sm.queue_depth.set(len(self._q))
                req.finish(RequestStatus.CANCELLED)
                _sm.requests_total.labels("cancelled").inc()
                return True
        return req.status not in RequestStatus.FINAL

    def pop_ready(self, now: Optional[float] = None) -> Optional[Request]:
        """Next admissible request (FCFS), transparently finishing
        cancelled/expired entries it skips over."""
        if now is None:
            now = time.perf_counter()
        with self._lock:
            while self._q:
                req = self._q.popleft()
                _sm.queue_depth.set(len(self._q))
                if req.cancel_requested:
                    req.finish(RequestStatus.CANCELLED)
                    _sm.requests_total.labels("cancelled").inc()
                    continue
                if req.deadline_ts is not None and now > req.deadline_ts:
                    req.finish(RequestStatus.EXPIRED,
                               error="deadline passed while queued")
                    _sm.requests_total.labels("expired").inc()
                    continue
                return req
            return None
