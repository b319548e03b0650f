"""Serving requests: sampling params, lifecycle states, and the handle
callers hold while the engine decodes (counterpart of
``paddle_tpu/serving/request.py``, without its tracing hooks).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

__all__ = ["SamplingParams", "Request", "RequestStatus", "PRIORITY_CLASSES"]

# priority classes, LOWEST first: the shed order under queue pressure
PRIORITY_CLASSES = ("batch", "interactive")


class RequestStatus:
    """String states of the request lifecycle."""

    QUEUED = "queued"
    RUNNING = "running"        # owns a slot
    COMPLETED = "completed"    # EOS or max_new_tokens
    CANCELLED = "cancelled"
    EXPIRED = "expired"        # deadline passed before completion
    REJECTED = "rejected"      # backpressure: queue was full
    FAILED = "failed"          # prefill/step raised (engine survives)

    FINAL = (COMPLETED, CANCELLED, EXPIRED, REJECTED, FAILED)


@dataclass
class SamplingParams:
    """Per-request decode knobs, the surface of ``generation.generate``
    so outputs are comparable request for request: greedy by default;
    with ``do_sample`` a draw with ``temperature`` / ``top_k`` (0: off) /
    ``top_p`` (1.0: off) on the threefry key chain of ``seed``, the
    tokens the JAX package's engine and a B = 1 ``generate`` with the
    same seed give.

    ``spec_k`` is the per-request speculative override on a draft-model
    engine: ``None`` takes the engine's k, ``0`` opts the request out of
    speculation (it rides the verify bundle as a plain one-token step),
    ``1..engine_k`` shrinks its draft (the tree depth on the tree lane);
    larger values clamp to the engine's. Outputs are the same at every
    setting."""

    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: int = 0
    spec_k: Optional[int] = None
    priority: str = "interactive"

    def __post_init__(self):
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority class {self.priority!r}: expected one "
                f"of {PRIORITY_CLASSES} (lowest-shed-first order)")

    @property
    def priority_rank(self) -> int:
        """Position in the shed order (0 = shed first)."""
        return PRIORITY_CLASSES.index(self.priority)


_ids = itertools.count()
_STOP = object()  # stream sentinel


class Request:
    """One serving request: prompt tokens in, generated tokens out.

    Created by ``ServingEngine.submit``; also the caller's handle.
    """

    def __init__(self, prompt, params: SamplingParams,
                 deadline_s: Optional[float] = None,
                 on_token: Optional[Callable[["Request", int], None]] = None):
        self.id = next(_ids)
        self.prompt = prompt  # np.int32 [L]
        self.params = params
        self.arrival_ts = time.perf_counter()
        self.deadline_ts = (self.arrival_ts + deadline_s
                            if deadline_s is not None else None)
        self.on_token = on_token

        self.status = RequestStatus.QUEUED
        self.output_tokens: List[int] = []
        self.error: Optional[str] = None
        self.slot: Optional[int] = None

        self.prefill_done_ts: Optional[float] = None
        self.first_token_ts: Optional[float] = None
        self.last_token_ts: Optional[float] = None
        self.finish_ts: Optional[float] = None
        self.queued_since_ts: float = self.arrival_ts
        self.admitted_ts: Optional[float] = None
        self.queue_wait_total_s: float = 0.0
        self.preempt_count = 0
        self.cancel_requested = False
        # speculative-lane accounting: draft tokens proposed for this
        # request and accepted by the target, over all its rounds
        self.spec_drafted = 0
        self.spec_accepted = 0
        # preemption state: (tokens_to_prefill, n_reselected) set when the
        # request is requeued for recompute; the generated tokens fold into
        # the next prefill and the final select's re-derived token is
        # skipped, never re-delivered
        self._resume = None
        self._done = threading.Event()
        self._stream_q: "queue.Queue" = queue.Queue()

    @property
    def priority(self) -> str:
        return self.params.priority

    def push_token(self, token: int, now: float):
        """Engine side: deliver one generated token."""
        self.output_tokens.append(token)
        if self.first_token_ts is None:
            self.first_token_ts = now
        self.last_token_ts = now
        self._stream_q.put(token)
        if self.on_token is not None:
            try:
                self.on_token(self, token)
            except Exception:  # noqa: BLE001
                pass  # a consumer callback must never kill the decode loop

    def finish(self, status: str, error: Optional[str] = None):
        """Terminal transition (idempotent)."""
        if self.status in RequestStatus.FINAL:
            return
        self.status = status
        self.error = error
        self.finish_ts = time.perf_counter()
        self._stream_q.put(_STOP)
        self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self):
        """Ask for cancellation; the engine frees the slot at the next
        step boundary (queued requests are dropped at admission)."""
        self.cancel_requested = True

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request is final; returns the generated
        tokens. Raises TimeoutError if it doesn't finish in time."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.id} not finished within {timeout}s "
                f"(status={self.status})")
        return list(self.output_tokens)

    def stream(self, timeout: Optional[float] = None):
        """Yield generated token ids as the engine lands them."""
        while True:
            item = self._stream_q.get(timeout=timeout)
            if item is _STOP:
                return
            yield item

    def full_tokens(self) -> List[int]:
        """prompt + generated, as one list."""
        return list(self.prompt.tolist()) + list(self.output_tokens)

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (arrival -> first delivered token)."""
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.arrival_ts

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if self.first_token_ts is None or self.last_token_ts is None:
            return None
        n = len(self.output_tokens) - 1
        if n <= 0:
            return None
        return (self.last_token_ts - self.first_token_ts) / n

    def debug_row(self) -> dict:
        """One row of a live request table."""
        now = time.perf_counter()
        return {
            "request_id": self.id,
            "status": self.status,
            "priority": self.params.priority,
            "slot": self.slot,
            "prompt_len": int(len(self.prompt)),
            "generated": len(self.output_tokens),
            "max_new_tokens": self.params.max_new_tokens,
            "age_s": round(now - self.arrival_ts, 4),
            "queue_wait_s": round(self.queue_wait_total_s, 4)
                if self.admitted_ts is not None else None,
            "ttft_s": self.ttft_s,
            "tpot_s": self.tpot_s,
            "preemptions": self.preempt_count,
            "spec_k": self.params.spec_k,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": (round(self.spec_accepted
                                       / self.spec_drafted, 4)
                                 if self.spec_drafted else None),
            "latency_s": (round(self.finish_ts - self.arrival_ts, 4)
                          if self.finish_ts is not None else None),
            "error": self.error,
        }

    def __repr__(self):
        return (f"Request(id={self.id}, status={self.status}, "
                f"prompt_len={len(self.prompt)}, "
                f"generated={len(self.output_tokens)})")
