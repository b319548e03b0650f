"""Serving requests: sampling params, lifecycle states, and the handle
callers hold while the engine decodes (counterpart of
``paddle_tpu/serving/request.py``).

A ``Request`` is both the scheduler's queue entry and the caller-facing
handle: ``result()`` blocks until the request finishes, ``stream()``
iterates tokens as the engine lands them, ``cancel()`` asks the
scheduler/engine to drop it. Each request records its lifecycle as
trace spans (``request`` root, ``queued`` / ``prefill`` / ``decode``
children, instants for the transitions) on the port's tracer.
"""

from __future__ import annotations

import hashlib
import itertools
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from ..observability import tracing as _tracing

__all__ = ["SamplingParams", "Request", "RequestStatus", "PRIORITY_CLASSES",
           "request_fingerprint"]

# priority classes, LOWEST first: the shed order under queue pressure
PRIORITY_CLASSES = ("batch", "interactive")


def request_fingerprint(prompt, params: "SamplingParams") -> str:
    """Deterministic identity of a request's WORK: a short hex digest
    over the prompt tokens and every decode knob that reaches the step.
    Two submissions of the same prompt and parameters share it across
    retries, replicas and engine restarts (what a poison-request
    quarantine keys on). Priority and deadline are left out: they change
    scheduling, not the work. Equal to the JAX package's digest."""
    h = hashlib.sha256()
    h.update(np.asarray(prompt, np.int32).tobytes())
    h.update(repr((params.max_new_tokens, params.do_sample,
                   params.temperature, params.top_k, params.top_p,
                   params.eos_token_id, params.seed,
                   params.spec_k)).encode())
    return h.hexdigest()[:16]


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
        # trace identity: a propagated trace id (a traceparent header or
        # the caller's trace_context at submit) when one is active on the
        # constructing thread, else the local request id
        _ctx = _tracing.current_trace()
        self.trace = _ctx if _ctx is not None else self.id
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
        # request-lifecycle trace: one root span for the whole life plus
        # named child spans the engine opens and closes (queued, prefill,
        # decode); finish() closes whatever is still open, so every
        # terminal path leaves a complete, nested trace
        ts0 = int(self.arrival_ts * 1e9)
        self._root_span = _tracing.begin_span(
            "request", cat="request", trace=self.trace,
            args={"prompt_len": int(prompt.shape[0]),
                  "max_new_tokens": params.max_new_tokens,
                  "do_sample": params.do_sample}, ts_ns=ts0)
        self._open_spans = {}
        self._tr_begin("queued", ts_ns=ts0)
        # preemption state: (tokens_to_prefill, prng_key, n_reselected)
        # set when the request is requeued for recompute; the generated
        # tokens fold into the next prefill and the final select's
        # re-derived token is skipped, never re-delivered
        self._resume = None
        # supervisor quarantine state: the lazily computed work
        # fingerprint (identity across retries, replicas and restarts)
        # and the solo-probe flag: a crash suspect the supervisor
        # requeues is admitted alone, so a repeat crash implicates it
        # and no co-runner
        self._fingerprint: Optional[str] = None
        self.quarantine_probe = False
        self._done = threading.Event()
        self._stream_q: "queue.Queue" = queue.Queue()

    @property
    def fingerprint(self) -> str:
        fp = self._fingerprint
        if fp is None:
            fp = self._fingerprint = request_fingerprint(self.prompt,
                                                         self.params)
        return fp

    @property
    def priority(self) -> str:
        return self.params.priority

    # -- tracing -------------------------------------------------------------
    def _tr_begin(self, name: str, ts_ns: Optional[int] = None, **args):
        """Open a named lifecycle span (engine thread). Idempotent per
        name: re-beginning an open span is a no-op."""
        if name not in self._open_spans:
            self._open_spans[name] = _tracing.begin_span(
                name, cat="request", trace=self.trace, args=args or None,
                ts_ns=ts_ns)

    def _tr_end(self, name: str, **args):
        sp = self._open_spans.pop(name, None)
        if sp is not None:
            _tracing.end_span(sp, args=args or None)

    def _tr_event(self, name: str, ts_ns: Optional[int] = None, **args):
        _tracing.instant(name, cat="request", trace=self.trace,
                         args=args or None, ts_ns=ts_ns)

    # -- engine side ---------------------------------------------------------
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
        # close the trace: open lifecycle spans end here, the terminal
        # status lands as an instant, and the root span closes last so
        # children stay inside it
        end_ns = int(self.finish_ts * 1e9)
        for name in list(self._open_spans):
            _tracing.end_span(self._open_spans.pop(name), ts_ns=end_ns)
        self._tr_event(status, ts_ns=end_ns,
                       generated=len(self.output_tokens),
                       **({"error": error} if error else {}))
        _tracing.end_span(self._root_span, ts_ns=end_ns,
                          args={"status": status})
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
        """One row of the ``/debug/requests`` live state table."""
        now = time.perf_counter()
        return {
            "request_id": self.id,
            "trace": self.trace,
            "status": self.status,
            "priority": self.params.priority,
            "slot": self.slot,
            "prompt_len": int(self.prompt.shape[0]),
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
            "deadline_in_s": (round(self.deadline_ts - now, 4)
                              if self.deadline_ts is not None
                              and self.finish_ts is None else None),
            "latency_s": (round(self.finish_ts - self.arrival_ts, 4)
                          if self.finish_ts is not None else None),
            "error": self.error,
        }

    def __repr__(self):
        return (f"Request(id={self.id}, status={self.status}, "
                f"prompt_len={len(self.prompt)}, "
                f"generated={len(self.output_tokens)})")
