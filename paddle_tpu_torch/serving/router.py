"""Multi-replica serving router (counterpart of
``paddle_tpu/serving/router.py``): spread requests over N ``ServingEngine``
replicas with health-gated failover, deadline-aware retries, tail-latency
hedging, and graceful drain.

One engine process is a single point of failure: today a decode-loop
crash fails every in-flight request with a 503 and no recovery. This is
the layer production serving stacks put ABOVE iteration-level
scheduling (Orca governs *inside* one engine; a vLLM-class deployment
routes *across* engines), and it is where serving fault tolerance
actually lives:

- **Load-aware admission**: each request goes to the replica with the
  lowest load score — router-attributed in-flight attempts, queue depth
  and KV-pool utilization from the replica's ``/stats``, and the p95
  TTFT digest (the latency digests exist precisely for this
  decision). Stats are polled with a staleness bound and a timeout; a
  replica whose ``/stats`` hangs keeps serving on its last-known score
  (a slow stats endpoint is not a dead replica).
- **Health gating**: replicas are probed on ``/healthz``. ``K``
  consecutive probe failures (error / timeout / malformed payload /
  ``crashed`` / ``stalled``) eject the replica from rotation; an
  ejected replica is re-admitted only after passing a WARMUP probe
  (``status == "ok"`` and ``warmed_up`` — a replacement engine that
  has not loaded its kernels would pay their build out of the first
  user's deadline). ``saturated`` and ``draining`` are NOT
  failures: a backed-up replica gets a ``retry_after_s`` backoff, a
  draining one just stops receiving new work.
- **Deadline-aware retry**: a request whose attempt dies with its
  replica (crash, abort, ejection mid-flight) is retried on another
  replica with capped exponential backoff + seeded jitter. Retries are
  idempotent because prefill restarts from the prompt and the engine's
  PRNG chain is seed-deterministic: the new replica re-derives exactly
  the tokens the dead one already delivered, and the relay drops the
  replayed prefix — the caller sees each token once and the final
  output is bit-identical to a single-engine run. Retries respect the
  remaining deadline (a retry that cannot beat the deadline fails as
  EXPIRED immediately), never fire for cancelled requests, and are
  bounded per-request (``max_retries_per_request``) and globally (the
  amplification cap: extra attempts <= cap * requests + floor — a
  crash storm cannot melt the surviving replicas with retry traffic).
- **Hedging** (opt-in): when a request's first token is slower than the
  digest-derived threshold (``hedge_ttft_factor`` x the replica's p95
  TTFT), a second replica races it; the first to deliver a token wins
  and the loser is cancelled. Outputs are identical either way (same
  seed => same tokens), so hedging only moves tail latency.
- **Graceful drain**: ``drain(name)`` stops admitting to a replica and
  lets its in-flight requests finish (``engine.stop()`` drains by
  default now) while the router routes new traffic elsewhere —
  vs. the fail-all crash path. ``router_http`` wires SIGTERM to
  ``drain_all`` through the fault-tolerance preemption listener.

- **Fleet observability plane** (``observability/fleet.py``, gated by
  ``RouterConfig.fleet_observability``): every attempt carries a
  deterministic propagated trace id (traceparent header over HTTP,
  thread-local ``trace_context`` in-process) so the replica-side span
  tree joins the router's trace — ``merged_trace(request_id)`` fetches
  each attempt's events back and renders ONE multi-swimlane catapult
  file; replica ``/metrics`` are scraped on the stats cadence into a
  federation aggregator (``federated_metrics_text()``, relabeled
  ``replica=<name>`` + ``replica="fleet"`` roll-ups); terminal
  requests feed multi-window SLO burn rates (``slo_report()``); and
  per-replica TPOT deviation (robust MAD) flags stragglers in
  ``/replicas`` — optionally penalized in the admission score.

- **Quarantine propagation + brownout** (the self-healing plane): a
  replica supervisor (``serving/supervisor.py``) that quarantines a
  poison request publishes the fingerprint in its ``/stats`` block;
  the router merges every replica's blacklist on its normal stats
  cadence AND learns from the retry path (an attempt failing with the
  ``PoisonedRequestError`` marker is terminal, never retried — the
  poison must not crash-loop its way across the fleet). And when the
  fleet SLO burns on BOTH windows, a ``BrownoutController`` steps the
  router through the degradation ladder: shed batch-class submits,
  disable hedging, clamp batch decode length, cap speculation — with
  hysteresis on recovery so one good minute doesn't re-admit the
  overload.

The router talks to replicas through a small client protocol —
``healthz() / stats() / submit() / cancel() / drain()`` (plus the
optional fleet extensions ``metrics_text() / trace_events()``) — with two
implementations: ``LocalReplica`` (in-process engine, what the tests
and the single-host topology use) and ``HTTPReplica`` (an engine behind
``serving.http`` in another process). ``chaos.py`` wraps the same
protocol to inject faults; the port's router tests assert the
invariants under them: no request silently lost, greedy outputs
bit-identical to a single-engine run, retry amplification bounded.

In-process replicas share one metrics registry and one trace ring, so
the federated roll-ups over ``LocalReplica``s multiply the shared
series by the replica count, exactly as the JAX package's do; only the
HTTP topology (one process a replica) isolates them.
"""

from __future__ import annotations

import itertools
import json
import queue
import random
import threading
import time
import urllib.error
import urllib.request
import weakref
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Dict, List, Optional

import numpy as np

from ..observability import exporters as _exporters
from ..observability import fleet as _fleet
from ..observability import tracing as _trace
from . import metrics as _sm
from .engine import EngineStoppedError, ServingEngine
from .request import RequestStatus, SamplingParams, request_fingerprint
from .scheduler import QueueFullError
from .supervisor import (EngineSupervisor, POISON_MARKER,
                         PoisonedRequestError)

__all__ = ["Router", "RouterConfig", "RouterRequest", "ReplicaState",
           "LocalReplica", "HTTPReplica", "NoReplicaError"]

_router_req_ids = itertools.count()
_STOP = object()


class NoReplicaError(RuntimeError):
    """No replica can admit the request right now (all ejected,
    draining, or saturated). Carries ``retry_after_s`` when the cause
    is saturation (shed load upstream and come back)."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class ReplicaState:
    """Router-side replica lifecycle (strings: these land in /stats
    JSON as-is)."""

    HEALTHY = "healthy"    # in rotation
    EJECTED = "ejected"    # failed K consecutive probes; awaiting warmup
    DRAINING = "draining"  # no new admissions; in-flight finishing
    STOPPED = "stopped"    # drained / removed


def _call_with_timeout(fn, timeout_s: float):
    """Run ``fn()`` on a daemon thread, bounded by ``timeout_s``. The
    probe/stats calls must never wedge the router on a hung replica —
    a timed-out worker thread is abandoned (daemon) rather than
    joined forever."""
    box: list = []
    done = threading.Event()

    def _run():
        try:
            box.append(("ok", fn()))
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            box.append(("err", e))
        done.set()

    t = threading.Thread(target=_run, daemon=True,
                         name="paddle-tpu-torch-router-probe")
    t.start()
    if not done.wait(timeout_s):
        raise TimeoutError(f"replica call exceeded {timeout_s}s")
    kind, val = box[0]
    if kind == "err":
        raise val
    return val


# ---------------------------------------------------------------------------
# replica clients
# ---------------------------------------------------------------------------

class LocalReplica:
    """In-process replica: the ``ServingEngine`` driven directly. The
    single-host topology (and the chaos suite's substrate) — same
    decision surface as the HTTP client: ``healthz()`` returns exactly
    the ``/healthz`` payload, ``stats()`` exactly ``/stats``."""

    def __init__(self, engine: ServingEngine, name: Optional[str] = None):
        self.engine = engine
        self.name = name

    def healthz(self) -> dict:
        return self.engine.health()[1]

    def stats(self) -> dict:
        return self.engine.stats()

    def submit(self, prompt, deadline_s=None, on_token=None, params=None,
               trace_id=None):
        if trace_id is not None:
            # fleet trace propagation, in-process flavor: the Request is
            # constructed on this thread inside engine.submit and adopts
            # the context — same join the traceparent header buys HTTP
            with _trace.trace_context(trace_id):
                return self.engine.submit(prompt, deadline_s=deadline_s,
                                          on_token=on_token, params=params)
        return self.engine.submit(prompt, deadline_s=deadline_s,
                                  on_token=on_token, params=params)

    def cancel(self, handle):
        self.engine.cancel(handle)

    def metrics_text(self) -> str:
        """This replica's Prometheus exposition (the federation scrape
        target). In-process replicas share one registry, so every
        LocalReplica of a process returns the same text — the federated
        roll-ups then multiply shared series by the replica count;
        real isolation needs the HTTP topology (one process each)."""
        return _exporters.prometheus_text()

    def trace_events(self, trace_id) -> dict:
        """Chrome-trace JSON for one propagated trace id — the
        replica-side half of a router attempt's merged fleet trace.
        Works even after this replica's engine crashed: the tracing
        ring is in-process state, not engine state."""
        return _trace.chrome_trace(trace_id)

    def warmup(self) -> dict:
        return self.engine.warmup()

    def start(self):
        self.engine.start()

    def drain(self, timeout_s: Optional[float] = None):
        self.engine.stop(drain_timeout_s=timeout_s)


class _HTTPAttempt:
    """Request-handle shim over a streaming ``POST /generate``: a
    daemon thread reads the NDJSON token lines and mirrors the
    ``Request`` surface the router's await loop uses (``done`` /
    ``status`` / ``output_tokens`` / ``error`` / ``result()``)."""

    def __init__(self, url: str, body: dict, on_token, timeout_s: float,
                 headers: Optional[Dict[str, str]] = None):
        self.output_tokens: List[int] = []
        self.status = RequestStatus.RUNNING
        self.error: Optional[str] = None
        self._done = threading.Event()
        self._on_token = on_token
        self._resp = None
        self._cancelled = False
        req = urllib.request.Request(
            url, data=json.dumps(dict(body, stream=True)).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        self._thread = threading.Thread(
            target=self._consume, args=(req, timeout_s), daemon=True,
            name="paddle-tpu-torch-router-http-attempt")
        self._thread.start()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def _finish(self, status, error=None):
        if not self._done.is_set():
            self.status = status
            self.error = error
            self._done.set()

    def _consume(self, req, timeout_s):
        try:
            self._resp = urllib.request.urlopen(req, timeout=timeout_s)
            for line in self._resp:
                rec = json.loads(line)
                if "token" in rec:
                    self.output_tokens.append(int(rec["token"]))
                    if self._on_token is not None:
                        try:
                            self._on_token(self, rec["token"])
                        except Exception:  # noqa: BLE001 — consumer bug
                            pass
                elif rec.get("done"):
                    self._finish(rec.get("status", RequestStatus.FAILED),
                                 rec.get("error"))
                    return
            self._finish(RequestStatus.FAILED, "stream ended without a "
                                               "done record")
        except urllib.error.HTTPError as e:
            # a non-200 carries a JSON error body (429 backpressure,
            # 400 bad-request/quarantine): surface the SERVER's message
            # — repr(e) would swallow it, and the router's poison
            # marker check reads this string
            try:
                err = json.loads(e.read()).get("error") or repr(e)
            except Exception:  # noqa: BLE001 — body unreadable
                err = repr(e)
            self._finish(RequestStatus.FAILED, err)
        except Exception as e:  # noqa: BLE001 — connection-level failure
            if self._cancelled:
                self._finish(RequestStatus.CANCELLED)
            else:
                self._finish(RequestStatus.FAILED, repr(e))

    def cancel(self):
        self._cancelled = True
        resp = self._resp
        if resp is not None:
            try:
                resp.close()  # server handler sees the broken pipe
            except Exception:  # noqa: BLE001
                pass

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError("HTTP attempt not finished")
        return list(self.output_tokens)


class HTTPReplica:
    """A replica behind ``serving.http`` (``ServingHTTPServer``) in
    another process — or another port of this one. Probes hit
    ``GET /healthz`` (503 payloads are read, not treated as transport
    errors: a saturated/draining replica is alive), submissions stream
    ``POST /generate``, drain posts ``/drain``."""

    def __init__(self, base_url: str, name: Optional[str] = None,
                 timeout_s: float = 5.0, request_timeout_s: float = 300.0):
        self.base_url = base_url.rstrip("/")
        self.name = name
        self.timeout_s = timeout_s
        self.request_timeout_s = request_timeout_s

    def _get(self, path: str) -> dict:
        try:
            with urllib.request.urlopen(self.base_url + path,
                                        timeout=self.timeout_s) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return json.loads(e.read())  # 503 payloads carry the status

    def healthz(self) -> dict:
        return self._get("/healthz")

    def stats(self) -> dict:
        return self._get("/stats")

    def metrics_text(self) -> str:
        """Raw ``GET /metrics`` text (Prometheus exposition — not
        JSON-decoded like ``_get``)."""
        with urllib.request.urlopen(self.base_url + "/metrics",
                                    timeout=self.timeout_s) as resp:
            return resp.read().decode("utf-8")

    def trace_events(self, trace_id) -> dict:
        """``GET /trace?trace=<propagated id>`` — the id is hex+dash,
        URL-safe as-is, and non-integer so the replica serves it as a
        string trace lane."""
        return self._get(f"/trace?trace={trace_id}")

    def submit(self, prompt, deadline_s=None, on_token=None, params=None,
               trace_id=None):
        p = params or SamplingParams()
        body = {"prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
                "max_new_tokens": p.max_new_tokens,
                "do_sample": p.do_sample, "temperature": p.temperature,
                "top_k": p.top_k, "top_p": p.top_p,
                "eos_token_id": p.eos_token_id, "seed": p.seed,
                "spec_k": p.spec_k, "priority": p.priority,
                "deadline_s": deadline_s}
        headers = {}
        if trace_id is not None:
            tp = _fleet.traceparent_of(trace_id)
            if tp is not None:
                headers[_fleet.TRACEPARENT_HEADER] = tp
        return _HTTPAttempt(self.base_url + "/generate", body, on_token,
                            self.request_timeout_s, headers=headers)

    def cancel(self, handle):
        handle.cancel()

    def drain(self, timeout_s: Optional[float] = None):
        req = urllib.request.Request(
            self.base_url + "/drain",
            data=json.dumps({"timeout_s": timeout_s}).encode(),
            headers={"Content-Type": "application/json"})
        wait = (timeout_s + self.timeout_s) if timeout_s is not None \
            else self.request_timeout_s
        with urllib.request.urlopen(req, timeout=wait) as resp:
            return json.loads(resp.read())


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclass
class RouterConfig:
    """Router knobs. Defaults are sized for the in-process test/bench
    topology; a real deployment mostly raises the timeouts."""

    # health gating
    probe_failures_to_eject: int = 3   # K consecutive failures -> eject
    probe_interval_s: float = 0.2      # background prober cadence
    probe_timeout_s: float = 1.0
    readmit_probes: int = 1            # consecutive ok probes to re-admit
    # load-aware admission
    stats_refresh_s: float = 0.25      # staleness bound on cached /stats
    stats_timeout_s: float = 1.0
    w_inflight: float = 1.0            # score weights (lower score wins)
    w_queue: float = 1.0
    w_util: float = 1.0
    w_ttft: float = 0.5
    # supervisor-aware shedding: scales the replica's restart pressure
    # (supervisor restarts_in_window / max_restarts, from /stats) so a
    # chronically-restarting replica sheds load BEFORE its crash-loop
    # breaker trips and the prober has to eject it (0.0 = off)
    w_restart: float = 0.5
    # deadline-aware retry
    max_retries_per_request: int = 2
    retry_backoff_base_s: float = 0.02
    retry_backoff_max_s: float = 0.5
    retry_jitter: float = 0.25         # +- fraction of the delay
    retry_amplification_cap: float = 0.5   # extra attempts <= cap*requests
    retry_amplification_floor: int = 4     # ... + floor (small-N slack)
    # tail-latency hedging
    hedge: bool = False
    hedge_ttft_factor: float = 4.0     # threshold = factor * replica p95
    hedge_min_wait_s: float = 0.25
    # routing-loop bounds
    unroutable_timeout_s: float = 5.0  # no admitting replica for this long
    drain_timeout_s: Optional[float] = 30.0
    auto_warmup: bool = True           # warm local replicas at registration
    seed: int = 0                      # retry-jitter PRNG (deterministic)
    # fleet observability plane (observability/fleet.py): the master
    # switch gates trace propagation, /metrics federation scrapes, SLO
    # observation, and straggler detection — the bench A/B lever
    fleet_observability: bool = True
    slo: Optional["_fleet.SLOConfig"] = None  # None -> SLOConfig()
    straggler_detection: bool = True
    straggler_mad_threshold: float = 3.5  # Iglewicz-Hoaglin convention
    straggler_min_replicas: int = 3    # below this the median is the fleet
    # admission-score penalty added while a replica is flagged straggler
    # (0.0 = detect-and-report only, never shed load)
    straggler_penalty: float = 0.0
    recent_requests: int = 256         # merged-trace lookup registry cap
    # SLO-driven brownout (rides the fleet plane: needs the SLOTracker's
    # burn rates for input, so fleet_observability off disables it too).
    # Escalation is driven from the probe loop; the ladder's actions
    # fire at submit/attempt/hedge time.
    brownout: bool = True
    brownout_recover_reports: int = 3  # healthy streak to de-escalate
    brownout_min_dwell_s: float = 2.0  # min residence per level
    brownout_batch_max_new_tokens: int = 16  # cap_batch_tokens clamp
    brownout_spec_k_cap: int = 0       # shrink_spec clamp (0 = plain)

    def __post_init__(self):
        if self.probe_failures_to_eject < 1:
            raise ValueError("probe_failures_to_eject must be >= 1: a "
                             "replica cannot be ejected on zero evidence")
        if self.max_retries_per_request < 0:
            raise ValueError("max_retries_per_request must be >= 0")
        if self.retry_amplification_cap < 0:
            raise ValueError("retry_amplification_cap must be >= 0")
        if self.straggler_mad_threshold <= 0:
            raise ValueError("straggler_mad_threshold must be > 0")
        if self.straggler_penalty < 0:
            raise ValueError("straggler_penalty must be >= 0 (a negative "
                             "penalty would ATTRACT load to stragglers)")
        if self.w_restart < 0:
            raise ValueError("w_restart must be >= 0 (a negative weight "
                             "would ATTRACT load to crash-looping replicas)")
        if self.recent_requests < 1:
            raise ValueError("recent_requests must be >= 1")
        if self.brownout_batch_max_new_tokens < 1:
            raise ValueError("brownout_batch_max_new_tokens must be >= 1 "
                             "(a zero-token cap silently discards work; "
                             "use shedding for that)")
        if self.brownout_spec_k_cap < 0:
            raise ValueError("brownout_spec_k_cap must be >= 0")


@dataclass
class _Load:
    """Last-known load snapshot of one replica (from /stats)."""

    ts: float = 0.0
    queue_depth: int = 0
    max_queue_depth: int = 1
    slots_busy: int = 0
    slots: int = 1
    util: float = 0.0
    ttft_p95: Optional[float] = None
    tpot_p50: Optional[float] = None   # straggler-detection input
    kv_tier: Optional[dict] = None     # hierarchical-KV tier state, for
    stale: bool = False                # cache-aware routing to read
    # supervisor restart pressure: restarts_in_window / max_restarts
    # (1.0 = one crash from the breaker) + quarantined-prompt count
    restart_pressure: float = 0.0
    quarantined_count: int = 0


class _Replica:
    """Router-side handle: client + health state + load cache."""

    def __init__(self, name: str, client):
        self.name = name
        self.client = client
        self.state = ReplicaState.HEALTHY
        self.consecutive_probe_failures = 0
        self.ok_streak = 0
        self.inflight = 0
        self.saturated_until = 0.0
        self.load = _Load()
        self.attempts = 0
        self.probe_failures = 0
        self.submit_failures = 0
        self.stats_errors = 0
        self.ejections = 0
        self.last_probe: Optional[dict] = None
        self.straggler = False         # robust-MAD TPOT outlier flag

    def row(self) -> dict:
        return {
            "name": self.name, "state": self.state,
            "inflight": self.inflight, "attempts": self.attempts,
            "consecutive_probe_failures": self.consecutive_probe_failures,
            "probe_failures": self.probe_failures,
            "submit_failures": self.submit_failures,
            "stats_errors": self.stats_errors,
            "ejections": self.ejections,
            "saturated": self.saturated_until > time.perf_counter(),
            "straggler": self.straggler,
            "load": {
                "queue_depth": self.load.queue_depth,
                "slots_busy": self.load.slots_busy,
                "slots": self.load.slots,
                "util": round(self.load.util, 4),
                "ttft_p95": self.load.ttft_p95,
                "tpot_p50": self.load.tpot_p50,
                "kv_tier": self.load.kv_tier,
                "stale": self.load.stale,
                "restart_pressure": round(self.load.restart_pressure, 4),
                "quarantined_count": self.load.quarantined_count,
            },
        }


# ---------------------------------------------------------------------------
# the caller-facing handle
# ---------------------------------------------------------------------------

class RouterRequest:
    """One routed request: survives replica failover. The caller-facing
    surface mirrors ``Request`` (``result()`` / ``stream()`` /
    ``cancel()`` / TTFT/TPOT), but tokens arrive through the router's
    relay, which guarantees EXACTLY-ONCE delivery across retries and
    hedges: a retried attempt re-derives the already-delivered prefix
    (deterministic PRNG chain) and the relay drops it; a superseded
    attempt's callbacks are dropped entirely — ``on_token`` never fires
    for a replica the request failed away from."""

    def __init__(self, prompt, params: SamplingParams,
                 deadline_s: Optional[float], on_token):
        self.id = next(_router_req_ids)
        self.prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        self.params = params
        # same identity the replica supervisors quarantine by: when an
        # attempt dies with the poison marker, THIS is the fingerprint
        # the router blacklists — no parsing of error strings needed
        self.fingerprint = request_fingerprint(self.prompt, params)
        self.arrival_ts = time.perf_counter()
        self.deadline_ts = (self.arrival_ts + deadline_s
                            if deadline_s is not None else None)
        self.on_token = on_token

        self.status = RequestStatus.QUEUED
        self.error: Optional[str] = None
        self.output_tokens: List[int] = []
        self.replica: Optional[str] = None   # current/winning replica
        self.attempts: List[dict] = []       # routing history
        self.retries = 0
        self.hedged = False
        self.first_token_ts: Optional[float] = None
        self.last_token_ts: Optional[float] = None
        self.finish_ts: Optional[float] = None
        self.cancel_requested = False

        self._lock = threading.Lock()
        self._done = threading.Event()
        self._stream_q: "queue.Queue" = queue.Queue()
        # attempt generations: the relay delivers only tokens of the
        # CURRENT generation, and only past the already-delivered count
        self._gen_iter = itertools.count(1)
        self._current_gen: Optional[int] = None
        self._hedge_gen: Optional[int] = None
        self._gen_counts: Dict[int, int] = {}
        self._root = _trace.begin_span(
            "router.request", cat="router", trace=f"router/{self.id}",
            args={"prompt_len": int(self.prompt.shape[0]),
                  "max_new_tokens": params.max_new_tokens})
        # fleet plane: one router.attempt span per submitted attempt
        # (distinct per retry/hedge), closed at whichever resolution
        # site fires first — finish() sweeps any survivors so the trace
        # is always nesting-complete; _observer (the router's SLO hook)
        # runs once at the terminal transition
        self._attempt_spans: Dict[int, object] = {}
        self._observer = None

    # -- deadline ------------------------------------------------------------
    def remaining_s(self) -> Optional[float]:
        if self.deadline_ts is None:
            return None
        return self.deadline_ts - time.perf_counter()

    # -- relay (engine threads) ----------------------------------------------
    def _on_attempt_token(self, gen: int, replica: str, token: int):
        deliver = False
        with self._lock:
            self._gen_counts[gen] = self._gen_counts.get(gen, 0) + 1
            idx = self._gen_counts[gen] - 1
            if gen == self._hedge_gen and not self.output_tokens \
                    and self._current_gen != gen:
                # hedge race: first token wins the request
                self._current_gen = gen
            if gen == self._current_gen and not self._done.is_set() \
                    and idx >= len(self.output_tokens):
                now = time.perf_counter()
                self.output_tokens.append(int(token))
                if self.first_token_ts is None:
                    self.first_token_ts = now
                self.last_token_ts = now
                self.replica = replica
                deliver = True
        if deliver:
            self._stream_q.put(int(token))
            if self.on_token is not None:
                try:
                    self.on_token(self, int(token))
                except Exception:  # noqa: BLE001 — consumer callback bug
                    pass

    def _set_current(self, gen: Optional[int]):
        with self._lock:
            self._current_gen = gen

    def _next_gen(self) -> int:
        return next(self._gen_iter)

    # -- fleet attempt spans -------------------------------------------------
    def _begin_attempt(self, gen: int, replica: str, hedge: bool,
                       trace_id: Optional[str]):
        sp = _trace.begin_span(
            "router.attempt", cat="router", trace=f"router/{self.id}",
            args={"gen": gen, "replica": replica, "hedge": hedge,
                  **({"trace_id": trace_id} if trace_id else {})})
        with self._lock:
            self._attempt_spans[gen] = sp

    def _end_attempt(self, gen: int, outcome: str):
        with self._lock:
            sp = self._attempt_spans.pop(gen, None)
        if sp is not None:
            _trace.end_span(sp, args={"outcome": outcome})

    # -- terminal ------------------------------------------------------------
    def finish(self, status: str, error: Optional[str] = None):
        with self._lock:
            if self.status in RequestStatus.FINAL:
                return
            self.status = status
            self.error = error
            self.finish_ts = time.perf_counter()
        _sm.router_requests_total.labels(status).inc()
        _trace.instant(status, cat="router", trace=f"router/{self.id}",
                       args={"generated": len(self.output_tokens),
                             **({"error": error} if error else {})})
        # close any attempt span still open (e.g. an in-flight attempt
        # at cancel/expire) before the root so children stay inside it
        for gen in list(self._attempt_spans):
            self._end_attempt(gen, status)
        _trace.end_span(self._root, args={"status": status,
                                          "retries": self.retries})
        if self._observer is not None:
            try:
                self._observer(self)
            except Exception:  # noqa: BLE001 — SLO accounting must never
                pass           # block a terminal transition
        self._stream_q.put(_STOP)
        self._done.set()

    # -- caller side ---------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self):
        self.cancel_requested = True

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"router request {self.id} not finished within {timeout}s "
                f"(status={self.status})")
        return list(self.output_tokens)

    def stream(self, timeout: Optional[float] = None):
        while True:
            item = self._stream_q.get(timeout=timeout)
            if item is _STOP:
                return
            yield item

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.arrival_ts

    @property
    def tpot_s(self) -> Optional[float]:
        if self.first_token_ts is None or self.last_token_ts is None:
            return None
        n = len(self.output_tokens) - 1
        if n <= 0:
            return None
        return (self.last_token_ts - self.first_token_ts) / n

    def debug_row(self) -> dict:
        return {
            "request_id": self.id, "status": self.status,
            "replica": self.replica,
            "generated": len(self.output_tokens),
            "retries": self.retries, "hedged": self.hedged,
            "attempts": list(self.attempts),
            "ttft_s": self.ttft_s, "tpot_s": self.tpot_s,
            "error": self.error,
        }


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class Router:
    """See the module docstring. Construct over replica clients (or
    bare ``ServingEngine``s, wrapped into ``LocalReplica``), then
    ``submit()`` — each request is driven by its own daemon thread
    through route -> attempt -> (retry/hedge) -> terminal. ``start()``
    runs the background prober; tests drive ``probe_once()`` manually
    for determinism."""

    def __init__(self, replicas, config: Optional[RouterConfig] = None,
                 **overrides):
        if config is None:
            config = RouterConfig(**overrides)
        elif overrides:
            raise ValueError("pass RouterConfig OR keyword overrides, "
                             "not both")
        self.config = config
        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {}
        self._rng = random.Random(config.seed)
        self._rng_lock = threading.Lock()
        self._rr_counter = itertools.count()
        self._requests = 0
        self._extra_attempts = 0   # retries + hedges (amplification)
        self._outcomes: Dict[str, int] = {}
        self._drivers: List[threading.Thread] = []
        self._running = False
        self._prober: Optional[threading.Thread] = None
        # bounded id -> RouterRequest registry: the merged-trace lookup
        # (GET /trace?request=<id> on router_http) needs the attempt
        # history after the caller's handle is gone
        self._recent: "Dict[int, RouterRequest]" = {}
        self.fleet_enabled = config.fleet_observability
        self._aggregator = _fleet.FleetMetricsAggregator()
        self._slo = _fleet.SLOTracker(config.slo or _fleet.SLOConfig())
        self._stragglers_flagged = 0
        # fingerprint -> where the quarantine was learned (replica name
        # or "retry"); merged from replica /stats and the retry path
        self._quarantined: Dict[str, str] = {}
        self._brownout = (
            _fleet.BrownoutController(
                recover_reports=config.brownout_recover_reports,
                min_dwell_s=config.brownout_min_dwell_s)
            if (config.brownout and config.fleet_observability) else None)
        for i, rep in enumerate(replicas):
            self.add_replica(rep, name=getattr(rep, "name", None) or f"r{i}")
        ref = weakref.ref(self)
        _trace.register_state_provider(
            "serving_router",
            lambda ref=ref: (ref().stats() if ref() is not None else None))
        _trace.register_state_provider(
            "serving_fleet",
            lambda ref=ref: (ref()._fleet_state()
                             if ref() is not None else None))

    # -- replica registry ----------------------------------------------------
    def add_replica(self, client, name: Optional[str] = None):
        """Register a replica (a client, or a bare engine). Local
        replicas are warmed up at registration (``auto_warmup``) and
        their background loop is started — a replica that enters
        rotation cold would pay its kernel builds out of the first
        routed request's deadline."""
        if isinstance(client, (ServingEngine, EngineSupervisor)):
            # a supervisor exposes the full engine surface, so the same
            # LocalReplica shim serves both: the router sees warm
            # restarts as a brief "restarting" 503, not a new replica
            client = LocalReplica(client)
        name = name or getattr(client, "name", None) \
            or f"r{len(self._replicas)}"
        client.name = name
        if self.config.auto_warmup and hasattr(client, "warmup"):
            try:
                warmed = bool(client.healthz().get("warmed_up"))
            except Exception:  # noqa: BLE001 — probe decides later
                warmed = True
            if not warmed:
                client.warmup()
        if hasattr(client, "start"):
            client.start()
        rep = _Replica(name, client)
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"duplicate replica name {name!r}")
            self._replicas[name] = rep
        _sm.router_replica_healthy.labels(name).set(1)
        _trace.instant("replica_added", cat="router", args={"replica": name})
        return rep

    def remove_replica(self, name: str):
        with self._lock:
            rep = self._replicas.pop(name, None)
        if rep is not None:
            rep.state = ReplicaState.STOPPED
            _sm.router_replica_healthy.labels(name).set(0)
            self._aggregator.forget(name)

    def replicas(self) -> List[dict]:
        with self._lock:
            return [r.row() for r in self._replicas.values()]

    def _rep_list(self) -> List[_Replica]:
        with self._lock:
            return list(self._replicas.values())

    # -- health probing ------------------------------------------------------
    def probe_once(self):
        """One probe round over every replica (the background prober's
        body; tests call it directly for determinism). Straggler
        detection rides the probe cadence — deterministic for tests,
        and the flags update even when no traffic is flowing."""
        for rep in self._rep_list():
            if rep.state in (ReplicaState.DRAINING, ReplicaState.STOPPED):
                continue
            self._probe(rep)
        self.update_stragglers()
        if self._brownout is not None:
            # brownout rides the probe cadence: deterministic for tests
            # (probe_once() -> exactly one control tick), and the
            # min-dwell hysteresis keeps the 0.2s cadence from racing
            # the ladder up
            self._brownout.update(self._slo.report())

    def _probe(self, rep: _Replica):
        cfg = self.config
        try:
            payload = _call_with_timeout(rep.client.healthz,
                                         cfg.probe_timeout_s)
        except TimeoutError:
            return self._probe_failed(rep, "timeout")
        except Exception:  # noqa: BLE001 — any transport/client error
            return self._probe_failed(rep, "error")
        if not isinstance(payload, dict) \
                or not isinstance(payload.get("status"), str):
            return self._probe_failed(rep, "malformed")
        rep.last_probe = payload
        status = payload["status"]
        if status == "ok":
            return self._probe_ok(rep, payload)
        if status == "saturated":
            # alive, just backed up: not a failure, but back off
            rep.saturated_until = time.perf_counter() + float(
                payload.get("retry_after_s") or 1.0)
            return self._probe_ok(rep, payload)
        if status == "restarting":
            # a supervised replica mid warm-restart: alive, coming back
            # with a warmed engine in well under a probe-ejection window
            # — back off briefly rather than burn an ejection strike
            # (if the restart FAILS the breaker flips the payload to
            # "crashed" + restarts_exhausted and ejection proceeds)
            rep.saturated_until = time.perf_counter() + 0.1
            rep.consecutive_probe_failures = 0
            return None
        if status in ("draining", "stopped"):
            # the replica is going away on its own terms
            if rep.state != ReplicaState.STOPPED:
                rep.state = (ReplicaState.DRAINING if status == "draining"
                             else ReplicaState.STOPPED)
                _sm.router_replica_healthy.labels(rep.name).set(0)
            return None
        if status in ("crashed", "stalled"):
            return self._probe_failed(rep, status)
        return self._probe_failed(rep, "malformed")

    def _probe_failed(self, rep: _Replica, reason: str):
        rep.probe_failures += 1
        rep.consecutive_probe_failures += 1
        rep.ok_streak = 0
        _sm.router_probe_failures_total.labels(reason).inc()
        if rep.state == ReplicaState.HEALTHY \
                and rep.consecutive_probe_failures \
                >= self.config.probe_failures_to_eject:
            rep.state = ReplicaState.EJECTED
            rep.ejections += 1
            _sm.router_ejections_total.inc()
            _sm.router_replica_healthy.labels(rep.name).set(0)
            _trace.instant("replica_ejected", cat="router",
                           args={"replica": rep.name, "reason": reason})

    def _probe_ok(self, rep: _Replica, payload: dict):
        rep.consecutive_probe_failures = 0
        if rep.state != ReplicaState.EJECTED:
            return
        # readmission is gated on the WARMUP probe: an engine that
        # reports ok but has not loaded its kernels would pay their build
        # out of the first routed request's deadline
        if not payload.get("warmed_up", True):
            rep.ok_streak = 0
            return
        rep.ok_streak += 1
        if rep.ok_streak >= self.config.readmit_probes:
            rep.state = ReplicaState.HEALTHY
            rep.ok_streak = 0
            _sm.router_readmissions_total.inc()
            _sm.router_replica_healthy.labels(rep.name).set(1)
            _trace.instant("replica_readmitted", cat="router",
                           args={"replica": rep.name})

    # -- load-aware pick -----------------------------------------------------
    def _refresh_load(self, rep: _Replica, now: float):
        if now - rep.load.ts <= self.config.stats_refresh_s:
            return
        rep.load.ts = now  # claim the refresh window even on failure
        try:
            st = _call_with_timeout(rep.client.stats,
                                    self.config.stats_timeout_s)
        except Exception:  # noqa: BLE001 — slow/broken stats != dead
            rep.stats_errors += 1
            rep.load.stale = True
            return
        try:
            ld = rep.load
            ld.queue_depth = int(st.get("queue_depth", 0))
            ld.max_queue_depth = max(1, int(st.get("max_queue_depth", 1)))
            ld.slots_busy = int(st.get("slots_busy", 0))
            ld.slots = max(1, int(st.get("slots", 1)))
            kv = st.get("kv_blocks") or {}
            ld.util = float(kv.get("utilization",
                                   ld.slots_busy / ld.slots))
            digests = st.get("latency_digests") or {}
            dig = digests.get("ttft_s") or {}
            ld.ttft_p95 = dig.get("p95")
            ld.tpot_p50 = (digests.get("tpot_s") or {}).get("p50")
            ld.kv_tier = st.get("kv_tier")
            ld.stale = False
            # quarantine propagation: the supervisor's /stats block is
            # the fleet-wide gossip channel — one replica's verdict
            # blacklists the fingerprint at THIS router for every
            # replica, on the normal stats cadence (no new endpoint)
            sup = st.get("supervisor")
            if isinstance(sup, dict):
                for fp in sup.get("quarantined") or ():
                    self._learn_quarantine(str(fp), rep.name)
                # restart pressure: how close this replica sits to its
                # crash-loop breaker — fraction of the windowed restart
                # budget already burned. Scored via w_restart so the
                # fleet sheds load off a flapping replica proactively
                # instead of waiting for restarts_exhausted ejection.
                budget = max(1, int(sup.get("max_restarts", 1) or 1))
                ld.restart_pressure = min(
                    1.0, int(sup.get("restarts_in_window", 0)) / budget)
                ld.quarantined_count = len(sup.get("quarantined") or ())
            else:
                ld.restart_pressure = 0.0
                ld.quarantined_count = 0
        except (TypeError, ValueError):
            rep.stats_errors += 1
            rep.load.stale = True
        # federation rides the same staleness-bounded cadence: the
        # metrics scrape never adds a second timer or failure mode
        if self.fleet_enabled:
            self._scrape_metrics(rep, now)

    def _scrape_metrics(self, rep: _Replica, now: float):
        """Scrape one replica's /metrics into the federation aggregator
        — timeout-guarded like /stats, staleness-bounded by the same
        refresh knob. A hung or failing scrape marks the replica's
        series stale (last-known values keep serving); it NEVER ejects:
        only /healthz probes decide rotation."""
        fn = getattr(rep.client, "metrics_text", None)
        if fn is None:  # chaos fakes / minimal clients: nothing to scrape
            return
        if not self._aggregator.should_scrape(rep.name, now,
                                              self.config.stats_refresh_s):
            return
        try:
            text = _call_with_timeout(fn, self.config.stats_timeout_s)
            self._aggregator.update(rep.name, text, now)
        except Exception:  # noqa: BLE001 — slow/broken scrape != dead
            self._aggregator.mark_stale(rep.name)

    def _score(self, rep: _Replica, ttft_norm: float) -> float:
        cfg = self.config
        ld = rep.load
        return (cfg.w_inflight * rep.inflight / ld.slots
                + cfg.w_queue * ld.queue_depth / ld.max_queue_depth
                + cfg.w_util * ld.util
                + cfg.w_ttft * ttft_norm
                + cfg.w_restart * ld.restart_pressure
                + (cfg.straggler_penalty if rep.straggler else 0.0))

    def _pick(self, exclude=()) -> tuple:
        """(replica, reason): the lowest-score admitting replica, or
        (None, why-not)."""
        now = time.perf_counter()
        cands = []
        saturated = False
        for rep in self._rep_list():
            if rep.state != ReplicaState.HEALTHY or rep.name in exclude:
                continue
            if rep.saturated_until > now:
                saturated = True
                continue
            self._refresh_load(rep, now)
            cands.append(rep)
        if not cands:
            return None, ("saturated" if saturated else "no_healthy_replica")
        p95s = [r.load.ttft_p95 for r in cands if r.load.ttft_p95]
        max_p95 = max(p95s) if p95s else None

        def key(rep):
            tn = (rep.load.ttft_p95 / max_p95
                  if max_p95 and rep.load.ttft_p95 else 0.0)
            return (self._score(rep, tn), rep.inflight,
                    next(self._rr_counter))

        return min(cands, key=key), "ok"

    # -- submission ----------------------------------------------------------
    def submit(self, prompt, deadline_s: Optional[float] = None,
               on_token=None, params: Optional[SamplingParams] = None,
               **sampling) -> RouterRequest:
        """Route one request; returns its handle immediately (a daemon
        driver thread owns the route/retry/hedge loop). The same
        surface as ``ServingEngine.submit`` — outputs for a given
        prompt + seed are bit-identical to a single engine's, whatever
        failover happened along the way."""
        if params is None:
            params = SamplingParams(**sampling)
        elif sampling:
            raise ValueError("pass params OR sampling kwargs, not both")
        fp = request_fingerprint(
            np.asarray(prompt, dtype=np.int32).reshape(-1), params)
        with self._lock:
            poisoned = fp in self._quarantined
        if poisoned:
            _sm.router_poison_blocked_total.labels("submit").inc()
            raise PoisonedRequestError(
                f"{POISON_MARKER}: request fingerprint {fp} is "
                f"quarantined fleet-wide (it crashed serving engines "
                f"until its restart budget ran out) — do not resubmit",
                fingerprint=fp)
        if self._brownout is not None and self._brownout.shed_batch \
                and params.priority == "batch":
            _sm.requests_shed_total.labels("batch").inc()
            raise QueueFullError(
                f"brownout level {self._brownout.level_name!r}: "
                f"batch-class work is shed while the fleet SLO is "
                f"burning — retry later or resubmit as interactive")
        with self._lock:
            have_any = any(r.state != ReplicaState.STOPPED
                           for r in self._replicas.values())
        if not have_any:
            raise NoReplicaError(
                "router has no live replicas (none registered, or all "
                "drained/stopped) — add_replica() a warmed engine first")
        rr = RouterRequest(prompt, params, deadline_s, on_token)
        if self.fleet_enabled:
            rr._observer = self._observe_slo
        with self._lock:
            self._requests += 1
            self._recent[rr.id] = rr
            while len(self._recent) > self.config.recent_requests:
                self._recent.pop(next(iter(self._recent)))
        t = threading.Thread(target=self._drive, args=(rr,), daemon=True,
                             name=f"paddle-tpu-torch-router-req-{rr.id}")
        t.start()
        return rr

    def _learn_quarantine(self, fp: str, source: str):
        """Blacklist a fingerprint router-wide (idempotent)."""
        with self._lock:
            if fp in self._quarantined:
                return
            self._quarantined[fp] = source
        _sm.router_poison_blocked_total.labels("learned").inc()
        _trace.instant("quarantine_learned", cat="router",
                       args={"fingerprint": fp, "source": source})

    def _observe_slo(self, rr: RouterRequest):
        """SLO observation at a request's terminal transition (the
        ``RouterRequest._observer`` hook). COMPLETED means completed
        within any deadline — EXPIRED is its own terminal state — so
        COMPLETED is exactly the goodput-good event."""
        self._slo.observe(rr.status, rr.ttft_s,
                          met_deadline=(rr.status
                                        == RequestStatus.COMPLETED))

    # -- the per-request driver ----------------------------------------------
    def _drive(self, rr: RouterRequest):
        cfg = self.config
        exclude: Dict[str, float] = {}
        unroutable_since: Optional[float] = None
        while True:
            if rr.cancel_requested:
                return rr.finish(RequestStatus.CANCELLED)
            rem = rr.remaining_s()
            if rem is not None and rem <= 0:
                return rr.finish(RequestStatus.EXPIRED,
                                 error="deadline passed while routing")
            rep, why = self._pick(exclude)
            if rep is None:
                _sm.router_unroutable_total.inc()
                if unroutable_since is None:
                    unroutable_since = time.perf_counter()
                elif time.perf_counter() - unroutable_since \
                        > cfg.unroutable_timeout_s:
                    return rr.finish(
                        RequestStatus.FAILED,
                        error=f"no admitting replica for "
                              f"{cfg.unroutable_timeout_s}s ({why}) — "
                              f"all replicas ejected, draining, or "
                              f"saturated")
                exclude.clear()  # reconsider everyone next round
                time.sleep(0.02)
                continue
            gen, handle, record = self._submit_attempt(rr, rep, hedge=False)
            if handle is None:
                if rr.done:
                    return  # fatal (bad request): finished inside
                # a refused submit does NOT reset the unroutable clock:
                # a fleet of replicas that all refuse must time out, not
                # loop forever between pick and refusal
                if unroutable_since is None:
                    unroutable_since = time.perf_counter()
                exclude[rep.name] = time.perf_counter()
                continue
            unroutable_since = None
            outcome = self._await(rr, rep, gen, handle, record)
            if outcome in ("done", "cancelled", "expired"):
                return
            # retriable: the attempt died with its replica
            exclude[rep.name] = time.perf_counter()
            if rr.cancel_requested:
                return rr.finish(RequestStatus.CANCELLED)
            ok, why_not = self._may_retry(rr)
            if not ok:
                return rr.finish(
                    RequestStatus.FAILED,
                    error=f"attempt on replica {rep.name!r} failed and "
                          f"{why_not}; last error: {record.get('error')}")
            with self._lock:
                self._extra_attempts += 1
            rr.retries += 1
            _sm.router_retries_total.inc()
            _trace.instant("retry", cat="router", trace=f"router/{rr.id}",
                           args={"n": rr.retries, "from": rep.name})
            if not self._retry_backoff(rr):
                return  # finished EXPIRED inside

    def _submit_attempt(self, rr: RouterRequest, rep: _Replica,
                        hedge: bool) -> tuple:
        """(gen, handle, attempt_record); handle None = not submitted
        (rejected/refused, record says why — or ``rr`` finished for a
        caller error no replica can fix)."""
        with self._lock:
            poisoned = rr.fingerprint in self._quarantined
        if poisoned:
            # quarantined between submission and this (re)try: the
            # retry path must not carry the poison to a fresh replica
            _sm.router_poison_blocked_total.labels("retry").inc()
            rr.finish(RequestStatus.FAILED,
                      error=f"{POISON_MARKER}: request fingerprint "
                            f"{rr.fingerprint} was quarantined while "
                            f"in flight — not retried")
            return 0, None, {"replica": rep.name, "outcome": "poisoned",
                             "hedge": hedge, "error": None,
                             "trace_id": None}
        gen = rr._next_gen()
        if hedge:
            with rr._lock:
                rr._hedge_gen = gen
        else:
            rr._set_current(gen)

        def _relay(_inner, tok, rr=rr, gen=gen, name=rep.name):
            rr._on_attempt_token(gen, name, tok)

        rem = rr.remaining_s()
        params = self._attempt_params(rr)
        # fleet trace propagation: each attempt (retry/hedge included)
        # gets a DISTINCT deterministic trace id — the replica-side span
        # tree records under it and the merged catapult file shows one
        # swimlane per attempt
        tid = (_fleet.attempt_trace_id(rr.id, gen)
               if self.fleet_enabled else None)
        record = {"replica": rep.name, "outcome": "submitted",
                  "hedge": hedge, "error": None, "trace_id": tid}
        rr.attempts.append(record)
        try:
            if tid is not None:
                try:
                    handle = rep.client.submit(
                        rr.prompt, deadline_s=rem, on_token=_relay,
                        params=params, trace_id=tid)
                except TypeError:
                    # pre-fleet client (no trace_id kwarg): submit
                    # without propagation rather than failing the
                    # request over an observability feature
                    record["trace_id"] = tid = None
                    handle = rep.client.submit(
                        rr.prompt, deadline_s=rem, on_token=_relay,
                        params=params)
            else:
                handle = rep.client.submit(rr.prompt, deadline_s=rem,
                                           on_token=_relay,
                                           params=params)
        except PoisonedRequestError as e:
            # the replica's supervisor already blacklisted this
            # fingerprint (its /stats hadn't been merged yet): learn it
            # and fail terminally — a poison verdict is never retried
            self._learn_quarantine(e.fingerprint or rr.fingerprint,
                                   rep.name)
            _sm.router_poison_blocked_total.labels("retry").inc()
            record.update(outcome="poisoned", error=repr(e))
            rr.finish(RequestStatus.FAILED, error=str(e))
            return gen, None, record
        except QueueFullError as e:
            rep.saturated_until = time.perf_counter() + \
                _sm.queue_wait_retry_after()
            record.update(outcome="rejected", error=str(e))
            return gen, None, record
        except (EngineStoppedError, RuntimeError) as e:
            # crashed / draining / stopped replica: routing failure,
            # probes will eject it — try elsewhere now
            rep.submit_failures += 1
            record.update(outcome="refused", error=repr(e))
            return gen, None, record
        except (TypeError, ValueError) as e:
            # caller error (bad prompt/params): no replica can help
            record.update(outcome="bad_request", error=repr(e))
            rr.finish(RequestStatus.FAILED, error=f"bad request: {e}")
            return gen, None, record
        rep.attempts += 1
        rep.inflight += 1
        _sm.router_attempts_total.inc()
        _sm.router_replica_inflight.labels(rep.name).set(rep.inflight)
        rr.status = RequestStatus.RUNNING
        rr._begin_attempt(gen, rep.name, hedge, tid)
        _trace.instant("routed", cat="router", trace=f"router/{rr.id}",
                       args={"replica": rep.name, "hedge": hedge})
        return gen, handle, record

    def _attempt_params(self, rr: RouterRequest) -> SamplingParams:
        """The params one attempt actually submits: under brownout,
        batch-class work gets its decode length clamped (level >=
        ``cap_batch_tokens``) and everyone's speculation width capped
        (level >= ``shrink_spec``) — explicit, per-attempt degradation
        that never mutates the caller's ``rr.params``."""
        bo = self._brownout
        if bo is None:
            return rr.params
        p = rr.params
        changes = {}
        if bo.cap_batch_tokens and p.priority == "batch" \
                and p.max_new_tokens > \
                self.config.brownout_batch_max_new_tokens:
            changes["max_new_tokens"] = \
                self.config.brownout_batch_max_new_tokens
        # spec_k None (the engine's default) is left as it is: the JAX
        # router compares None with the cap here and its driver thread
        # dies of the TypeError, leaving the request unfinished
        if bo.shrink_spec and p.spec_k is not None \
                and p.spec_k > self.config.brownout_spec_k_cap:
            changes["spec_k"] = self.config.brownout_spec_k_cap
        return _dc_replace(p, **changes) if changes else p

    def _release_attempt(self, rep: _Replica):
        rep.inflight = max(0, rep.inflight - 1)
        _sm.router_replica_inflight.labels(rep.name).set(rep.inflight)

    def _abandon(self, rr: RouterRequest, item, reason: str):
        """Detach + cancel an attempt the request is moving away from:
        its relay generation is no longer current, so even if the
        replica keeps decoding (a hung step that later resumes), its
        ``on_token`` pushes are dropped — the caller never sees a
        token from a replica the request failed away from."""
        rep, gen, handle, record = item
        try:
            rep.client.cancel(handle)
        except Exception:  # noqa: BLE001 — dead replica: nothing to cancel
            pass
        record["outcome"] = reason
        rr._end_attempt(gen, reason)
        self._release_attempt(rep)

    def _await(self, rr: RouterRequest, rep: _Replica, gen: int,
               handle, record: dict) -> str:
        """Wait out one attempt; returns "done" | "cancelled" |
        "expired" | "retriable". Handles hedging: the watch set grows
        to two attempts and the first token decides the winner."""
        cfg = self.config
        att_t0 = time.perf_counter()
        watch = [(rep, gen, handle, record)]
        hedged_here = False
        while True:
            # terminal checks the replicas can't make for us
            if rr.cancel_requested:
                for item in watch:
                    self._abandon(rr, item, "cancelled")
                rr.finish(RequestStatus.CANCELLED)
                return "cancelled"
            rem = rr.remaining_s()
            if rem is not None and rem <= -0.05:
                # the replica enforces the same deadline; the slack only
                # covers a replica too wedged to expire it itself
                for item in watch:
                    self._abandon(rr, item, "expired")
                rr.finish(RequestStatus.EXPIRED,
                          error="deadline passed during decode")
                return "expired"
            # finished attempts
            for item in list(watch):
                r, g, h, rec = item
                if not h.done:
                    continue
                watch.remove(item)
                self._release_attempt(r)
                rr._end_attempt(g, h.status)
                with rr._lock:
                    is_current = (g == rr._current_gen)
                if not is_current:
                    # superseded (lost hedge / abandoned): bookkeeping
                    # only — its tokens were dropped by the relay
                    rec["outcome"] = ("hedge_lost"
                                      if h.status == RequestStatus.COMPLETED
                                      else "stale_" + h.status)
                    rec["error"] = h.error
                    continue
                if h.status == RequestStatus.COMPLETED:
                    rec["outcome"] = "completed"
                    for other in watch:  # hedge loser still running
                        self._abandon(rr, other, "hedge_lost")
                    rr.replica = r.name
                    rr.finish(RequestStatus.COMPLETED)
                    return "done"
                if h.status == RequestStatus.EXPIRED:
                    rec["outcome"] = "expired"
                    for other in watch:
                        self._abandon(rr, other, "expired")
                    rr.finish(RequestStatus.EXPIRED,
                              error=h.error or "deadline passed")
                    return "expired"
                if h.status == RequestStatus.CANCELLED \
                        and rr.cancel_requested:
                    rec["outcome"] = "cancelled"
                    rr.finish(RequestStatus.CANCELLED)
                    return "cancelled"
                if h.error and POISON_MARKER in str(h.error):
                    # the replica's supervisor quarantined this request
                    # MID-FLIGHT (it was implicated in its last allowed
                    # crash). The marker rides the terminal error string
                    # — which survives the HTTP NDJSON done-record — so
                    # the verdict propagates on the retry path too:
                    # terminal here, blacklisted everywhere.
                    rec["outcome"] = "poisoned"
                    rec["error"] = h.error
                    self._learn_quarantine(rr.fingerprint, r.name)
                    _sm.router_poison_blocked_total.labels("retry").inc()
                    for other in watch:
                        self._abandon(rr, other, "poisoned")
                    rr.finish(RequestStatus.FAILED, error=h.error)
                    return "done"
                # FAILED / REJECTED / engine-side cancel we didn't ask
                # for: the attempt died with its replica -> retriable
                rec["outcome"] = "failed"
                rec["error"] = h.error
                if watch:
                    # a hedge is still racing: promote it to current
                    r2, g2, _h2, _rec2 = watch[0]
                    rr._set_current(g2)
                    rep = r2
                    continue
                return "retriable"
            if not watch:
                return "retriable"
            # replica ejected/stopped under a live attempt (hang or
            # crash the probe saw first): abandon and fail over
            for item in list(watch):
                r, g, h, rec = item
                if r.state in (ReplicaState.EJECTED, ReplicaState.STOPPED):
                    watch.remove(item)
                    with rr._lock:
                        lost_current = (g == rr._current_gen)
                        if lost_current:
                            rr._current_gen = None
                    self._abandon(rr, item, "replica_lost")
                    rec["error"] = f"replica {r.name!r} {r.state} with " \
                                   f"the attempt in flight"
                    if lost_current and watch:
                        r2, g2, _h2, _rec2 = watch[0]
                        rr._set_current(g2)
                        rep = r2
            if not watch:
                return "retriable"
            # hedging: first token slower than the digest-derived
            # threshold -> race a second replica (suppressed from
            # brownout level "no_hedge" up: a hedge is a deliberate
            # duplicate, the first capacity to reclaim under overload)
            if cfg.hedge and not hedged_here and not rr.output_tokens \
                    and len(watch) == 1 \
                    and not (self._brownout is not None
                             and self._brownout.hedge_disabled):
                p95 = watch[0][0].load.ttft_p95
                threshold = max(cfg.hedge_min_wait_s,
                                cfg.hedge_ttft_factor * p95 if p95 else 0.0)
                if time.perf_counter() - att_t0 > threshold:
                    hedged_here = True
                    cand, _why = self._pick(exclude=(watch[0][0].name,))
                    if cand is not None:
                        g2, h2, rec2 = self._submit_attempt(
                            rr, cand, hedge=True)
                        if h2 is not None:
                            rr.hedged = True
                            with self._lock:
                                self._extra_attempts += 1
                            _sm.router_hedges_total.inc()
                            _trace.instant(
                                "hedged", cat="router",
                                trace=f"router/{rr.id}",
                                args={"to": cand.name,
                                      "from": watch[0][0].name})
                            watch.append((cand, g2, h2, rec2))
            # once a hedge race is decided (first token), cancel the
            # loser immediately instead of letting it decode to the end
            if len(watch) > 1 and rr.output_tokens:
                with rr._lock:
                    cur = rr._current_gen
                for item in list(watch):
                    if item[1] != cur:
                        watch.remove(item)
                        self._abandon(rr, item, "hedge_lost")
            # block on the primary's completion event when it has one
            # (push wake-up); fall back to a short poll slice
            ev = getattr(watch[0][2], "_done", None)
            if ev is not None:
                ev.wait(0.01)
            else:
                time.sleep(0.005)

    # -- retry policy --------------------------------------------------------
    def _may_retry(self, rr: RouterRequest) -> tuple:
        cfg = self.config
        if rr.cancel_requested:
            return False, "the request was cancelled (cancelled requests " \
                          "are never retried)"
        if rr.retries >= cfg.max_retries_per_request:
            return False, (f"its retry budget is exhausted "
                           f"({cfg.max_retries_per_request} retries)")
        with self._lock:
            cap = (cfg.retry_amplification_cap * max(1, self._requests)
                   + cfg.retry_amplification_floor)
            if self._extra_attempts + 1 > cap:
                return False, (
                    f"the global retry-amplification cap is exhausted "
                    f"({self._extra_attempts} extra attempts vs cap "
                    f"{cap:.1f} = {cfg.retry_amplification_cap} x "
                    f"{self._requests} requests + "
                    f"{cfg.retry_amplification_floor}) — a failure storm "
                    f"must shed load, not multiply it")
        return True, ""

    def _retry_backoff(self, rr: RouterRequest) -> bool:
        """Capped exponential backoff with seeded jitter, bounded by
        the remaining deadline. Returns False (after finishing the
        request EXPIRED) when the deadline cannot survive the wait."""
        cfg = self.config
        delay = min(cfg.retry_backoff_base_s * (2 ** (rr.retries - 1)),
                    cfg.retry_backoff_max_s)
        with self._rng_lock:
            delay *= 1.0 + cfg.retry_jitter * self._rng.uniform(-1.0, 1.0)
        delay = max(delay, 0.0)
        rem = rr.remaining_s()
        if rem is not None and rem <= delay:
            rr.finish(RequestStatus.EXPIRED,
                      error=f"deadline would pass during retry backoff "
                            f"({delay:.3f}s wait, {max(rem, 0):.3f}s left)")
            return False
        end = time.perf_counter() + delay
        while time.perf_counter() < end:
            if rr.cancel_requested:
                rr.finish(RequestStatus.CANCELLED)
                return False
            time.sleep(min(0.01, max(end - time.perf_counter(), 0)))
        return True

    # -- fleet observability plane -------------------------------------------
    def update_stragglers(self):
        """Recompute per-replica straggler flags: robust modified
        z-score (MAD) of each healthy replica's TPOT p50 against the
        fleet, one-sided (only SLOW outliers are stragglers — an
        unusually fast replica is a gift, not a fault). Flag
        transitions emit a trace instant and bump the counter;
        detection never ejects — at most it adds the configured
        admission-score penalty."""
        cfg = self.config
        if not (self.fleet_enabled and cfg.straggler_detection):
            return
        now = time.perf_counter()
        healthy = [r for r in self._rep_list()
                   if r.state == ReplicaState.HEALTHY]
        for rep in healthy:
            self._refresh_load(rep, now)
        sampled = [r for r in healthy if r.load.tpot_p50 is not None]
        if len(sampled) < cfg.straggler_min_replicas:
            for rep in healthy:
                self._set_straggler(rep, False)
            return
        zs = _fleet.mad_zscores([r.load.tpot_p50 for r in sampled])
        flagged = {r.name for r, z in zip(sampled, zs)
                   if z > cfg.straggler_mad_threshold}
        for rep in healthy:
            self._set_straggler(rep, rep.name in flagged)

    def _set_straggler(self, rep: _Replica, flag: bool):
        if flag and not rep.straggler:
            self._stragglers_flagged += 1
            _sm.router_stragglers_total.inc()
            _trace.instant("replica_straggler", cat="router",
                           args={"replica": rep.name,
                                 "tpot_p50": rep.load.tpot_p50})
        elif rep.straggler and not flag:
            _trace.instant("replica_recovered", cat="router",
                           args={"replica": rep.name})
        rep.straggler = flag
        _sm.router_replica_straggler.labels(rep.name).set(1 if flag else 0)

    def federated_metrics_text(self) -> str:
        """The fleet's federated Prometheus exposition (router
        ``GET /metrics``): every replica's series under a
        ``replica=<name>`` label plus ``replica="fleet"`` roll-ups.
        Refreshes due scrapes first (staleness-bounded, timeout-
        guarded) so the endpoint works with no traffic flowing."""
        if self.fleet_enabled:
            now = time.perf_counter()
            for rep in self._rep_list():
                if rep.state == ReplicaState.STOPPED:
                    continue
                self._scrape_metrics(rep, now)
        return self._aggregator.render()

    def slo_report(self) -> dict:
        """The fleet SLO verdict (router ``GET /slo``): per-objective
        multi-window burn rates and ok/breach flags, plus the brownout
        ladder state the verdict drives."""
        out = self._slo.report()
        if self._brownout is not None:
            out["brownout"] = self._brownout.report()
        return out

    def merged_trace(self, request_id: int) -> Optional[dict]:
        """ONE catapult file for one routed request: the router's own
        lane plus each attempt's replica-side span tree, fetched by the
        attempt's propagated trace id and merged side by side — a
        crash-failover request renders attempt 1 on the dead replica
        and attempt 2 on the survivor. None for an unknown/evicted id.
        Attempt fetches are timeout-guarded; an unreachable replica
        costs its lane, not the merge."""
        with self._lock:
            rr = self._recent.get(request_id)
        if rr is None:
            return None
        parts = [(f"router request {request_id}",
                  _trace.chrome_trace(f"router/{request_id}"))]
        for i, att in enumerate(list(rr.attempts), 1):
            tid = att.get("trace_id")
            if not tid:
                continue
            with self._lock:
                rep = self._replicas.get(att.get("replica"))
            fn = getattr(rep.client, "trace_events", None) \
                if rep is not None else None
            if fn is None:
                continue
            try:
                events = _call_with_timeout(
                    lambda fn=fn, tid=tid: fn(tid),
                    self.config.stats_timeout_s)
            except Exception:  # noqa: BLE001 — lane lost, merge survives
                continue
            if not (events or {}).get("traceEvents"):
                continue  # refused/rejected attempt: nothing replica-side
            parts.append(
                (f"attempt {i} [{att.get('replica')}]"
                 f"{' (hedge)' if att.get('hedge') else ''}", events))
        return _fleet.merge_catapult(parts)

    def _fleet_state(self) -> Optional[dict]:
        """Flight-recorder state provider: the fleet plane's view in
        crash dumps / ``observability.snapshot()``."""
        if not self.fleet_enabled:
            return None
        return {
            "slo": self._slo.report(),
            "federation": self._aggregator.stats(),
            "stragglers": {r.name: r.straggler
                           for r in self._rep_list()},
            "stragglers_flagged": self._stragglers_flagged,
            "brownout": (self._brownout.report()
                         if self._brownout is not None else None),
            "quarantined": sorted(self._quarantined),
        }

    # -- drain / lifecycle ---------------------------------------------------
    def drain(self, name: str, timeout_s: Optional[float] = None,
              wait: bool = True):
        """Gracefully take a replica out of rotation: stop routing to
        it immediately, let its in-flight requests finish (the
        engine-side drain), then mark it stopped. New traffic keeps
        flowing to the other replicas the whole time."""
        with self._lock:
            rep = self._replicas.get(name)
        if rep is None:
            raise KeyError(f"no replica named {name!r}")
        rep.state = ReplicaState.DRAINING
        _sm.router_replica_healthy.labels(name).set(0)
        _sm.router_drains_total.inc()
        _trace.instant("replica_draining", cat="router",
                       args={"replica": name})
        timeout_s = timeout_s if timeout_s is not None \
            else self.config.drain_timeout_s

        def _do():
            try:
                rep.client.drain(timeout_s)
            except Exception:  # noqa: BLE001 — a dead replica is drained
                pass
            rep.state = ReplicaState.STOPPED

        if wait:
            _do()
        else:
            threading.Thread(
                target=_do, daemon=True,
                name=f"paddle-tpu-torch-router-drain-{name}").start()

    def drain_all(self, timeout_s: Optional[float] = None):
        """Drain every replica concurrently (the SIGTERM path)."""
        names = [r.name for r in self._rep_list()
                 if r.state in (ReplicaState.HEALTHY, ReplicaState.EJECTED)]
        threads = [threading.Thread(target=self.drain,
                                    args=(n, timeout_s), daemon=True)
                   for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def start(self):
        """Run the background prober (health gating without manual
        ``probe_once()`` calls)."""
        with self._lock:
            if self._running:
                return self
            self._running = True
        self._prober = threading.Thread(target=self._probe_loop,
                                        name="paddle-tpu-torch-router-prober",
                                        daemon=True)
        self._prober.start()
        return self

    def _probe_loop(self):
        while self._running:
            self.probe_once()
            time.sleep(self.config.probe_interval_s)

    def stop(self, drain: bool = False,
             timeout_s: Optional[float] = None):
        """Stop the prober; ``drain=True`` also drains every replica
        (graceful full shutdown)."""
        self._running = False
        if self._prober is not None:
            self._prober.join(timeout=max(1.0,
                                          self.config.probe_interval_s * 4))
            self._prober = None
        if drain:
            self.drain_all(timeout_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            requests = self._requests
            extra = self._extra_attempts
            quarantined = dict(self._quarantined)
        return {
            "replicas": self.replicas(),
            "requests": requests,
            "extra_attempts": extra,
            "amplification": round(1.0 + extra / requests, 4)
            if requests else None,
            "quarantine": {"fingerprints": sorted(quarantined),
                           "sources": quarantined},
            "brownout": (self._brownout.report()
                         if self._brownout is not None else None),
            "fleet": {
                "enabled": self.fleet_enabled,
                "federation": self._aggregator.stats(),
                "stragglers_flagged": self._stragglers_flagged,
                "slo_observed": self._slo.observed,
            },
            "config": {
                "probe_failures_to_eject":
                    self.config.probe_failures_to_eject,
                "max_retries_per_request":
                    self.config.max_retries_per_request,
                "retry_amplification_cap":
                    self.config.retry_amplification_cap,
                "hedge": self.config.hedge,
                "straggler_penalty": self.config.straggler_penalty,
                "brownout": self.config.brownout,
            },
        }
