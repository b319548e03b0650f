"""Self-healing supervision for the serving engine (counterpart of
``paddle_tpu/serving/supervisor.py``): warm restart after a decode-loop
crash, with innocent requests carried across the restart and
deterministically crashing "poison" requests quarantined.

An unsupervised engine's crash fails EVERY queued and running request
and only a fresh engine recovers: the right floor, since ``result()``
callers must never hang, but one bad step becomes a replica-wide outage,
and a request that crashes the step every time (a "poison" request)
rides a router's retries from replica to replica. ``EngineSupervisor``
closes both holes in process:

- **Warm restart.** The supervisor installs the engine's crash hook
  (``_crash_hook``), which runs inside ``_on_loop_crash`` after the
  flight dump and BEFORE ``_fail_inflight``: the only window in which
  capture is possible, because ``Request.finish`` is idempotent and
  irreversible. The hook detaches every queued request and every
  running one (rebuilt onto the seed-deterministic PRNG replay that
  preemption uses, so the resumed decode is bit-identical); a restart
  thread releases the dead engine's KV pools, builds a FRESH engine
  from the same model, configuration and device, ``warmup()``s it (the
  kernels were built by the first engine, so it builds nothing),
  requeues the survivors at the queue front in FCFS order and swaps it
  in. Callers holding ``Request`` handles see a latency blip: same
  objects, same streams, same tokens.

- **Crash-loop breaker.** More than ``max_restarts`` crashes inside
  ``restart_window_s`` means the crash is not transient: the supervisor
  stays crashed, fails anything pending with an explicit error, and
  ``health()`` reports ``crashed`` with ``restarts_exhausted`` so a
  router ejects the replica.

- **Poison quarantine.** The requests RUNNING in the crashing step are
  suspects, requeued flagged ``quarantine_probe``: the engine admits a
  probe only into an idle pool, alone, so a repeat crash implicates one
  fingerprint. A fingerprint implicated in ``quarantine_crashes``
  distinct crashes fails terminally with a ``PoisonedRequestError``
  message, lands on the supervisor's blacklist and is refused at
  ``submit()`` from then on. A router learns the blacklist from
  ``stats()`` and from the error marker on its retry path, so one poison
  request costs the fleet at most ``quarantine_crashes`` restarts.

Injected chaos faults raise at the top of ``step()``, before any kernel
launch, so a supervised restart never leaves a half-launched step. A
device-side fault (an illegal address, a device assert) poisons the
CUDA context itself: no in-process restart recovers that, the rebuilt
engine's warmup fails, and the supervisor stays crashed exactly as for
a failed rebuild.

The supervisor exposes the ENGINE surface (``submit`` / ``cancel`` /
``health`` / ``stats`` / ``warmup`` / ``start`` / ``stop`` / ``drain``
and attribute delegation for everything else), so it drops in wherever
a ``ServingEngine`` goes: ``LocalReplica(EngineSupervisor(...))`` under
a router, or ``ServingHTTPServer(EngineSupervisor(...))`` behind HTTP.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from ..observability import tracing as _tracing
from . import metrics as _sm
from .engine import ServingEngine
from .request import (Request, RequestStatus, SamplingParams,
                      request_fingerprint)

__all__ = ["EngineSupervisor", "PoisonedRequestError", "POISON_MARKER"]

# the marker every quarantine surface carries: the terminal Request
# error string, the HTTP error body, and the router's retry path all
# match on it, so "is this failure poison?" is one substring test that
# survives serialization across the replica boundary
POISON_MARKER = "PoisonedRequestError"


class PoisonedRequestError(ValueError):
    """The request's fingerprint is quarantined: it was implicated in
    the quarantine budget's worth of distinct engine crashes, and no
    replica will re-admit it. Subclasses ``ValueError`` deliberately —
    every existing bad-request surface (HTTP 400, the router's
    terminal ``bad_request`` taxonomy) already treats it as
    non-retriable, which is exactly the quarantine contract: retrying
    poison is how fleets crash-loop."""

    def __init__(self, msg: str, fingerprint: Optional[str] = None):
        super().__init__(msg)
        self.fingerprint = fingerprint


class EngineSupervisor:
    """Wraps a ``ServingEngine`` with warm restart, a crash-loop
    breaker, and poison-request quarantine. Construction mirrors
    ``ServingEngine``: pass a ``ServingConfig`` or field overrides.

    ``device`` is passed to every engine it builds (``None`` resolves to
    ``cuda``, as for ``ServingEngine``): a rebuilt engine lives where the
    first one did.

    >>> sup = EngineSupervisor(model, max_slots=4, max_len=128)
    >>> sup.warmup(); sup.start()
    >>> req = sup.submit(prompt, max_new_tokens=32)   # engine surface
    """

    GUARDED_BY = {
        "_engine": "_lock", "_pending": "_lock", "_implicated": "_lock",
        "_quarantined": "_lock", "_restart_ts": "_lock",
        "_restarting": "_lock", "_broken": "_lock", "_crashes": "_lock",
        "_restarts": "_lock", "_started": "_lock",
        "_last_restart_s": "_lock",
    }

    def __init__(self, model, config=None, device=None, draft_model=None,
                 max_restarts: int = 3, restart_window_s: float = 60.0,
                 quarantine_crashes: int = 2,
                 restart_grace_s: float = 30.0,
                 warmup_on_restart: bool = True, **overrides):
        if max_restarts < 1:
            raise ValueError("max_restarts must be >= 1: a supervisor "
                             "that never restarts is just an engine")
        if quarantine_crashes < 1:
            raise ValueError("quarantine_crashes must be >= 1")
        self._model = model
        self._device = device
        self._draft_model = draft_model
        self.max_restarts = int(max_restarts)
        self.restart_window_s = float(restart_window_s)
        self.quarantine_crashes = int(quarantine_crashes)
        self.restart_grace_s = float(restart_grace_s)
        self.warmup_on_restart = bool(warmup_on_restart)

        self._lock = threading.RLock()
        self._pending: list = []          # captured, awaiting requeue
        self._implicated: dict = {}       # fingerprint -> distinct crashes
        self._quarantined: dict = {}      # fingerprint -> quarantine info
        self._restart_ts: deque = deque() # breaker window
        self._rebuild_hooks: list = []    # called with each fresh engine
        self._restarting = False
        self._broken = False
        self._crashes = 0
        self._restarts = 0
        self._started = False
        self._last_restart_s: Optional[float] = None
        self._engine_ready = threading.Event()
        self._engine_ready.set()

        self._engine = self._build(config=config, **overrides)
        self._config = self._engine.config  # rebuilds reuse the resolved one

    # -- engine lifecycle ----------------------------------------------------
    def _build(self, config=None, **overrides) -> ServingEngine:
        eng = ServingEngine(self._model, config=config, device=self._device,
                            draft_model=self._draft_model, **overrides)
        eng._crash_hook = self._on_engine_crash
        return eng

    @property
    def engine(self) -> ServingEngine:
        """The CURRENT engine (swapped atomically on restart)."""
        with self._lock:
            return self._engine

    def add_rebuild_hook(self, fn):
        """Register ``fn(new_engine)``, called on every warm restart
        with the freshly built (not yet warmed) engine — how chaos
        faults and instrumentation survive the engine swap."""
        self._rebuild_hooks.append(fn)
        return self

    # -- the crash path ------------------------------------------------------
    def _on_engine_crash(self, engine: ServingEngine, exc: BaseException):
        """The engine's ``_crash_hook``: runs on the dying serve-loop
        thread, step lock held, flight dump taken, requests not yet
        failed. Detaches survivors, updates the quarantine ledger, and
        (budget permitting) kicks off the restart thread. Anything NOT
        detached here is failed by ``_fail_inflight`` right after —
        the unsupervised semantics are the fallback, never silence."""
        err = repr(exc)
        with self._lock:
            if self._broken or self._stopped_flag():
                return  # no engine is coming back; let the crash path fail
            if engine is not self._engine:
                return  # a stale, already-replaced engine died again
            self._crashes += 1
            running, queued = engine._export_inflight()
            survivors = []
            for req in running:
                fp = req.fingerprint
                n = self._implicated.get(fp, 0) + 1
                self._implicated[fp] = n
                if n >= self.quarantine_crashes:
                    self._quarantine(fp, req, err)
                else:
                    req.quarantine_probe = True  # re-admitted solo
                    survivors.append(req)
            _sm.supervisor_requeued_total.labels("running").inc(
                len(survivors))
            _sm.supervisor_requeued_total.labels("queued").inc(len(queued))
            # breaker: restarts inside the sliding window, incl. this one
            now = time.perf_counter()
            self._restart_ts.append(now)
            while self._restart_ts and \
                    now - self._restart_ts[0] > self.restart_window_s:
                self._restart_ts.popleft()
            if len(self._restart_ts) > self.max_restarts:
                self._broken = True
                _tracing.instant(
                    "supervisor_breaker_open", cat="supervisor",
                    trace="supervisor",
                    args={"restarts": self._restarts,
                          "window_s": self.restart_window_s,
                          "error": err})
                for req in survivors + queued:
                    req.finish(
                        RequestStatus.FAILED,
                        error=f"engine crash-loop: restart budget "
                              f"exhausted ({self.max_restarts} restarts "
                              f"in {self.restart_window_s}s); last "
                              f"crash: {err}")
                return
            # survivors ride to the fresh engine: running first (they
            # hold the oldest FCFS positions), then the queued tail
            self._pending = survivors + queued
            self._restarting = True
            self._engine_ready.clear()
            crashes = self._crashes
        _tracing.instant(
            "supervisor_restart_begin", cat="supervisor",
            trace="supervisor",
            args={"crash": crashes, "error": err,
                  "captured_running": len(survivors),
                  "captured_queued": len(queued)})
        threading.Thread(target=self._rebuild, args=(engine,),
                         name="paddle-tpu-torch-supervisor",
                         daemon=True).start()

    # holds-lock: _lock
    def _quarantine(self, fp: str, req: Request, err: str):
        """Terminal verdict (caller holds the lock): blacklist the
        fingerprint and fail the request with the poison marker."""
        self._quarantined[fp] = {
            "fingerprint": fp,
            "crashes": self._implicated.get(fp, 0),
            "last_error": err,
            "request_id": req.id,
            "ts": time.time(),
        }
        _sm.requests_quarantined_total.inc()
        req._tr_event("quarantined", fingerprint=fp)
        req.finish(RequestStatus.FAILED, error=self.poison_error(fp))

    # holds-lock: _lock
    def poison_error(self, fp: str) -> str:
        """The actionable quarantine error (carries ``POISON_MARKER``;
        callers hold the lock — ``_implicated`` is read under it)."""
        n = self._implicated.get(fp, self.quarantine_crashes)
        return (f"{POISON_MARKER}: request fingerprint {fp} was "
                f"implicated in {n} engine crash(es) (quarantine budget "
                f"{self.quarantine_crashes}) and is quarantined "
                f"fleet-wide — do not resubmit this request")

    def _rebuild(self, dead: ServingEngine):
        """The restart thread: the dead engine's KV pools released, a
        fresh engine, warmup (nothing to build), survivors requeued at
        the front, atomic swap, loop restarted."""
        t0 = time.perf_counter()
        # the dead engine never steps again (its requests are exported):
        # its pools go before the new ones are made, so a restart never
        # holds two pools of this replica on the device
        dead._release_device_state()
        try:
            eng = self._build(config=self._config)
            for hook in list(self._rebuild_hooks):
                try:
                    hook(eng)
                except Exception:  # noqa: BLE001 — a broken hook must not
                    pass           # turn a warm restart into an outage
            if self.warmup_on_restart:
                eng.warmup()
        except Exception as e:  # noqa: BLE001 — rebuild failed: stay crashed
            with self._lock:
                self._broken = True
                pending, self._pending = self._pending, []
                self._restarting = False
            for req in pending:
                req.finish(RequestStatus.FAILED,
                           error=f"supervised restart failed: {e!r}")
            self._engine_ready.set()
            return
        with self._lock:
            pending, self._pending = self._pending, []
            started = self._started
        # queue front in FCFS order: requeue() is appendleft, so walk
        # the survivors newest-first
        for req in reversed(pending):
            if req.status in RequestStatus.FINAL:
                continue  # cancelled/finished while the engine was down
            eng.scheduler.requeue(req)
        with self._lock:
            self._engine = eng
            self._restarts += 1
            restarts = self._restarts
            self._restarting = False
            self._last_restart_s = time.perf_counter() - t0
        _sm.supervisor_restarts_total.inc()
        _tracing.instant(
            "supervisor_restart_done", cat="supervisor", trace="supervisor",
            args={"restart": restarts,
                  "wall_s": round(time.perf_counter() - t0, 3),
                  "requeued": len(pending)})
        if started:
            eng.start()
        self._engine_ready.set()

    def _stopped_flag(self) -> bool:
        with self._lock:
            eng = self._engine
        return eng.stopped or eng.draining

    # -- the engine surface --------------------------------------------------
    def submit(self, prompt, deadline_s: Optional[float] = None,
               on_token=None, params: Optional[SamplingParams] = None,
               **sampling) -> Request:
        """``ServingEngine.submit`` plus the quarantine gate: a
        blacklisted fingerprint is refused with ``PoisonedRequestError``
        before it can touch the engine. During a warm restart the
        submit blocks (up to ``restart_grace_s``) for the fresh engine
        instead of bouncing — the restart is a latency blip, not an
        error burst."""
        if params is None:
            params = SamplingParams(**sampling)
        elif sampling:
            raise ValueError("pass params OR sampling kwargs, not both")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        fp = request_fingerprint(prompt, params)
        with self._lock:
            if fp in self._quarantined:
                raise PoisonedRequestError(self.poison_error(fp),
                                           fingerprint=fp)
            restarting = self._restarting
        if restarting:
            self._engine_ready.wait(self.restart_grace_s)
        return self.engine.submit(prompt, deadline_s=deadline_s,
                                  on_token=on_token, params=params)

    def cancel(self, req: Request) -> bool:
        return self.engine.cancel(req)

    def warmup(self) -> dict:
        return self.engine.warmup()

    def start(self):
        with self._lock:
            self._started = True
        self.engine.start()
        return self

    def stop(self, abort: bool = False,
             drain_timeout_s: Optional[float] = 30.0):
        with self._lock:
            self._started = False
        self.engine.stop(abort=abort, drain_timeout_s=drain_timeout_s)

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        return self.engine.drain(timeout_s=timeout_s)

    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        """Synchronous drive, restart-aware: keeps stepping the CURRENT
        engine until queue and slots are empty — across warm restarts
        (where ``engine`` is swapped under it) and through the restart
        window itself."""
        n = 0
        deadline = time.perf_counter() + self.restart_grace_s
        while n < max_steps:
            self._engine_ready.wait(self.restart_grace_s)
            eng = self.engine
            if eng.crashed is not None:
                if self.broken or time.perf_counter() > deadline:
                    break
                time.sleep(0.002)
                continue
            if not (eng.scheduler.depth or eng.busy_slots()):
                break
            deadline = time.perf_counter() + self.restart_grace_s
            try:
                if not eng.step():
                    time.sleep(0.001)
            except Exception as e:  # noqa: BLE001 — mirror _serve_loop:
                # the crash path captures survivors + kicks the restart
                eng._on_loop_crash(e)
            n += 1
        return n

    # -- introspection -------------------------------------------------------
    @property
    def restarts(self) -> int:
        with self._lock:
            return self._restarts

    @property
    def restarting(self) -> bool:
        with self._lock:
            return self._restarting

    @property
    def broken(self) -> bool:
        with self._lock:
            return self._broken

    @property
    def quarantined(self) -> list:
        """Blacklisted fingerprints (sorted) — the ``/stats`` block the
        router merges fleet-wide on its load-refresh cadence."""
        with self._lock:
            return sorted(self._quarantined)

    def is_quarantined(self, fingerprint: str) -> bool:
        with self._lock:
            return fingerprint in self._quarantined

    def supervisor_stats(self) -> dict:
        with self._lock:
            return {
                "crashes": self._crashes,
                "restarts": self._restarts,
                "restarting": self._restarting,
                "broken": self._broken,
                "max_restarts": self.max_restarts,
                "restart_window_s": self.restart_window_s,
                "restarts_in_window": len(self._restart_ts),
                "last_restart_s": (round(self._last_restart_s, 3)
                                   if self._last_restart_s is not None
                                   else None),
                "quarantine_crashes": self.quarantine_crashes,
                "quarantined": sorted(self._quarantined),
                "quarantine": [dict(v) for v in
                               self._quarantined.values()],
                "implicated": dict(self._implicated),
            }

    def health(self) -> tuple:
        """The engine's ``/healthz`` surface plus the supervisor block.
        During a warm restart the payload reports ``restarting`` (503:
        route elsewhere, probes may back off but the replica is coming
        back); a tripped breaker reports the engine's own ``crashed``
        with ``restarts_exhausted`` so the router ejects it for good."""
        with self._lock:
            restarting, broken = self._restarting, self._broken
        if restarting:
            return 503, {"ts": time.time(), "status": "restarting",
                         "supervisor": self.supervisor_stats()}
        code, payload = self.engine.health()
        payload["supervisor"] = self.supervisor_stats()
        if broken:
            payload["restarts_exhausted"] = True
        return code, payload

    def stats(self) -> dict:
        out = self.engine.stats()
        out["supervisor"] = self.supervisor_stats()
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def __getattr__(self, name):
        # everything else (scheduler, config, device, warmed_up,
        # debug_requests, run_until_idle-adjacent state...) delegates
        # to the CURRENT engine, so the supervisor drops in anywhere a
        # ServingEngine goes
        if name.startswith("_") or name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)
