"""Deterministic, seedable fault injection for the serving stack
(counterpart of ``paddle_tpu/serving/chaos.py``).

Faults fire on CALL COUNTS, not wall clocks, so a chaos run replays
identically; the only randomness is the opt-in Bernoulli storm, driven
by a private ``random.Random(seed)``. Two injection points, matching
the two surfaces a router touches:

- ``ChaosEngine`` wraps a live ``ServingEngine``'s ``step`` (an instance
  attribute: the class is untouched) to kill, slow or hang the decode
  loop mid-flight. A crash escapes ``step()`` into the engine's real
  ``_serve_loop`` crash path: the flight recorder dumps, every in-flight
  request fails with the injected error (or a supervisor captures it),
  ``health()`` reads ``crashed``. A hang wedges the loop thread while
  ``health()`` stays readable and reads ``stalled`` after
  ``stall_timeout_s``. Every fault raises or waits BEFORE the wrapped
  step runs, so no kernel of the faulted step was launched, and none
  touches the device: the CUDA context survives an injected crash.
- ``ChaosReplica`` wraps a replica CLIENT (``LocalReplica`` /
  ``HTTPReplica``) to corrupt the router's control plane: ``stats()``
  time-outs, malformed or erroring health probes, and
  ``PoolExhaustedError`` / ``QueueFullError`` submit storms.

Poison requests are injected by REQUEST IDENTITY, not call count:
``poison_fingerprint`` crashes any step in which a request with the
armed fingerprint is running, however often it is admitted and on
whichever engine generation: the deterministic crash that quarantine
exists for. ``SupervisedChaos`` keeps faults armed ACROSS warm restarts
by wrapping each rebuilt engine through the supervisor's rebuild hook,
with one shared ``injected`` ledger.

Every injector counts what it injected (``injected``), so a test
asserts that the fault fired.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from .block_pool import PoolExhaustedError
from .scheduler import QueueFullError

__all__ = ["ChaosError", "ChaosEngine", "ChaosReplica",
           "SupervisedChaos"]


class ChaosError(RuntimeError):
    """Marker for injected faults — assertions can tell a chaos kill
    from a genuine bug."""


class ChaosEngine:
    """Fault injector over one engine's step loop.

    >>> monkey = ChaosEngine(engine).crash_after_steps(5)
    >>> ...            # the 6th step raises ChaosError inside the loop
    >>> monkey.restore()

    Faults are one-shot unless re-armed; step counting starts at
    injection time. ``restore()`` puts the original bound method back
    (a crashed engine stays crashed — that is the point)."""

    def __init__(self, engine, seed: int = 0):
        self.engine = engine
        self.rng = random.Random(seed)
        self._orig_step = engine.step
        self._lock = threading.Lock()
        self._steps_seen = 0
        self._crash_at: Optional[int] = None
        self._crash_msg = "chaos: injected replica crash mid-decode"
        self._crash_p = 0.0
        self._slow_at: Optional[int] = None
        self._slow_for = 0
        self._slow_s = 0.0
        self._hang_at: Optional[int] = None
        self._hang_event = threading.Event()
        self._poison_fp: Optional[str] = None
        self._poison_left: Optional[int] = None
        self._poison_msg = "chaos: poisoned request crashed the step"
        self.injected = {"crash": 0, "slow": 0, "hang": 0, "poison": 0}
        engine.step = self._step

    # -- arming --------------------------------------------------------------
    def crash_after_steps(self, n: int, msg: Optional[str] = None):
        """Raise ``ChaosError`` out of step ``n+1`` (counted from now):
        the decode loop dies mid-flight through the engine's real crash
        path."""
        with self._lock:
            self._crash_at = self._steps_seen + int(n)
            if msg:
                self._crash_msg = msg
        return self

    def crash_storm(self, p: float):
        """Bernoulli(p) crash chance per step (seeded — deterministic
        for a given seed and step sequence)."""
        with self._lock:
            self._crash_p = float(p)
        return self

    def slow_steps(self, delay_s: float, after: int = 0, for_steps: int = 1):
        """Stretch ``for_steps`` steps (starting ``after`` steps from
        now) by ``delay_s`` each — the degraded-but-alive replica."""
        with self._lock:
            self._slow_at = self._steps_seen + int(after)
            self._slow_for = int(for_steps)
            self._slow_s = float(delay_s)
        return self

    def poison_fingerprint(self, fingerprint: str,
                           crashes: Optional[int] = None,
                           msg: Optional[str] = None):
        """Crash every step in which a request with this fingerprint is
        RUNNING — the deterministic poison request. Unlike the count
        faults this one is not one-shot: it re-fires each time the
        request is (re-)admitted, which is the shape quarantine must
        defeat. ``crashes`` bounds the total firings (None =
        unbounded); the quarantine contract says the supervisor stops
        re-admitting the fingerprint before any sane bound is hit."""
        with self._lock:
            self._poison_fp = str(fingerprint)
            self._poison_left = None if crashes is None else int(crashes)
            if msg:
                self._poison_msg = msg
        return self

    def hang_after_steps(self, n: int):
        """Block the loop inside step ``n+1`` until ``release()`` — the
        hung replica: /healthz stays reachable (and eventually reports
        ``stalled``), the loop thread is wedged."""
        with self._lock:
            self._hang_at = self._steps_seen + int(n)
            self._hang_event.clear()
        return self

    def release(self):
        """Un-hang a hung step (the wedge clears; the loop resumes)."""
        self._hang_event.set()
        return self

    def restore(self):
        self.engine.step = self._orig_step
        self._hang_event.set()
        return self

    # -- the wrapped step ----------------------------------------------------
    def _step(self) -> bool:
        with self._lock:
            n = self._steps_seen
            self._steps_seen += 1
            crash = (self._crash_at is not None and n >= self._crash_at) \
                or (self._crash_p > 0.0
                    and self.rng.random() < self._crash_p)
            slow = (self._slow_at is not None and self._slow_at <= n
                    < self._slow_at + self._slow_for)
            hang = self._hang_at is not None and n >= self._hang_at
            poison = False
            if self._poison_fp is not None and \
                    (self._poison_left is None or self._poison_left > 0):
                # identity fault: fires iff the poisoned request is in
                # a slot RIGHT NOW (same thread as the step — the slot
                # table is stable here)
                for r in self.engine._slot_req:
                    if r is not None and r.fingerprint == self._poison_fp:
                        poison = True
                        if self._poison_left is not None:
                            self._poison_left -= 1
                        break
        if poison:
            self.injected["poison"] += 1
            raise ChaosError(self._poison_msg)
        if hang:
            self.injected["hang"] += 1
            with self._lock:
                self._hang_at = None  # one-shot
            self._hang_event.wait()
        if crash:
            self.injected["crash"] += 1
            with self._lock:
                self._crash_at = None
                self._crash_p = 0.0
            raise ChaosError(self._crash_msg)
        if slow:
            self.injected["slow"] += 1
            time.sleep(self._slow_s)
        return self._orig_step()


class ChaosReplica:
    """Control-plane fault injector: wraps a replica client, passing
    everything through except the armed faults. Stackable with
    ``ChaosEngine`` (data plane) on the same replica."""

    def __init__(self, inner, seed: int = 0):
        self.inner = inner
        self.name = getattr(inner, "name", None)
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self._stats_fail = 0       # remaining stats faults
        self._stats_mode = "timeout"
        self._stats_hang_s = 5.0
        self._probe_fail = 0       # remaining healthz faults
        self._probe_mode = "error"
        self._malformed_payload = "IM FINE"  # not a dict: malformed
        self._reject_submits = 0
        self._reject_exc = "pool"
        self.injected = {"stats": 0, "probe": 0, "submit": 0}

    # -- arming --------------------------------------------------------------
    def fail_stats(self, n: int, mode: str = "timeout",
                   hang_s: float = 5.0):
        """Next ``n`` ``stats()`` calls fail: ``"timeout"`` blocks for
        ``hang_s`` (the router's stats timeout must cut it loose),
        ``"error"`` raises."""
        with self._lock:
            self._stats_fail = int(n)
            self._stats_mode = mode
            self._stats_hang_s = float(hang_s)
        return self

    def fail_probes(self, n: int, mode: str = "error", payload=None):
        """Next ``n`` ``healthz()`` calls fail: ``"error"`` raises,
        ``"timeout"`` blocks, ``"malformed"`` returns a non-payload
        (default a bare string — the probe validator must reject it,
        not crash on it)."""
        with self._lock:
            self._probe_fail = int(n)
            self._probe_mode = mode
            if payload is not None:
                self._malformed_payload = payload
        return self

    def reject_submits(self, n: int, exc: str = "pool"):
        """Next ``n`` ``submit()`` calls raise — ``"pool"`` =
        ``PoolExhaustedError`` (the PoolExhausted storm), ``"queue"`` =
        ``QueueFullError`` (backpressure)."""
        with self._lock:
            self._reject_submits = int(n)
            self._reject_exc = exc
        return self

    # -- the wrapped client --------------------------------------------------
    def healthz(self):
        with self._lock:
            fail, mode = self._probe_fail, self._probe_mode
            if fail > 0:
                self._probe_fail -= 1
        if fail > 0:
            self.injected["probe"] += 1
            if mode == "timeout":
                time.sleep(self._stats_hang_s)
                raise TimeoutError("chaos: probe hung")
            if mode == "malformed":
                return self._malformed_payload
            raise ChaosError("chaos: probe endpoint exploded")
        return self.inner.healthz()

    def stats(self):
        with self._lock:
            fail, mode = self._stats_fail, self._stats_mode
            if fail > 0:
                self._stats_fail -= 1
        if fail > 0:
            self.injected["stats"] += 1
            if mode == "timeout":
                time.sleep(self._stats_hang_s)
                raise TimeoutError("chaos: stats hung")
            raise ChaosError("chaos: stats endpoint exploded")
        return self.inner.stats()

    def submit(self, prompt, deadline_s=None, on_token=None, params=None,
               trace_id=None):
        with self._lock:
            fail, exc = self._reject_submits, self._reject_exc
            if fail > 0:
                self._reject_submits -= 1
        if fail > 0:
            self.injected["submit"] += 1
            if exc == "queue":
                raise QueueFullError("chaos: queue full")
            raise PoolExhaustedError("chaos: pool exhausted")
        if trace_id is not None:
            # fleet trace propagation passes through chaos untouched —
            # the merged failover trace is exactly what the chaos
            # suite's crash lanes need to be debuggable
            return self.inner.submit(prompt, deadline_s=deadline_s,
                                     on_token=on_token, params=params,
                                     trace_id=trace_id)
        return self.inner.submit(prompt, deadline_s=deadline_s,
                                 on_token=on_token, params=params)

    def __getattr__(self, name):
        # fleet extensions (metrics_text / trace_events) and any future
        # optional protocol methods delegate to the inner client — and
        # stay ABSENT when the inner client lacks them, so the router's
        # hasattr gating sees the truth through the chaos wrapper
        if name in ("metrics_text", "trace_events"):
            return getattr(self.inner, name)
        raise AttributeError(name)

    def cancel(self, handle):
        return self.inner.cancel(handle)

    def drain(self, timeout_s=None):
        return self.inner.drain(timeout_s)

    def warmup(self):
        return self.inner.warmup()

    def start(self):
        if hasattr(self.inner, "start"):
            self.inner.start()


class SupervisedChaos:
    """Chaos that SURVIVES warm restarts.

    A plain ``ChaosEngine`` dies with its engine: the supervisor's
    rebuild swaps in a fresh ``ServingEngine`` whose ``step`` is
    unwrapped, so any fault armed on the old engine silently stops
    firing — and a poison-quarantine test that silently stops injecting
    proves nothing. This wrapper registers a rebuild hook on the
    supervisor and re-wraps every engine generation with a fresh
    ``ChaosEngine``, re-armed by the caller's ``arm`` closure and
    writing into ONE shared ``injected`` ledger, so the test's "the
    poison fired exactly N times fleet-wide" assertion spans restarts.

    >>> chaos = SupervisedChaos(sup, arm=lambda m:
    ...     m.poison_fingerprint(fp))
    >>> ...  # crash, restart, crash again: chaos.injected["poison"] == 2
    """

    def __init__(self, supervisor, arm=None, seed: int = 0):
        self.supervisor = supervisor
        self.seed = seed
        self._arm = arm
        self.injected = {"crash": 0, "slow": 0, "hang": 0, "poison": 0}
        self.monkeys: list = []
        supervisor.add_rebuild_hook(self._attach)
        self._attach(supervisor.engine)

    def _attach(self, engine):
        m = ChaosEngine(engine, seed=self.seed)
        m.injected = self.injected  # one ledger across generations
        if self._arm is not None:
            self._arm(m)
        self.monkeys.append(m)
        return m

    @property
    def current(self) -> ChaosEngine:
        """The monkey on the supervisor's CURRENT engine generation."""
        return self.monkeys[-1]

    def restore(self):
        for m in self.monkeys:
            m.restore()
        return self
