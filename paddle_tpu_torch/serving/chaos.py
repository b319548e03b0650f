"""Deterministic, seedable fault injection for the serving engine
(counterpart of ``ChaosEngine`` in ``paddle_tpu/serving/chaos.py``).

``ChaosEngine`` wraps a live ``ServingEngine``'s ``step`` (an instance
attribute: the class is untouched) to kill, slow or hang the decode
loop mid-flight. A crash escapes ``step()`` into the engine's real
``_serve_loop`` crash path: the flight recorder dumps, every in-flight
request fails with the injected error, ``health()`` reads ``crashed``.
A hang wedges the loop thread while ``health()`` stays readable and
reads ``stalled`` after ``stall_timeout_s``. The faults are host-side
Python only: none touches the device, so the CUDA context survives an
injected crash.

Faults fire on CALL COUNTS, not wall clocks, so a chaos run replays
identically; the only randomness is the opt-in Bernoulli storm, driven
by a private ``random.Random(seed)``. The injector counts everything it
injected (``injected``), so a test asserts the fault fired.

The poison-request fault, ``ChaosReplica`` and ``SupervisedChaos`` of
the JAX module come with the supervisor and the router.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

__all__ = ["ChaosError", "ChaosEngine"]


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
        self.injected = {"crash": 0, "slow": 0, "hang": 0}
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
