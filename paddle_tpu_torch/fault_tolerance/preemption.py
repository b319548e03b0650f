"""Preemption handling (counterpart of
``paddle_tpu/fault_tolerance/preemption.py``): turn SIGTERM/SIGINT into
a cooperative "finish what is in flight, then stop" request.

A machine that is about to be taken away gets a SIGTERM with a grace
window. The signal handler only flips a flag, takes a flight-recorder
dump and notifies the registered listeners; the work that must finish
(a serving fleet's drain) runs off the signal-handler thread.

The handler is process-global (signals are), idempotent to install,
and restores the previous handlers on uninstall. A second SIGINT
falls through to the previous handler (double ctrl-C still kills an
interactive run). Tests drive it with ``request()``: no real signal
needed.
"""

from __future__ import annotations

import signal
import threading
import warnings
from typing import Optional, Tuple

from . import metrics as _fm

__all__ = ["PreemptionHandler", "install_preemption_handler",
           "uninstall_preemption_handler", "preemption_requested",
           "clear_preemption", "request_preemption",
           "add_preemption_listener", "remove_preemption_listener"]


def _flight_dump(reason: str):
    """Snapshot the tracing flight recorder on preemption: the grace
    window is the last chance to capture what the serving engine /
    training loop was doing. The write is small (last-N events + state
    providers) and must never turn a graceful preemption into a crash."""
    try:
        from ..observability import tracing

        tracing.flight_dump(reason)
    except Exception:  # noqa: BLE001 — never block the shutdown path
        pass


class PreemptionHandler:
    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._prev = {}
        self._installed = False
        self.last_signal: Optional[int] = None
        # listeners: fn(reason_str) fired when preemption is requested
        # (signal or programmatic). How the serving router turns SIGTERM
        # into a graceful drain instead of a fail-all crash. Each runs
        # try/except — a listener must never break the shutdown path,
        # and anything slow must hop off the signal-handler thread.
        self._listeners: list = []

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            warnings.warn("PreemptionHandler.install: not on the main "
                          "thread; signal handlers not installed "
                          "(request()/polling still works)")
            return self
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except (ValueError, OSError):  # non-main interpreter, etc.
                pass
        self._installed = True
        return self

    def uninstall(self):
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._installed = False

    def _on_signal(self, signum, frame):
        if signum == signal.SIGINT and self._event.is_set():
            # second ctrl-C: defer to the previous handler (usually
            # KeyboardInterrupt) so an interactive run stays killable
            prev = self._prev.get(signum)
            if callable(prev):
                return prev(signum, frame)
            raise KeyboardInterrupt
        self.last_signal = signum
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        _fm.preemptions_total.labels(name).inc()
        self._event.set()
        _flight_dump(f"signal_{name}")
        self._notify(f"signal_{name}")

    def _notify(self, reason: str):
        for fn in list(self._listeners):
            try:
                fn(reason)
            except Exception:  # noqa: BLE001 — never break the shutdown path
                pass

    def add_listener(self, fn):
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn):
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    # cooperative surface ----------------------------------------------------
    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self):
        """Programmatic preemption (tests / external orchestrators)."""
        _fm.preemptions_total.labels("manual").inc()
        self._event.set()
        _flight_dump("preemption_requested")
        self._notify("manual")

    def clear(self):
        self._event.clear()
        self.last_signal = None


_handler: Optional[PreemptionHandler] = None
_lock = threading.Lock()


def _ensure_handler(signals=(signal.SIGTERM, signal.SIGINT)
                    ) -> PreemptionHandler:
    global _handler
    with _lock:
        if _handler is None:
            _handler = PreemptionHandler(signals)
        return _handler


def install_preemption_handler(signals=(signal.SIGTERM, signal.SIGINT)
                               ) -> PreemptionHandler:
    """Install (or return) the process-global handler."""
    return _ensure_handler(signals).install()


def uninstall_preemption_handler():
    global _handler
    with _lock:
        if _handler is not None:
            _handler.uninstall()


def preemption_requested() -> bool:
    h = _handler
    return h.requested if h is not None else False


def request_preemption():
    """Flag a preemption without a real signal (tests/orchestrators)."""
    _ensure_handler().request()


def clear_preemption():
    h = _handler
    if h is not None:
        h.clear()


def add_preemption_listener(fn):
    """Register ``fn(reason)`` to fire when preemption is requested
    (SIGTERM/SIGINT or programmatic) — the hook the serving router's
    graceful drain rides. Installs nothing by itself; pair with
    ``install_preemption_handler()`` for real signals."""
    _ensure_handler().add_listener(fn)


def remove_preemption_listener(fn):
    h = _handler
    if h is not None:
        h.remove_listener(fn)
