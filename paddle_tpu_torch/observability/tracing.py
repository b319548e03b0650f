"""Request-lifecycle tracing: low-overhead spans/instants, a bounded
flight-recorder ring, and streaming latency digests (counterpart of
``paddle_tpu/observability/tracing.py``: the same event schema, ring,
context and exports).

The metrics registry answers "what is the runtime doing over time";
this module answers "what happened to THIS request". The serving engine
threads spans through the whole request lifecycle (queued -> admitted
-> prefill chunks -> decode -> terminal) and times its own iterations
(``serving.step``, ``serving.spec_draft``, ``serving.spec_verify`` on
the ``engine`` lane).

Hot-path contract: recording a span or instant NEVER takes a lock and
never touches the device. It is one ``perf_counter_ns`` read (or zero,
when the caller already holds the timestamps) plus a ``deque.append``
into a per-thread buffer. Per-thread buffers self-compact into the
global bounded ring every ``_COMPACT_AT`` events (one amortized lock),
and readers (exporters, the flight recorder) drain them under the same
lock. Tracing is DEFAULT-ON; ``PADDLE_TPU_TRACING=0`` (or
``disable_tracing()``) reduces every site to a single list-index check.
``PADDLE_TPU_TRACE_RING`` sizes the ring (16384 events).

Event schema (what ``events()`` returns and the JSONL export writes,
one JSON object per line):

- ``ph``:     ``"X"`` (complete span) or ``"i"`` (instant event)
- ``name``:   span/event name (``queued``, ``prefill_chunk``, ...)
- ``cat``:    category (``request``, ``engine``)
- ``trace``:  trace id — the serving request id for request-lifecycle
              events (or a propagated ``<trace>-<parent>`` id), ``"engine"``
              for pool-wide engine events, or null for unattributed
              events
- ``tid``:    OS thread ident of the recording thread
- ``ts_ns``:  monotonic start time (``time.perf_counter_ns`` — the
              same clock the Request timestamps use)
- ``dur_ns``: span duration (0 for instants)
- ``args``:   optional dict of small JSON-ready values

``chrome_trace()`` renders the same events as Chrome-trace (catapult)
JSON — one synthetic thread lane per trace id, so loading ``/trace``
in chrome://tracing or Perfetto shows each request as its own swimlane
with nested spans.

The **flight recorder** is the ring itself: ``flight_dump(reason)``
writes the last-N events plus every registered state provider's
snapshot (the serving engine registers ``engine.stats()``, which
carries the block-pool accounting) to one JSON file. It is wired to
the engine crash path and to ``PoolExhaustedError`` escaping the step
loop — the post-mortem for "what was the engine doing when it died".
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from . import metrics as _m

__all__ = [
    "tracing_enabled", "enable_tracing", "disable_tracing",
    "span", "begin_span", "end_span", "instant", "complete",
    "trace_context", "current_trace",
    "events", "clear", "chrome_trace", "export_chrome_trace",
    "export_jsonl", "span_counts", "summary",
    "Digest",
    "flight_dump", "last_flight_dump", "register_state_provider",
    "unregister_state_provider", "state_snapshot",
]

logger = logging.getLogger("paddle_tpu_torch.observability")

# Kill switch (single list-index check per site, like metrics._ENABLED;
# observability.disable() gates this too — both flags must be up).
_TRACING = [os.environ.get("PADDLE_TPU_TRACING", "1") != "0"]

# Per-thread buffers self-compact into the ring at this length.
_COMPACT_AT = 512

# The bounded flight-recorder ring: most recent events, process-wide.
_RING_CAPACITY = int(os.environ.get("PADDLE_TPU_TRACE_RING", "16384"))

_lock = threading.Lock()
_ring: deque = deque(maxlen=_RING_CAPACITY)
_tls = threading.local()
# [(weakref-to-thread, buffer)] — registered once per thread (under
# _lock); pruned when the thread is gone and its buffer drained.
_buffers: List[tuple] = []
# total events ever recorded per (ph, name) — survives ring eviction,
# feeds the CI trace summary (span counts per phase)
_counts: Dict[str, int] = {}

_events_total = _m.counter(
    "paddle_tpu_trace_events_total",
    "trace events recorded (spans + instants), by category", ("cat",))
_flight_dumps = _m.counter(
    "paddle_tpu_flight_dumps_total",
    "flight-recorder dumps written, by trigger reason", ("reason",))

_last_dump_path: List[Optional[str]] = [None]


def tracing_enabled() -> bool:
    return _TRACING[0] and _m._ENABLED[0]


def enable_tracing():
    _TRACING[0] = True


def disable_tracing():
    """Reduce every tracing site to one list-index check."""
    _TRACING[0] = False


# ---------------------------------------------------------------------------
# recording (the lock-free hot path)
# ---------------------------------------------------------------------------


def _buf() -> deque:
    b = getattr(_tls, "buf", None)
    if b is None:
        b = _tls.buf = deque()
        t = threading.current_thread()
        with _lock:
            _buffers.append((weakref.ref(t), b))
    return b


def _record(ph: str, name: str, cat: str, trace, tid: int, ts_ns: int,
            dur_ns: int, args):
    b = _buf()
    b.append((ph, name, cat, trace, tid, ts_ns, dur_ns, args))
    if len(b) >= _COMPACT_AT:
        _flush_locked()


def _flush_locked():
    """Drain every thread's buffer into the bounded ring (and the
    per-name totals); prune buffers whose threads are gone."""
    with _lock:
        dead = []
        for i, (tref, b) in enumerate(_buffers):
            while True:
                try:
                    ev = b.popleft()
                except IndexError:
                    break
                _ring.append(ev)
                key = ev[1]
                _counts[key] = _counts.get(key, 0) + 1
                _events_total.labels(ev[2]).inc()
            if tref() is None:
                dead.append(i)
        for i in reversed(dead):
            del _buffers[i]


# ---------------------------------------------------------------------------
# trace-context propagation (thread-local)
# ---------------------------------------------------------------------------


def current_trace():
    """The active trace id on this thread (set by ``trace_context``),
    or None. Compile events and nested spans attribute to it."""
    stack = getattr(_tls, "trace", None)
    return stack[-1] if stack else None


class trace_context:
    """Mark ``trace_id`` as the active trace on this thread for the
    duration of the ``with`` block (re-entrant; innermost wins)."""

    __slots__ = ("trace_id",)

    def __init__(self, trace_id):
        self.trace_id = trace_id

    def __enter__(self):
        stack = getattr(_tls, "trace", None)
        if stack is None:
            stack = _tls.trace = []
        stack.append(self.trace_id)
        return self

    def __exit__(self, *exc):
        _tls.trace.pop()
        return False


# ---------------------------------------------------------------------------
# spans + instants
# ---------------------------------------------------------------------------


class _Span:
    """An open span handle: begun on one call site (possibly one
    thread), ended on another — how the cross-iteration lifecycle spans
    (``queued``, ``decode``) are recorded."""

    __slots__ = ("name", "cat", "trace", "tid", "t0", "args", "_open")

    def __init__(self, name, cat, trace, tid, t0, args):
        self.name = name
        self.cat = cat
        self.trace = trace
        self.tid = tid
        self.t0 = t0
        self.args = args
        self._open = True


def begin_span(name: str, cat: str = "", trace=None, args=None,
               ts_ns: Optional[int] = None) -> Optional[_Span]:
    """Open a span; returns a handle for ``end_span`` (None when
    tracing is off — ``end_span(None)`` is a no-op, so call sites need
    no guards)."""
    if not tracing_enabled():
        return None
    if trace is None:
        trace = current_trace()
    return _Span(name, cat, trace, threading.get_ident(),
                 ts_ns if ts_ns is not None else time.perf_counter_ns(),
                 args)


def end_span(sp: Optional[_Span], ts_ns: Optional[int] = None, args=None):
    """Close an open span and record it as one complete event (idempotent
    — a span already ended, e.g. by ``Request.finish``, is skipped)."""
    if sp is None or not sp._open:
        return
    sp._open = False
    if not tracing_enabled():
        return
    t1 = ts_ns if ts_ns is not None else time.perf_counter_ns()
    a = sp.args
    if args:
        a = {**(a or {}), **args}
    _record("X", sp.name, sp.cat, sp.trace, sp.tid, sp.t0,
            max(t1 - sp.t0, 0), a)


class span:
    """Lexical span context manager::

        with tracing.span("generation.prefill", cat="generation"):
            ...
    """

    __slots__ = ("_sp", "name", "cat", "trace", "args")

    def __init__(self, name: str, cat: str = "", trace=None, args=None):
        self.name = name
        self.cat = cat
        self.trace = trace
        self.args = args
        self._sp = None

    def __enter__(self):
        self._sp = begin_span(self.name, self.cat, self.trace, self.args)
        return self._sp

    def __exit__(self, *exc):
        end_span(self._sp)
        return False


def instant(name: str, cat: str = "", trace=None, args=None,
            ts_ns: Optional[int] = None):
    """Record a zero-duration event (prefix-cache hit, COW fork,
    preemption, completion...)."""
    if not tracing_enabled():
        return
    if trace is None:
        trace = current_trace()
    _record("i", name, cat, trace, threading.get_ident(),
            ts_ns if ts_ns is not None else time.perf_counter_ns(), 0, args)


def complete(name: str, cat: str, trace, ts_ns: int, dur_ns: int, args=None):
    """Record an already-measured span from existing timestamps — zero
    extra clock reads (the engine's step loop already timed itself)."""
    if not tracing_enabled():
        return
    _record("X", name, cat, trace, threading.get_ident(), ts_ns,
            max(dur_ns, 0), args)


# ---------------------------------------------------------------------------
# reading + export
# ---------------------------------------------------------------------------


def _to_dict(ev: tuple) -> dict:
    ph, name, cat, trace, tid, ts, dur, args = ev
    out = {"ph": ph, "name": name, "cat": cat, "trace": trace, "tid": tid,
           "ts_ns": ts, "dur_ns": dur}
    if args:
        out["args"] = args
    return out


def events(trace=None, name: Optional[str] = None) -> List[dict]:
    """All buffered events (ring + live thread buffers), oldest first;
    optionally filtered to one trace id and/or one event name."""
    _flush_locked()
    with _lock:
        evs = list(_ring)
    if trace is not None:
        evs = [e for e in evs if e[3] == trace]
    if name is not None:
        evs = [e for e in evs if e[1] == name]
    evs.sort(key=lambda e: e[5])
    return [_to_dict(e) for e in evs]


def clear():
    """Drop every buffered event + the per-name totals (tests)."""
    _flush_locked()
    with _lock:
        _ring.clear()
        _counts.clear()


def span_counts() -> Dict[str, int]:
    """Total events ever recorded per name — NOT bounded by the ring,
    so CI span-count summaries survive long runs."""
    _flush_locked()
    with _lock:
        return dict(_counts)


def summary() -> dict:
    """JSON-ready tracing summary for ``observability.snapshot()``."""
    counts = span_counts()
    with _lock:
        buffered = len(_ring)
    return {
        "enabled": tracing_enabled(),
        "ring_capacity": _RING_CAPACITY,
        "events_buffered": buffered,
        "events_recorded": sum(counts.values()),
        "span_counts": counts,
        "last_flight_dump": _last_dump_path[0],
    }


def chrome_trace(trace=None) -> dict:
    """Render buffered events as Chrome-trace (catapult) JSON: one
    synthetic thread lane per trace id (``request <id>`` /
    ``engine`` / ``untraced``), spans as ``"X"`` complete events in
    microseconds, instants as thread-scoped ``"i"`` events. Loadable in
    chrome://tracing and Perfetto."""
    evs = events(trace)
    pid = os.getpid()
    lanes: Dict[Any, int] = {}
    out = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "paddle_tpu trace"}}]

    def lane(tr) -> int:
        if tr not in lanes:
            lanes[tr] = len(lanes)
            if tr is None:
                lname = "untraced"
            elif isinstance(tr, int):
                lname = f"request {tr}"
            else:
                lname = str(tr)
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": lanes[tr], "args": {"name": lname}})
        return lanes[tr]

    for e in evs:
        rec = {"name": e["name"], "cat": e["cat"] or "event", "ph": e["ph"],
               "pid": pid, "tid": lane(e["trace"]),
               "ts": e["ts_ns"] / 1000.0}
        if e["ph"] == "X":
            rec["dur"] = e["dur_ns"] / 1000.0
        else:
            rec["s"] = "t"
        if "args" in e:
            rec["args"] = e["args"]
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str, trace=None) -> str:
    """Write ``chrome_trace()`` JSON to ``path`` (relative paths land
    in the ``PADDLE_TPU_SINK_DIR`` override, like every other sink)."""
    from .exporters import resolve_sink_path

    path = resolve_sink_path(path)
    with open(path, "w") as fh:
        json.dump(chrome_trace(trace), fh)
    return path


def export_jsonl(path: str, trace=None, max_bytes: int = 64 << 20) -> str:
    """Append every buffered event as one JSON line each, through the
    size-rotating sink (``max_bytes``, keep-1)."""
    from .exporters import RotatingJsonlSink

    sink = RotatingJsonlSink(path, max_bytes=max_bytes)
    try:
        for e in events(trace):
            sink.write(e)
    finally:
        sink.close()
    return sink.path


# ---------------------------------------------------------------------------
# streaming percentile digests
# ---------------------------------------------------------------------------


class Digest:
    """Streaming p50/p95/p99: a bounded ring of the most recent
    ``window`` samples (``deque.append`` — the lock-free writer path)
    with exact percentiles computed over the window at read time.
    Within the window this is EXACTLY ``numpy.percentile`` (method
    'linear'); beyond it, a sliding-window quantile — the operational
    behavior a latency dashboard wants anyway (old traffic ages out)."""

    __slots__ = ("_q", "count", "sum")

    def __init__(self, window: int = 4096):
        self._q: deque = deque(maxlen=int(window))
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float):
        self._q.append(value)
        self.count += 1
        self.sum += value

    def quantile(self, q: float) -> Optional[float]:
        xs = sorted(self._q)
        if not xs:
            return None
        # numpy's default 'linear' interpolation
        pos = q * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    def percentiles(self) -> dict:
        xs = sorted(self._q)

        def at(q):
            if not xs:
                return None
            pos = q * (len(xs) - 1)
            lo = int(pos)
            hi = min(lo + 1, len(xs) - 1)
            return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

        return {"p50": at(0.50), "p95": at(0.95), "p99": at(0.99),
                "count": self.count,
                "mean": (self.sum / self.count) if self.count else None}


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

_providers: Dict[str, Any] = {}
_providers_lock = threading.Lock()


def register_state_provider(name: str, fn):
    """Register a zero-arg callable whose return value (a JSON-ready
    dict, or None to be skipped) is captured in every flight dump and
    in ``state_snapshot()``. The serving engine registers a weakref'd
    ``engine.stats`` here, so dumps carry pool/slot/queue state."""
    with _providers_lock:
        _providers[name] = fn


def unregister_state_provider(name: str):
    with _providers_lock:
        _providers.pop(name, None)


def state_snapshot() -> dict:
    """Every registered provider's current state ({} when none). A
    provider that raises contributes its error instead of killing the
    dump — the flight recorder must never be the second crash."""
    with _providers_lock:
        items = list(_providers.items())
    out = {}
    for name, fn in items:
        try:
            state = fn()
        except Exception as e:  # noqa: BLE001 — dump must survive
            state = {"error": repr(e)}
        if state is not None:
            out[name] = state
    return out


def last_flight_dump() -> Optional[str]:
    return _last_dump_path[0]


def flight_dump(reason: str, extra: Optional[dict] = None,
                path: Optional[str] = None, last_n: int = 4096) -> Optional[str]:
    """Write the flight-recorder dump: the last ``last_n`` buffered
    events + every state provider's snapshot + the tracing summary, as
    one JSON file. Returns the path, or None when the write failed
    (logged — a dump failure must never mask the original crash).

    Triggers wired in-tree: serving-engine loop crash and
    ``PoolExhaustedError`` escaping ``ServingEngine.step()``."""
    try:
        from .exporters import SINK_DIR_ENV, resolve_sink_path

        if path is None:
            name = (f"flight_{reason}_{os.getpid()}_"
                    f"{int(time.time() * 1000)}.json")
            if os.environ.get(SINK_DIR_ENV):
                path = resolve_sink_path(name)
            else:
                # never litter the cwd: unconfigured dumps go to tmp
                # (the warning log below carries the path)
                import tempfile

                path = os.path.join(tempfile.gettempdir(), name)
        else:
            path = resolve_sink_path(path)
        rec = {
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "tracing": summary(),
            "events": events()[-int(last_n):],
            "state": state_snapshot(),
        }
        if extra:
            rec["extra"] = extra
        with open(path, "w") as fh:
            json.dump(rec, fh)
        _flight_dumps.labels(reason).inc()
        _last_dump_path[0] = path
        logger.warning("flight recorder dump (%s) -> %s", reason, path)
        return path
    except Exception:  # noqa: BLE001
        logger.exception("flight recorder dump failed (reason=%s)", reason)
        return None
