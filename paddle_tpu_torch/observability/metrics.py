"""Thread-safe metrics registry: Counter / Gauge / Histogram / Summary
with labels (counterpart of ``paddle_tpu/observability/metrics.py``,
the same classes, names and exposition).

The *metrics* half of the port's observability stack (the tracing half
is ``tracing.py``): the Prometheus-shaped surface the serving engine,
its HTTP front end and a scraper read.

Hot-path contract: incrementing a counter or observing a histogram
sample NEVER takes a lock. Writers append the delta/sample to a
``collections.deque`` — ``deque.append`` is GIL-atomic, so concurrent increments are exact —
and readers (exporters, ``snapshot()``) fold the queue into the base
value under the metric's lock. When no exporter ever reads, a bounded
compaction (every ``_COMPACT_AT`` writes, amortized lock-free) keeps
memory flat. Instrumentation sites additionally guard on the module
flag ``_ENABLED[0]`` so the whole subsystem can be switched off to a
single list-index check per site.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Summary", "MetricsRegistry",
    "get_registry", "counter", "gauge", "histogram", "summary",
    "DEFAULT_BUCKETS", "DEFAULT_QUANTILES",
]

# Zero-cost kill switch shared with the instrumentation sites (the
# tracer and the serving engine): `if _ENABLED[0]:` is the whole cost
# when observability is disabled.
_ENABLED = [True]

# Writers self-compact once their pending queue reaches this length, so
# an unscraped process stays bounded: one (rare) lock every N writes.
_COMPACT_AT = 4096

# Prometheus-style duration buckets (seconds), the JAX package's: from
# sub-ms spans to multi-second builds.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

# Summary quantiles: the serving-latency trio (median + the two tails
# a latency SLO is written against).
DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


class _CounterChild:
    __slots__ = ("_q", "_base", "_lock")

    # the pending deque is lock-free BY DESIGN (GIL-atomic appends);
    # only the folded base value needs the metric lock
    GUARDED_BY = {"_base": "_lock"}

    def __init__(self, lock: threading.Lock):
        self._q: deque = deque()
        self._base = 0.0
        self._lock = lock

    def inc(self, amount: float = 1.0):
        """Lock-free: one deque append (+ an int compare)."""
        self._q.append(amount)
        if len(self._q) >= _COMPACT_AT:
            self._compact()

    def _compact(self) -> float:
        with self._lock:
            q = self._q
            total = self._base
            while True:
                try:
                    total += q.popleft()
                except IndexError:
                    break
            self._base = total
            return total

    def value(self) -> float:
        return self._compact()


class _GaugeChild:
    """Gauges are read-side instruments (memory watermarks, ips) set at
    step granularity — ``set`` is a single atomic attribute store;
    inc/dec (rare) serialize on the metric lock."""

    __slots__ = ("_v", "_lock")

    GUARDED_BY = {"_v": "_lock"}

    def __init__(self, lock: threading.Lock):
        self._v = 0.0
        self._lock = lock

    def set(self, value: float):
        # the lock-free gauge write: one GIL-atomic attribute store,
        # no read-modify-write to tear
        self._v = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._v += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def value(self) -> float:
        # GIL-atomic read of a float attribute; gauge readers tolerate
        # a stale value
        return self._v


class _HistogramChild:
    """``observe`` appends the raw sample (lock-free); bucketing happens
    at read/compaction time under the metric lock."""

    __slots__ = ("_q", "_counts", "_sum", "_count", "_buckets", "_lock")

    GUARDED_BY = {"_counts": "_lock", "_sum": "_lock", "_count": "_lock"}

    def __init__(self, lock: threading.Lock, buckets: Sequence[float]):
        self._q: deque = deque()
        self._buckets = tuple(buckets)
        self._counts = [0] * (len(self._buckets) + 1)  # +1: +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = lock

    def observe(self, value: float):
        self._q.append(value)
        if len(self._q) >= _COMPACT_AT:
            self._compact()

    def _compact(self):
        with self._lock:
            q = self._q
            while True:
                try:
                    v = q.popleft()
                except IndexError:
                    break
                self._counts[bisect_left(self._buckets, v)] += 1
                self._sum += v
                self._count += 1
            return list(self._counts), self._sum, self._count

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts (non-cumulative, +Inf last), sum, count)."""
        return self._compact()

    def value(self) -> float:
        """Histogram "value" for generic readers: the running sum."""
        return self._compact()[1]


class _SummaryChild:
    """Streaming quantiles: a bounded ring of the most recent samples
    (``deque(maxlen)`` append — lock-free) with exact percentiles over
    the window computed at collect time. Same design as
    ``tracing.Digest``; kept separate so this module stays import-leaf."""

    __slots__ = ("_q", "_sum", "_count", "_quantiles", "_lock")

    GUARDED_BY = {"_sum": "_lock", "_count": "_lock"}

    def __init__(self, lock: threading.Lock, quantiles: Sequence[float],
                 window: int):
        self._q: deque = deque(maxlen=int(window))
        self._quantiles = tuple(quantiles)
        self._sum = 0.0
        self._count = 0
        self._lock = lock

    def observe(self, value: float):
        self._q.append(value)
        # count/sum are stats, not invariants: racing += may rarely drop
        # one under threads (the serving writers are single-threaded); a
        # dropped increment is an accepted stats-only error
        self._count += 1
        self._sum += value

    def snapshot(self) -> Tuple[Dict[float, Optional[float]], float, int]:
        xs = sorted(self._q)

        def at(q):
            if not xs:
                return None
            pos = q * (len(xs) - 1)
            lo = int(pos)
            hi = min(lo + 1, len(xs) - 1)
            return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

        # reader of the racy-by-design stats pair (see observe)
        return ({q: at(q) for q in self._quantiles}, self._sum, self._count)

    def quantile(self, q: float) -> Optional[float]:
        xs = sorted(self._q)
        if not xs:
            return None
        pos = q * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    def value(self) -> float:
        # the same racy-by-design stats reader as snapshot
        return self._sum


_CHILD_TYPES = {"counter": _CounterChild, "gauge": _GaugeChild,
                "histogram": _HistogramChild, "summary": _SummaryChild}


class _MetricBase:
    kind = "untyped"

    GUARDED_BY = {"_children": "_lock"}

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (), **kwargs):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._kwargs = kwargs
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        self._default = None if self.labelnames else self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally or by "
                                 "name, not both")
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{values}")
        # double-checked fast path: dict.get is GIL-atomic and the
        # locked re-check below makes child creation race-free
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    child = self._make_child()
                    self._children[values] = child
        return child

    def _all_children(self) -> List[Tuple[Tuple[str, ...], object]]:
        if self._default is not None:
            return [((), self._default)]
        with self._lock:
            return list(self._children.items())

    # unlabeled convenience: metric acts as its own single child
    def _d(self):
        if self._default is None:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call "
                f".labels(...) first")
        return self._default

    def collect(self) -> List[dict]:
        """Samples for exporters: [{labels: {...}, ...per-kind fields}]."""
        out = []
        for lv, child in self._all_children():
            labels = dict(zip(self.labelnames, lv))
            if isinstance(child, _HistogramChild):
                counts, s, c = child.snapshot()
                out.append({"labels": labels, "buckets": list(self.buckets),
                            "counts": counts, "sum": s, "count": c})
            elif isinstance(child, _SummaryChild):
                quantiles, s, c = child.snapshot()
                out.append({"labels": labels,
                            "quantiles": {str(q): v
                                          for q, v in quantiles.items()},
                            "sum": s, "count": c})
            else:
                out.append({"labels": labels, "value": child.value()})
        return out


class Counter(_MetricBase):
    kind = "counter"

    def _make_child(self):
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0):
        self._d().inc(amount)

    def value(self) -> float:
        return self._d().value()


class Gauge(_MetricBase):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild(self._lock)

    def set(self, value: float):
        self._d().set(value)

    def inc(self, amount: float = 1.0):
        self._d().inc(amount)

    def dec(self, amount: float = 1.0):
        self._d().dec(amount)

    def value(self) -> float:
        return self._d().value()


class Histogram(_MetricBase):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self._lock, self.buckets)

    def observe(self, value: float):
        self._d().observe(value)

    def value(self) -> float:
        return self._d().value()


class Summary(_MetricBase):
    """Prometheus summary: streaming quantiles over a sliding sample
    window plus ``_sum``/``_count`` series. The serving latency digests
    (TTFT, TPOT, queue wait, prefill-chunk) are Summaries — tails
    (p95/p99) that a fixed histogram bucketing would quantize away."""

    kind = "summary"

    def __init__(self, name, help="", labelnames=(),
                 quantiles: Sequence[float] = DEFAULT_QUANTILES,
                 window: int = 4096):
        self.quantiles = tuple(sorted(quantiles))
        self.window = int(window)
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _SummaryChild(self._lock, self.quantiles, self.window)

    def observe(self, value: float):
        self._d().observe(value)

    def quantile(self, q: float) -> Optional[float]:
        return self._d().quantile(q)

    def value(self) -> float:
        return self._d().value()


class MetricsRegistry:
    """Name -> metric map; creation is idempotent (same name + kind
    returns the existing metric, so instrumentation sites can declare
    their metrics without import-order coupling)."""

    GUARDED_BY = {"_metrics": "_lock"}

    def __init__(self):
        self._metrics: Dict[str, _MetricBase] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        # double-checked fast path (same discipline as labels());
        # creation re-checks under the lock below
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} with "
                    f"labels {m.labelnames}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def summary(self, name, help="", labelnames=(),
                quantiles=DEFAULT_QUANTILES, window: int = 4096) -> Summary:
        return self._get_or_create(Summary, name, help, labelnames,
                                   quantiles=quantiles, window=window)

    def get(self, name) -> Optional[_MetricBase]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_MetricBase]:
        with self._lock:
            return list(self._metrics.values())

    def collect(self) -> Dict[str, dict]:
        """Full registry state: {name: {type, help, samples}}."""
        out = {}
        for m in self.metrics():
            out[m.name] = {"type": m.kind, "help": m.help,
                           "samples": m.collect()}
        return out

    def reset(self):
        """Drop all metrics (tests / fork-exec re-init)."""
        with self._lock:
            self._metrics.clear()


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def counter(name, help="", labelnames=()) -> Counter:
    return _registry.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return _registry.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=DEFAULT_BUCKETS) -> Histogram:
    return _registry.histogram(name, help, labelnames, buckets=buckets)


def summary(name, help="", labelnames=(), quantiles=DEFAULT_QUANTILES,
            window: int = 4096) -> Summary:
    return _registry.summary(name, help, labelnames, quantiles=quantiles,
                             window=window)
