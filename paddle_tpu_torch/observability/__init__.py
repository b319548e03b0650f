"""paddle_tpu_torch.observability — the port's metrics and tracing
(counterpart of ``paddle_tpu/observability``, its host-side half).

Layout:
- ``metrics``:    thread-safe Counter/Gauge/Histogram/Summary registry
                  (lock-free writer hot path — a deque append, no lock
                  per op; Summary = streaming p50/p95/p99 over a
                  sliding sample window).
- ``exporters``:  Prometheus text exposition, JSONL snapshots, the
                  size-rotating JSONL sink (``RotatingJsonlSink``,
                  ``$PADDLE_TPU_SINK_DIR`` override), opt-in stdlib
                  http scrape endpoint (``start_http_server``).
- ``tracing``:    request-lifecycle spans/instants (default-on,
                  host-side only: no event reads a device tensor),
                  Chrome-trace + JSONL export, the flight-recorder ring
                  + crash dumps, streaming latency ``Digest``s.
- ``fleet``:      the fleet plane a router reads: traceparent
                  propagation, the catapult merge, metric federation
                  (``FleetMetricsAggregator``), multi-window SLO burn
                  rates (``SLOTracker``), the brownout ladder and the
                  robust straggler z-score (``mad_zscores``).

The JAX package's ``recompile``, ``telemetry`` and ``perf`` modules
(XLA compile attribution, per-step telemetry, the cost/roofline ledger)
have no counterpart yet, so ``snapshot()`` has no ``compile_events``,
``entries``, ``steps`` or ``perf`` sections.

Trace event schema: see ``tracing``. ``chrome_trace()`` renders the
events as catapult JSON (one swimlane per trace id; spans nest within
the per-request ``request`` root span). ``GET /trace`` on the serving
HTTP server serves it live.

``disable()`` reduces every instrumentation site — metrics AND tracing
— to a single list-index check.
"""

from __future__ import annotations

import time

from . import exporters, fleet, metrics, tracing
from .exporters import (RotatingJsonlSink, parse_prometheus_text,
                        prometheus_text, render_families, resolve_sink_path,
                        start_http_server, stop_http_server,
                        write_jsonl_snapshot)
from .fleet import (BROWNOUT_LEVELS, FLEET_REPLICA_LABEL, TRACEPARENT_HEADER,
                    BrownoutController, FleetMetricsAggregator, SLOConfig,
                    SLOTracker, attempt_trace_id, format_traceparent,
                    mad_zscores, merge_catapult, parse_traceparent,
                    traceparent_of)
from .metrics import (_ENABLED, DEFAULT_BUCKETS, DEFAULT_QUANTILES, Counter,
                      Gauge, Histogram, MetricsRegistry, Summary, counter,
                      gauge, get_registry, histogram, summary)
from .tracing import (Digest, chrome_trace, disable_tracing, enable_tracing,
                      flight_dump, instant, register_state_provider, span,
                      trace_context, tracing_enabled)

__all__ = [
    "Counter", "Gauge", "Histogram", "Summary", "MetricsRegistry",
    "DEFAULT_BUCKETS", "DEFAULT_QUANTILES",
    "counter", "gauge", "histogram", "summary", "get_registry",
    "prometheus_text", "parse_prometheus_text", "render_families",
    "write_jsonl_snapshot",
    "start_http_server", "stop_http_server",
    "RotatingJsonlSink", "resolve_sink_path",
    "tracing", "span", "instant", "trace_context", "chrome_trace",
    "flight_dump", "register_state_provider", "Digest",
    "enable_tracing", "disable_tracing", "tracing_enabled",
    "fleet", "FleetMetricsAggregator", "SLOConfig", "SLOTracker",
    "BrownoutController", "BROWNOUT_LEVELS", "FLEET_REPLICA_LABEL",
    "TRACEPARENT_HEADER", "attempt_trace_id", "format_traceparent",
    "parse_traceparent", "traceparent_of", "mad_zscores", "merge_catapult",
    "snapshot", "enable", "disable", "enabled",
]


def enable():
    _ENABLED[0] = True


def disable():
    """Kill switch: instrumentation sites reduce to one flag check."""
    _ENABLED[0] = False


def enabled() -> bool:
    return _ENABLED[0]


def _serving_state() -> dict:
    """The serving slice of a snapshot: every ``paddle_tpu_serving_*``
    / KV-block gauge currently registered (scrape-free), plus the live
    engine's ``stats()`` — queue, slots, block-pool accounting, prefix
    cache — via the flight-recorder state providers."""
    gauges = {}
    for m in get_registry().metrics():
        if m.kind != "gauge":
            continue
        if m.name.startswith(("paddle_tpu_serving_", "paddle_tpu_kv_")):
            samples = m.collect()
            if not m.labelnames:
                gauges[m.name] = samples[0]["value"] if samples else None
            else:
                gauges[m.name] = samples
    return {"gauges": gauges, **tracing.state_snapshot()}


def snapshot() -> dict:
    """Full observability state as one JSON-ready dict:

    - ``metrics``: every registered metric's samples (counters, gauges,
      histograms with bucket counts, summaries with quantiles),
    - ``serving``: the serving gauges + (when an engine is alive) its
      full ``stats()`` incl. block-pool accounting,
    - ``tracing``: span counts per phase, buffered-event count, last
      flight-dump path.
    """
    return {
        "ts": time.time(),
        "metrics": get_registry().collect(),
        "serving": _serving_state(),
        "tracing": tracing.summary(),
    }
