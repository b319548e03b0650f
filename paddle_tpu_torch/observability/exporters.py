"""Metric exporters: Prometheus text exposition, JSONL snapshots, a
size-rotating JSONL sink, and an opt-in stdlib ``http.server`` scrape
endpoint (counterpart of ``paddle_tpu/observability/exporters.py``; the
same text, byte for byte, from the same registry state).

The Prometheus text format follows the exposition spec (``# HELP`` /
``# TYPE`` headers, escaped HELP text (``\\`` and ``\\n``) and label
values (``\\``, ``"``, ``\\n``), cumulative histogram buckets with an
explicit ``+Inf`` le plus ``_sum``/``_count`` series, summary quantile
series). ``parse_prometheus_text`` is the matching reader — used by
the round-trip test and by anyone scraping the JSONL lane without a
real Prometheus.

Sinks: every file-appending exporter (trace JSONL, chrome traces,
flight dumps) resolves RELATIVE paths against the
``PADDLE_TPU_SINK_DIR`` env var when set (one knob moves every
artifact off a read-only cwd), and ``RotatingJsonlSink`` bounds them —
``max_bytes`` with keep-1 rotation, so a long serving run cannot grow
a telemetry file without bound.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from .metrics import MetricsRegistry, get_registry

__all__ = [
    "prometheus_text", "parse_prometheus_text", "render_families",
    "write_jsonl_snapshot",
    "start_http_server", "stop_http_server",
    "RotatingJsonlSink", "resolve_sink_path",
]

SINK_DIR_ENV = "PADDLE_TPU_SINK_DIR"


def resolve_sink_path(path: str) -> str:
    """Relative sink paths land in ``$PADDLE_TPU_SINK_DIR`` when set
    (created on demand); absolute paths and unset env pass through."""
    sink_dir = os.environ.get(SINK_DIR_ENV)
    if sink_dir and not os.path.isabs(path):
        os.makedirs(sink_dir, exist_ok=True)
        return os.path.join(sink_dir, path)
    return path


class RotatingJsonlSink:
    """Append-one-JSON-line-per-record sink with size-based rotation:
    when the file would exceed ``max_bytes``, it is renamed to
    ``<path>.1`` (replacing the previous rotation — keep-1) and a fresh
    file is started, so total disk use is bounded at ~2x max_bytes."""

    def __init__(self, path: str, max_bytes: int = 64 << 20):
        self.path = resolve_sink_path(path)
        self.max_bytes = int(max_bytes)
        self._fh = None
        self._size = 0

    def write(self, rec: dict):
        line = json.dumps(rec) + "\n"
        if self._fh is None:
            self._fh = open(self.path, "a")
            self._size = self._fh.tell()
        if self._size and self._size + len(line) > self.max_bytes:
            self._fh.close()
            os.replace(self.path, self.path + ".1")
            self._fh = open(self.path, "a")
            self._size = 0
        self._fh.write(line)
        self._fh.flush()
        self._size += len(line)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    # exposition spec: HELP text escapes backslash and newline (a raw
    # newline here would corrupt the whole exposition — every following
    # fragment would parse as a sample line)
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _unescape_help(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        if v[i] == "\\" and i + 1 < len(v):
            out.append({"n": "\n", "\\": "\\"}.get(v[i + 1], v[i + 1]))
            i += 2
        else:
            out.append(v[i])
            i += 1
    return "".join(out)


def _fmt_labels(labels: Dict[str, str], extra: Optional[Dict[str, str]] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(items.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2 ** 53 else repr(f)


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in Prometheus text exposition format."""
    reg = registry or get_registry()
    lines: List[str] = []
    for m in sorted(reg.metrics(), key=lambda m: m.name):
        lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for sample in m.collect():
            labels = sample["labels"]
            if m.kind == "summary":
                for q, v in sample["quantiles"].items():
                    if v is None:
                        continue
                    lines.append(
                        f"{m.name}{_fmt_labels(labels, {'quantile': q})}"
                        f" {_fmt_value(v)}")
                lines.append(f"{m.name}_sum{_fmt_labels(labels)}"
                             f" {_fmt_value(sample['sum'])}")
                lines.append(f"{m.name}_count{_fmt_labels(labels)}"
                             f" {sample['count']}")
            elif m.kind == "histogram":
                cum = 0
                for le, c in zip(sample["buckets"], sample["counts"]):
                    cum += c
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(labels, {'le': _fmt_value(le)})}"
                        f" {cum}")
                cum += sample["counts"][-1]
                lines.append(f"{m.name}_bucket"
                             f"{_fmt_labels(labels, {'le': '+Inf'})} {cum}")
                lines.append(f"{m.name}_sum{_fmt_labels(labels)}"
                             f" {_fmt_value(sample['sum'])}")
                lines.append(f"{m.name}_count{_fmt_labels(labels)}"
                             f" {sample['count']}")
            else:
                lines.append(f"{m.name}{_fmt_labels(labels)}"
                             f" {_fmt_value(sample['value'])}")
    return "\n".join(lines) + "\n"


def _parse_labels(s: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    i = 0
    while i < len(s):
        eq = s.index("=", i)
        name = s[i:eq].strip().lstrip(",").strip()
        assert s[eq + 1] == '"', f"malformed label set: {s!r}"
        j = eq + 2
        buf = []
        while s[j] != '"':
            if s[j] == "\\":
                nxt = s[j + 1]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            else:
                buf.append(s[j])
                j += 1
        out[name] = "".join(buf)
        i = j + 1
    return out


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Parse the exposition format back into
    {name: {type, help, samples: [{labels, value}]}} — sample names keep
    their ``_bucket``/``_sum``/``_count`` suffixes (series-level view),
    grouped under the declared family name."""
    families: Dict[str, dict] = {}
    types: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            help_text = _unescape_help(help_text)
            families.setdefault(name, {"type": "untyped", "help": help_text,
                                       "samples": []})
            families[name]["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            families.setdefault(name, {"type": kind, "help": "",
                                       "samples": []})
            families[name]["type"] = kind
            types[name] = kind
            continue
        if line.startswith("#"):
            continue
        if "{" in line:
            name = line[:line.index("{")]
            rest = line[line.index("{") + 1:]
            labels_s, _, value_s = rest.rpartition("} ")
            labels = _parse_labels(labels_s)
        else:
            name, _, value_s = line.rpartition(" ")
            labels = {}
        value = float(value_s)
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[:-len(suffix)] if name.endswith(suffix) else None
            if base and types.get(base) in ("histogram", "summary"):
                family = base
                break
        families.setdefault(family, {"type": "untyped", "help": "",
                                     "samples": []})
        families[family]["samples"].append(
            {"series": name, "labels": labels, "value": value})
    return families


def render_families(families: Dict[str, dict]) -> str:
    """Inverse of ``parse_prometheus_text``: render a family dict back
    to exposition text. Families are emitted name-sorted with their
    ``# HELP``/``# TYPE`` headers (so the declared kind — notably
    ``summary`` — survives a parse → render → parse round trip);
    samples keep their insertion order and any ``_bucket``/``_sum``/
    ``_count`` suffixes already baked into ``series``. This is the
    fleet-federation writer: the router parses each replica's
    exposition, relabels/rolls up, and renders the union with this."""
    lines: List[str] = []
    for name in sorted(families):
        fam = families[name]
        if fam.get("help"):
            lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {fam.get('type') or 'untyped'}")
        for s in fam.get("samples", ()):
            lines.append(f"{s['series']}{_fmt_labels(s.get('labels', {}))}"
                         f" {_fmt_value(s['value'])}")
    return "\n".join(lines) + "\n"


def write_jsonl_snapshot(path: str, registry: Optional[MetricsRegistry] = None,
                         extra: Optional[dict] = None):
    """Append ONE JSON line holding the full registry state (plus any
    ``extra`` fields) — the flight-recorder export: a file of these lines
    is a coarse time series a fleet log pipeline can ingest directly."""
    reg = registry or get_registry()
    rec = {"ts": time.time(), "metrics": reg.collect()}
    if extra:
        rec.update(extra)
    with open(path, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    return rec


# ---------------------------------------------------------------------------
# Opt-in scrape endpoint (stdlib http.server; no third-party deps)
# ---------------------------------------------------------------------------

_server = None
_server_thread = None
_server_lock = threading.Lock()


def start_http_server(port: int = 0, addr: str = "127.0.0.1"):
    """Serve ``/metrics`` (Prometheus text) and ``/snapshot`` (JSON) on a
    daemon thread. Returns the bound port (``port=0`` picks a free one).
    Opt-in only: nothing in the runtime starts this implicitly."""
    global _server, _server_thread
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            code = 200
            if self.path.split("?")[0] == "/metrics":
                body = prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?")[0] == "/snapshot":
                from . import snapshot

                body = json.dumps(snapshot()).encode()
                ctype = "application/json"
            elif self.path.split("?")[0] == "/healthz":
                # liveness + the serving gauges (queue depth, slot
                # occupancy), so a probe sees serving state without
                # pulling a full snapshot
                reg = get_registry()

                def _g(name):
                    m = reg.get(name)
                    return m.value() if m is not None else None

                unhealthy = _g("paddle_tpu_serving_engine_unhealthy")
                code = 503 if unhealthy else 200
                body = json.dumps({
                    "status": "unhealthy" if unhealthy else "ok",
                    "ts": time.time(),
                    "serving_queue_depth": _g("paddle_tpu_serving_queue_depth"),
                    "serving_slots_busy": _g("paddle_tpu_serving_slots_busy"),
                    "serving_slot_occupancy": _g(
                        "paddle_tpu_serving_slot_occupancy"),
                    "serving_engine_crashes": _g(
                        "paddle_tpu_serving_engine_crashes_total"),
                }).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # no per-scrape stderr chatter
            pass

    with _server_lock:
        if _server is not None:
            return _server.server_address[1]
        _server = ThreadingHTTPServer((addr, port), _Handler)
        _server_thread = threading.Thread(target=_server.serve_forever,
                                          name="paddle-tpu-metrics",
                                          daemon=True)
        _server_thread.start()
        return _server.server_address[1]


def stop_http_server():
    global _server, _server_thread
    with _server_lock:
        if _server is not None:
            _server.shutdown()
            _server.server_close()
            _server = None
            _server_thread = None
