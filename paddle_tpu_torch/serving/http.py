"""Opt-in stdlib HTTP front end for the serving engine (counterpart of
``paddle_tpu/serving/http.py``): the same endpoints, bodies, records and
status codes.

Token-level API (the framework has no tokenizer): prompts and
completions are lists of token ids.

- ``POST /generate`` body
  ``{"prompt": [ids], "max_new_tokens": 16, "do_sample": false,
     "temperature": 1.0, "top_k": 0, "top_p": 1.0, "eos_token_id": null,
     "seed": 0, "spec_k": null, "priority": "interactive",
     "deadline_s": null, "stream": false}``
  -> ``{"request_id", "status", "prompt_len", "tokens", "ttft_s",
        "tpot_s", "latency_s", "spec_drafted", "spec_accepted",
        "error"}``; with ``"stream": true`` the response is
  newline-delimited JSON, one ``{"token": id}`` line per token as it
  lands, then the record with ``"done": true``.
- ``GET /healthz``  -> ``engine.health()``: 200 only while admitting;
  the 503 states (``crashed`` / ``draining`` / ``stopped`` /
  ``saturated`` / ``stalled``) each carry their own payload, and a
  saturated one a ``Retry-After`` header from the queue-wait digest.
- ``GET /stats``    -> ``engine.stats()`` (with the streaming latency
  digests and the goodput gauge).
- ``GET /trace``    -> the request-lifecycle trace as Chrome-trace
  (catapult) JSON; ``?trace=<id>`` filters to one request's lanes.
- ``GET /metrics``  -> Prometheus text exposition of the port's
  registry.
- ``GET /debug/requests`` -> the live per-request table (queued /
  running / recent, with phase, KV blocks, waits, latencies).
- ``POST /drain``   -> graceful shutdown: stop admitting, finish
  in-flight requests (body ``{"timeout_s": ...}`` bounds the wait;
  stragglers are FAILED explicitly), then 200 ``{"drained": bool}``.

``POST /generate`` honors a W3C-traceparent header
(``00-<32hex>-<16hex>-<2hex>``): a valid one makes the request's span
tree record under the propagated trace id; a malformed or absent one is
ignored (a fresh local trace), never answered with 4xx or 5xx.

Backpressure maps to ``429`` (+ ``Retry-After``), invalid requests to
``400``, draining/stopped engines to ``503``. Nothing starts this
server implicitly. Handlers run on the server's threads: a streaming
handler blocks on ``Request.stream()``, and ``/healthz``, ``/metrics``
and ``/debug/requests`` read host state, never waiting for the step.

``ServingHTTPServer`` is the instance API (one per engine, any number
per process); ``start_serving_http_server`` /
``stop_serving_http_server`` keep one default server per process. The
JAX module's ``/debug/memory`` (the perf HBM ledger) waits for the
perf module. A quarantined fingerprint (``PoisonedRequestError`` from a
supervisor) answers ``400`` with ``{"quarantined": true, "fingerprint":
..., "retriable": false}``.
"""

from __future__ import annotations

import json
import math
import threading

from ..observability import exporters as _exp
from ..observability import fleet as _fleet
from ..observability import tracing as _tracing
from . import metrics as _sm
from .engine import EngineStoppedError
from .scheduler import QueueFullError
from .supervisor import PoisonedRequestError

__all__ = ["ServingHTTPServer", "start_serving_http_server",
           "stop_serving_http_server", "retry_after_header"]

_default_server = None
_server_lock = threading.Lock()


def _request_record(req) -> dict:
    return {
        "request_id": req.id,
        "status": req.status,
        "prompt_len": int(req.prompt.shape[0]),
        "tokens": list(req.output_tokens),
        "ttft_s": req.ttft_s,
        "tpot_s": req.tpot_s,
        "latency_s": (req.finish_ts - req.arrival_ts
                      if req.finish_ts else None),
        "spec_drafted": req.spec_drafted,
        "spec_accepted": req.spec_accepted,
        "error": req.error,
    }


def retry_after_header(payload: dict) -> dict:
    """``Retry-After`` (integer seconds, >= 1 per RFC 9110) from a
    payload's ``retry_after_s`` hint, or no header when there is none."""
    ra = payload.get("retry_after_s")
    if ra is None:
        return {}
    return {"Retry-After": str(max(1, math.ceil(float(ra))))}


class ServingHTTPServer:
    """One engine's HTTP front end on a daemon thread. ``port=0`` binds
    a free port (read it back from ``.port``); ``stop()`` shuts the
    server down (the engine itself is stopped separately — or via
    ``POST /drain``)."""

    def __init__(self, engine, port: int = 0, addr: str = "127.0.0.1",
                 request_timeout_s: float = 300.0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        engine.start()
        self.engine = engine

        class _Handler(BaseHTTPRequestHandler):
            def _json(self, code: int, payload: dict, headers=None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/healthz":
                    code, payload = engine.health()
                    self._json(code, payload,
                               headers=retry_after_header(payload))
                elif path == "/stats":
                    self._json(200, engine.stats())
                elif path == "/trace":
                    # catapult JSON for chrome://tracing; ?trace=<id>
                    # filters to one request's lanes
                    trace = None
                    query = self.path.partition("?")[2]
                    for kv in query.split("&"):
                        k, _, v = kv.partition("=")
                        if k == "trace" and v:
                            try:
                                trace = int(v)
                            except ValueError:
                                trace = v
                    self._json(200, _tracing.chrome_trace(trace))
                elif path == "/metrics":
                    # Prometheus exposition for this replica — a router's
                    # federation scrapes it
                    body = _exp.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/debug/requests":
                    self._json(200, engine.debug_requests())
                else:
                    self._json(404, {"error": f"no such path {path!r}"})

            def do_POST(self):
                path = self.path.split("?")[0]
                if path == "/drain":
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                        body = json.loads(self.rfile.read(length) or b"{}")
                        timeout_s = body.get("timeout_s")
                    except (ValueError, json.JSONDecodeError) as e:
                        self._json(400, {"error": f"bad request: {e}"})
                        return
                    drained = engine.drain(timeout_s=timeout_s)
                    self._json(200, {"drained": bool(drained),
                                     "status": engine.health()[1]["status"]})
                    return
                if path != "/generate":
                    self._json(404, {"error": "POST /generate or /drain"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length) or b"{}")
                    prompt = body.pop("prompt")
                    stream = bool(body.pop("stream", False))
                    deadline_s = body.pop("deadline_s", None)
                    if not isinstance(prompt, (list, tuple)) or not prompt:
                        raise ValueError("prompt must be a non-empty list "
                                         "of token ids")
                except (ValueError, KeyError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                # fleet trace propagation: a VALID traceparent header
                # makes the replica-side request adopt the propagated
                # trace id (the Request is constructed on this handler
                # thread inside submit, under the context). Anything
                # malformed parses to None — a fresh local trace, never
                # a 400/500; a hostile header must not cost the caller
                # their request.
                prop = _fleet.parse_traceparent(
                    self.headers.get(_fleet.TRACEPARENT_HEADER))
                try:
                    if prop is not None:
                        with _tracing.trace_context(prop):
                            req = engine.submit(prompt,
                                                deadline_s=deadline_s,
                                                **body)
                    else:
                        req = engine.submit(prompt, deadline_s=deadline_s,
                                            **body)
                except QueueFullError as e:
                    # backpressure carries the same digest-derived
                    # Retry-After hint the saturated /healthz payload
                    # does; a deadline-infeasible rejection carries the
                    # queue-wait estimate the deadline lost to instead
                    ra = getattr(e, "retry_after_s", None)
                    if ra is None:
                        ra = _sm.queue_wait_retry_after()
                    self._json(429, {"error": str(e), "retry_after_s": ra},
                               headers=retry_after_header(
                                   {"retry_after_s": ra}))
                    return
                except EngineStoppedError as e:
                    self._json(503, {"error": str(e),
                                     "status": engine.health()[1]["status"]})
                    return
                except PoisonedRequestError as e:
                    # a quarantined fingerprint (supervised engines): an
                    # actionable 400 that names the fingerprint and says
                    # not to retry. It precedes the ValueError arm: it IS
                    # a ValueError, so unsupervised surfaces still treat
                    # it as a plain bad request
                    self._json(400, {"error": str(e),
                                     "quarantined": True,
                                     "fingerprint": e.fingerprint,
                                     "retriable": False})
                    return
                except (TypeError, ValueError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                if not stream:
                    try:
                        req.result(timeout=request_timeout_s)
                    except TimeoutError:
                        req.cancel()
                        req.result(timeout=10.0)
                    self._json(200, _request_record(req))
                    return
                # streaming: newline-delimited JSON; no Content-Length,
                # the connection close marks the end (HTTP/1.0 framing)
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.end_headers()
                try:
                    for tok in req.stream(timeout=request_timeout_s):
                        self.wfile.write(
                            (json.dumps({"token": int(tok)}) + "\n").encode())
                        self.wfile.flush()
                except (TimeoutError, BrokenPipeError, ConnectionResetError):
                    req.cancel()
                done = dict(_request_record(req))
                done["done"] = True
                try:
                    self.wfile.write((json.dumps(done) + "\n").encode())
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def log_message(self, *args):  # no per-request stderr chatter
                pass

        self._server = ThreadingHTTPServer((addr, port), _Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"paddle-tpu-torch-serving-http:{self.port}", daemon=True)
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


def start_serving_http_server(engine, port: int = 0, addr: str = "127.0.0.1",
                              request_timeout_s: float = 300.0) -> int:
    """Serve the engine over HTTP on a daemon thread; returns the bound
    port (``port=0`` picks a free one). Starts the engine's background
    loop if it isn't running (handlers block on ``Request.result``).
    One default server per process — build ``ServingHTTPServer``
    instances directly to front several engines."""
    global _default_server
    with _server_lock:
        if _default_server is not None:
            return _default_server.port
        _default_server = ServingHTTPServer(
            engine, port=port, addr=addr,
            request_timeout_s=request_timeout_s)
        return _default_server.port


def stop_serving_http_server():
    global _default_server
    with _server_lock:
        if _default_server is not None:
            _default_server.stop()
            _default_server = None
