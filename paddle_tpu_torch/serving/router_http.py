"""HTTP front end for the multi-replica router (counterpart of
``paddle_tpu/serving/router_http.py``) — the process boundary of the
serving fleet. Same zero-dependency stdlib pattern as
``serving.http`` (which fronts ONE engine; this fronts the router that
fans out over many).

- ``POST /generate`` — the ``serving.http`` request surface, routed:
  body/response identical (plus ``"replica"``, ``"retries"``,
  ``"hedged"`` in the record), streaming via ``"stream": true``.
  Failover/retry/hedging happen underneath; the client sees each token
  once. ``503`` + ``Retry-After`` when no replica can admit
  (saturation), ``400`` for bad requests. A QUARANTINED fingerprint
  (a poison request that crashed supervised engines until its budget
  ran out) gets an actionable ``400`` — ``{"quarantined": true,
  "fingerprint": ..., "retriable": false}`` — whether refused at
  submit or convicted mid-flight; batch-class work shed under SLO
  brownout gets ``429`` + ``Retry-After``.
- ``GET /healthz`` — fleet health: 200 while at least one replica is in
  rotation; 503 payload distinguishes ``draining`` (shutdown in
  progress) from ``unavailable`` (everything ejected). Per-replica
  states ride along.
- ``GET /stats`` — ``router.stats()`` (replica table, amplification,
  outcome counts).
- ``GET /replicas`` — just the replica table (incl. the ``straggler``
  flag per replica).
- ``GET /metrics`` — the FEDERATED Prometheus exposition: every
  replica's series relabeled ``replica=<name>`` plus ``replica="fleet"``
  roll-ups (summed counters/histograms, count-weighted merged summary
  digests, fleet goodput). Scrapes are staleness-bounded and
  timeout-guarded; a hung replica serves last-known series flagged by
  ``paddle_tpu_fleet_scrape_stale``.
- ``GET /slo`` — the fleet SLO verdict: per-objective (availability /
  goodput / ttft_p95) multi-window burn rates with ok/breach flags.
- ``GET /trace?request=<id>`` — ONE merged catapult file for a routed
  request: the router's lane + each attempt's replica-side swimlane
  (fetched by the propagated trace id), 404 for unknown/evicted ids.
- ``POST /drain`` — body ``{"replica": name}`` drains one replica,
  ``{}`` drains ALL (graceful fleet shutdown); non-blocking, poll
  ``/replicas``.

SIGTERM → graceful drain: ``install_sigterm_drain(router)`` registers a
fault-tolerance preemption listener (``fault_tolerance.preemption``),
so the signal stops admission, finishes in-flight requests on every
replica, and leaves the router reporting ``draining``/``stopped`` —
instead of the old behavior (process death fails every in-flight
request with no recovery).
"""

from __future__ import annotations

import json
import threading
import time

from .http import retry_after_header
from .request import RequestStatus
from .router import NoReplicaError, ReplicaState, Router
from .scheduler import QueueFullError
from .supervisor import POISON_MARKER, PoisonedRequestError

__all__ = ["RouterHTTPServer", "install_sigterm_drain",
           "uninstall_sigterm_drain"]


def _record(rr) -> dict:
    return {
        "request_id": rr.id,
        "status": rr.status,
        "prompt_len": int(rr.prompt.shape[0]),
        "tokens": list(rr.output_tokens),
        "ttft_s": rr.ttft_s,
        "tpot_s": rr.tpot_s,
        "latency_s": (rr.finish_ts - rr.arrival_ts
                      if rr.finish_ts else None),
        "replica": rr.replica,
        "retries": rr.retries,
        "hedged": rr.hedged,
        "error": rr.error,
    }


def router_health(router: Router) -> tuple:
    """(http_status, payload): fleet-level health — 200 while anyone is
    admitting."""
    rows = router.replicas()
    states = [r["state"] for r in rows]
    payload = {"ts": time.time(), "replicas": rows,
               "healthy_replicas": states.count(ReplicaState.HEALTHY)}
    if payload["healthy_replicas"] > 0:
        payload["status"] = "ok"
        return 200, payload
    if states and all(s in (ReplicaState.DRAINING, ReplicaState.STOPPED)
                      for s in states):
        payload["status"] = "draining" \
            if ReplicaState.DRAINING in states else "stopped"
    else:
        payload["status"] = "unavailable"
    return 503, payload


class RouterHTTPServer:
    """The router served over HTTP on a daemon thread; ``port=0`` binds
    a free port (``.port``). ``sigterm_drain=True`` additionally wires
    SIGTERM/SIGINT to a graceful fleet drain."""

    def __init__(self, router: Router, port: int = 0,
                 addr: str = "127.0.0.1", request_timeout_s: float = 300.0,
                 sigterm_drain: bool = False):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.router = router
        router.start()  # background prober: health gating needs no caller
        if sigterm_drain:
            install_sigterm_drain(router)

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
                    code, payload = router_health(router)
                    self._json(code, payload)
                elif path == "/stats":
                    self._json(200, router.stats())
                elif path == "/replicas":
                    self._json(200, {"replicas": router.replicas()})
                elif path == "/metrics":
                    body = router.federated_metrics_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/slo":
                    self._json(200, router.slo_report())
                elif path == "/trace":
                    req_id = None
                    for kv in self.path.partition("?")[2].split("&"):
                        k, _, v = kv.partition("=")
                        if k == "request" and v:
                            try:
                                req_id = int(v)
                            except ValueError:
                                pass
                    if req_id is None:
                        self._json(400, {"error": "GET /trace?request=<id>"})
                        return
                    merged = router.merged_trace(req_id)
                    if merged is None:
                        self._json(404, {"error": f"no routed request "
                                                  f"{req_id} in the recent "
                                                  f"registry"})
                        return
                    self._json(200, merged)
                else:
                    self._json(404, {"error": f"no such path {path!r}"})

            def do_POST(self):
                path = self.path.split("?")[0]
                if path == "/drain":
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                        body = json.loads(self.rfile.read(length) or b"{}")
                    except (ValueError, json.JSONDecodeError) as e:
                        self._json(400, {"error": f"bad request: {e}"})
                        return
                    name = body.get("replica")
                    try:
                        if name is None:
                            threading.Thread(
                                target=router.drain_all,
                                args=(body.get("timeout_s"),),
                                daemon=True).start()
                        else:
                            router.drain(name, body.get("timeout_s"),
                                         wait=False)
                    except KeyError as e:
                        self._json(404, {"error": str(e)})
                        return
                    self._json(200, {"draining": name or "all"})
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
                try:
                    rr = router.submit(prompt, deadline_s=deadline_s,
                                       **body)
                except NoReplicaError as e:
                    self._json(503, {"error": str(e)},
                               headers=retry_after_header(
                                   {"retry_after_s": e.retry_after_s or 1}))
                    return
                except PoisonedRequestError as e:
                    # fleet-wide quarantine verdict: an actionable 400 —
                    # the body names the fingerprint and says never to
                    # resubmit (a 429/503 would invite the retry that
                    # crash-loops fleets)
                    self._json(400, {"error": str(e),
                                     "quarantined": True,
                                     "fingerprint": e.fingerprint,
                                     "retriable": False})
                    return
                except QueueFullError as e:
                    # brownout shed (batch class under SLO burn): 429 +
                    # Retry-After — deferrable work comes back later
                    ra = getattr(e, "retry_after_s", None) or 1
                    self._json(429, {"error": str(e), "retry_after_s": ra},
                               headers=retry_after_header(
                                   {"retry_after_s": ra}))
                    return
                except (TypeError, ValueError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                if not stream:
                    try:
                        rr.result(timeout=request_timeout_s)
                    except TimeoutError:
                        rr.cancel()
                        try:
                            rr.result(timeout=10.0)
                        except TimeoutError:
                            pass
                    rec = _record(rr)
                    if rr.status == RequestStatus.FAILED and rr.error \
                            and "no admitting replica" in rr.error:
                        self._json(503, rec, headers=retry_after_header(
                            {"retry_after_s": 1}))
                        return
                    if rr.status == RequestStatus.FAILED and rr.error \
                            and POISON_MARKER in rr.error:
                        # quarantined MID-FLIGHT (the request was
                        # implicated in its last allowed crash): same
                        # actionable 400 as the submit-time refusal
                        rec["quarantined"] = True
                        rec["fingerprint"] = rr.fingerprint
                        rec["retriable"] = False
                        self._json(400, rec)
                        return
                    self._json(200, rec)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.end_headers()
                try:
                    for tok in rr.stream(timeout=request_timeout_s):
                        self.wfile.write(
                            (json.dumps({"token": int(tok)}) + "\n").encode())
                        self.wfile.flush()
                except (TimeoutError, BrokenPipeError, ConnectionResetError):
                    rr.cancel()
                done = dict(_record(rr))
                done["done"] = True
                try:
                    self.wfile.write((json.dumps(done) + "\n").encode())
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((addr, port), _Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"paddle-tpu-torch-router-http:{self.port}", daemon=True)
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


# -- SIGTERM -> graceful drain ----------------------------------------------

_drain_listeners = {}


def install_sigterm_drain(router: Router,
                          timeout_s=None) -> None:
    """Wire SIGTERM/SIGINT (and programmatic
    ``fault_tolerance.request_preemption()``) to a graceful fleet
    drain: stop admitting, finish in-flight requests on every replica,
    then stop. The drain runs off the signal-handler thread — the
    handler only flips the flag."""
    from ..fault_tolerance.preemption import (add_preemption_listener,
                                              install_preemption_handler)

    if router in _drain_listeners:
        return

    def _on_preempt(reason: str, router=router, timeout_s=timeout_s):
        threading.Thread(target=router.drain_all, args=(timeout_s,),
                         name="paddle-tpu-torch-router-sigterm-drain",
                         daemon=True).start()

    install_preemption_handler()
    add_preemption_listener(_on_preempt)
    _drain_listeners[router] = _on_preempt


def uninstall_sigterm_drain(router: Router) -> None:
    from ..fault_tolerance.preemption import remove_preemption_listener

    fn = _drain_listeners.pop(router, None)
    if fn is not None:
        remove_preemption_listener(fn)
