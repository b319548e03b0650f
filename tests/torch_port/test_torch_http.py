"""The port's HTTP front end against the JAX package's, each over a
started engine on the same tiny Llama (fp32, CPU): ``/generate`` gives
the same tokens and record keys, plain and streamed; bad bodies get 400,
backpressure 429 with ``Retry-After``, a drained engine 503; hostile
``traceparent`` headers are ignored and a valid one lands the request's
spans under its id; ``/metrics``, ``/trace``, ``/stats``,
``/healthz`` and ``/debug/requests`` answer alike."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.observability import fleet as jfleet
from paddle_tpu.observability import tracing as jtr

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.observability import exporters as texp
from paddle_tpu_torch.observability import fleet as tfleet
from paddle_tpu_torch.observability import tracing as ttr
from torch_parity import prompt32, tiny_pair

PKG = {"jax": (jserving, jtr, jfleet), "torch": (tserving, ttr, tfleet)}

# tests/test_serving.py's hostile traceparent headers
HOSTILE = ["", " ", "garbage", "00", "00-", "00-ab-cd-01",
           "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
           "00-" + "AB" * 16 + "-" + "cd" * 8 + "-01",
           "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",
           "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",
           "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01-extra",
           "\x01\x02bin", "0" * 2048]


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(max_position_embeddings=256)


def _engine(name, pair, **kw):
    jm, tm, _ = pair
    if name == "jax":
        return jserving.ServingEngine(jm, **kw)
    return tserving.ServingEngine(tm, device="cpu", **kw)


def _call(url, body=None, headers=None, timeout=60):
    """(status, headers, body bytes); a 4xx/5xx answer is returned, not
    raised."""
    data = body if body is None or isinstance(body, bytes) \
        else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _generate(base, prompt, headers=None, **kw):
    return _call(f"{base}/generate",
                 {"prompt": [int(t) for t in prompt], **kw}, headers)


def test_http_front_ends_agree(pair, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SINK_DIR", str(tmp_path))
    _, _, cfg = pair
    rng = np.random.RandomState(43)
    prompts = [prompt32(rng, cfg, n) for n in (5, 12, 7)]
    cases = [dict(max_new_tokens=6),
             dict(max_new_tokens=6, stream=True),
             dict(max_new_tokens=8, do_sample=True, top_k=8, seed=3),
             dict(max_new_tokens=8, do_sample=True, top_k=8, seed=3,
                  stream=True),
             dict(max_new_tokens=5, eos_token_id=2)]
    out = {}
    for name, (srv_mod, tr, fleet) in PKG.items():
        eng = _engine(name, pair, max_slots=2, max_len=64,
                      max_queue_depth=4)
        srv = srv_mod.ServingHTTPServer(eng, port=0)
        base = f"http://127.0.0.1:{srv.port}"
        got = {"tokens": [], "records": [], "codes": []}
        try:
            for i, kw in enumerate(cases):
                code, hdr, body = _generate(base, prompts[i % 3], **kw)
                assert code == 200, (name, kw, body)
                if kw.get("stream"):
                    assert hdr["Content-Type"] == "application/jsonl"
                    lines = [json.loads(x) for x in body.splitlines() if x]
                    toks = [x["token"] for x in lines if "token" in x]
                    rec = lines[-1]
                    assert rec.pop("done") is True and rec["tokens"] == toks
                else:
                    rec = json.loads(body)
                assert rec["status"] == "completed"
                assert rec["ttft_s"] is not None and rec["latency_s"]
                got["tokens"].append(rec["tokens"])
                got["records"].append(sorted(rec))
            # hostile traceparents: ignored, never a 4xx/5xx
            for header in HOSTILE:
                code, _, body = _generate(base, prompts[0],
                                          {"traceparent": header},
                                          max_new_tokens=2)
                assert code == 200 and \
                    json.loads(body)["status"] == "completed", header
            # a valid one lands the request's spans under its id, and
            # /trace serves them
            tid = fleet.attempt_trace_id(4242, 1)
            code, _, _ = _generate(base, prompts[1],
                                   {"traceparent": fleet.traceparent_of(tid)},
                                   max_new_tokens=3)
            assert code == 200
            names = [e["name"] for e in tr.events(trace=tid)]
            assert {"request", "queued", "prefill", "decode",
                    "completed"} <= set(names)
            code, _, body = _call(f"{base}/trace?trace={tid}")
            ct = json.loads(body)["traceEvents"]
            got["trace"] = sorted({e["name"] for e in ct if e["ph"] != "M"})
            # the introspection endpoints
            code, hdr, body = _call(f"{base}/healthz")
            health = json.loads(body)
            assert (code, health["status"]) == (200, "ok")
            got["health"] = sorted(health)
            code, _, body = _call(f"{base}/stats")
            stats = json.loads(body)
            assert stats["latency_digests"]["ttft_s"]["count"] >= 1
            got["digests"] = {k: sorted(v) for k, v in
                              stats["latency_digests"].items()}
            code, hdr, body = _call(f"{base}/metrics")
            assert code == 200 and hdr["Content-Type"].startswith(
                "text/plain")
            fams = texp.parse_prometheus_text(body.decode())
            assert fams["paddle_tpu_serving_ttft_summary_seconds"]["type"] \
                == "summary"
            assert any(s["labels"].get("outcome") == "completed"
                       for s in fams["paddle_tpu_serving_requests_total"]
                       ["samples"])
            code, _, body = _call(f"{base}/debug/requests")
            dbg = json.loads(body)
            got["debug"] = (sorted(dbg), sorted(dbg["recent"][0]))
            got["codes"].append(_call(f"{base}/nope")[0])
            # bad bodies -> 400
            for bad in (b'{"prompt": []}', b"not json", b'{"max_new_tokens": 3}',
                        b'{"prompt": [1, 2], "bogus_knob": 1}',
                        b'{"prompt": [1, 2], "max_new_tokens": 0}',
                        b'{"prompt": [1, 2], "max_new_tokens": 999}'):
                got["codes"].append(_call(f"{base}/generate", bad)[0])
            got["codes"].append(_call(f"{base}/nope", b"{}")[0])
            # drain: 200 drained, then 503 for /healthz and /generate
            code, _, body = _call(f"{base}/drain", {"timeout_s": 30})
            drained = json.loads(body)
            assert code == 200 and drained["drained"] is True
            code, _, body = _call(f"{base}/healthz")
            got["codes"].append(code)
            assert json.loads(body)["status"] in ("draining", "stopped")
            code, _, body = _generate(base, prompts[0], max_new_tokens=2)
            got["codes"].append(code)
            assert json.loads(body)["status"] == "draining"
        finally:
            srv.stop()
            eng.stop(abort=True)
        out[name] = got
    assert out["torch"] == out["jax"]
    assert out["torch"]["codes"] == [404, 400, 400, 400, 400, 400, 400,
                                     404, 503, 503]


def test_backpressure_429_carries_retry_after(pair):
    """A hung loop holds the one-deep queue: the next request gets 429
    with ``Retry-After`` and the digest's hint in the body, and
    ``/healthz`` reads 503 ``saturated`` with the same header."""
    _, _, cfg = pair
    p = prompt32(np.random.RandomState(75), cfg, 4)
    out = {}
    for name, (srv_mod, _, _) in PKG.items():
        eng = _engine(name, pair, max_slots=1, max_len=64,
                      max_queue_depth=1)
        monkey = srv_mod.ChaosEngine(eng).hang_after_steps(0)
        srv = srv_mod.ServingHTTPServer(eng, port=0)
        base = f"http://127.0.0.1:{srv.port}"
        try:
            # a streamed request answers its headers at once and parks
            parked = urllib.request.urlopen(urllib.request.Request(
                f"{base}/generate", data=json.dumps(
                    {"prompt": [int(t) for t in p], "max_new_tokens": 4,
                     "stream": True}).encode()), timeout=10)
            code, hdr, body = _generate(base, p, max_new_tokens=4)
            assert code == 429 and int(hdr["Retry-After"]) >= 1
            assert json.loads(body)["retry_after_s"] > 0
            hcode, hhdr, hbody = _call(f"{base}/healthz")
            health = json.loads(hbody)
            assert int(hhdr["Retry-After"]) >= 1
            out[name] = (code, hcode, health["status"], sorted(health))
        finally:
            # the abort fails the parked request; the hung step is let go
            # just after, so the loop thread ends without running it
            threading.Timer(0.2, monkey.release).start()
            eng.stop(abort=True)
            srv.stop()
        last = json.loads(parked.read().splitlines()[-1])
        assert last["done"] is True and last["status"] == "failed"
    assert out["torch"] == out["jax"]
    assert out["torch"][:3] == (429, 503, "saturated")


def test_default_server_helpers(pair):
    """``start_serving_http_server`` keeps one server a process and
    starts the engine's loop; ``retry_after_header`` rounds up to whole
    seconds (at least 1), as the JAX helper does."""
    from paddle_tpu.serving.http import retry_after_header as jra

    from paddle_tpu_torch.serving.http import retry_after_header as tra

    for payload in ({}, {"retry_after_s": None}, {"retry_after_s": 0.05},
                    {"retry_after_s": 2.2}, {"retry_after_s": "3"}):
        assert tra(payload) == jra(payload)
    _, tm, cfg = pair
    eng = tserving.ServingEngine(tm, device="cpu", max_slots=1, max_len=64)
    port = tserving.start_serving_http_server(eng, port=0)
    try:
        assert tserving.start_serving_http_server(eng, port=0) == port
        assert eng.stats()["running"]
        p = prompt32(np.random.RandomState(5), cfg, 5)
        code, _, body = _generate(f"http://127.0.0.1:{port}", p,
                                  max_new_tokens=4)
        assert code == 200
        assert json.loads(body)["tokens"] == \
            tm.generate(p[None], max_new_tokens=4)[0, 5:].tolist()
    finally:
        tserving.stop_serving_http_server()
        eng.stop()
