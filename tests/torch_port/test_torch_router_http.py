"""The port's router HTTP front end (``serving/router_http.py``) against
the JAX package (tiny Llama, fp32, CPU): ``POST /generate`` plain and
streamed (the JAX engine's tokens), ``/healthz`` 200 and its 503
``draining`` / ``unavailable`` states, ``/replicas``, the federated
``/metrics`` with ``replica`` labels, ``/slo``, ``/trace?request=``,
``POST /drain``, the 400 / 429 / 503 answers (quarantined, brownout
shedding, no replica), a hostile ``traceparent`` that never errors, an
``HTTPReplica`` round trip, and the record's keys against the JAX
``_record``'s."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.serving import router as jrouter
from paddle_tpu.serving import router_http as jrouter_http

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.observability.exporters import parse_prometheus_text
from paddle_tpu_torch.serving import router as trouter
from paddle_tpu_torch.serving import router_http as trouter_http
from torch_parity import prompt32, tiny_pair

SEED = 1717
KW = dict(max_slots=2, max_len=64, block_size=16, prefill_chunk=32)
KW["num_blocks"] = tserving.ServingConfig(**KW).default_num_blocks()
N_NEW = 6


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def prompts(pair):
    rng = np.random.RandomState(SEED)
    return [prompt32(rng, pair[2], 4 + i) for i in range(4)]


@pytest.fixture(scope="module")
def jax_tokens(pair, prompts):
    eng = jserving.ServingEngine(pair[0], **KW)
    reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in prompts]
    eng.run_until_idle()
    return [list(r.output_tokens) for r in reqs]


def _engine(pair, **kw):
    return tserving.ServingEngine(pair[1], device="cpu", **dict(KW, **kw))


def _call(base, path, obj=None, headers=None, timeout=60):
    """(status, headers, body bytes); 4xx / 5xx answers returned."""
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _generate(base, prompt, stream=False, **kw):
    code, hdrs, body = _call(base, "/generate", dict(
        {"prompt": [int(t) for t in prompt], "max_new_tokens": N_NEW,
         "stream": stream}, **kw))
    if stream and code == 200:
        lines = [json.loads(x) for x in body.decode().splitlines() if x]
        return code, lines[-1], [x["token"] for x in lines if "token" in x]
    return code, json.loads(body), None


@pytest.fixture
def front(pair):
    """A router over two port engines behind ``RouterHTTPServer``."""
    router = tserving.Router([_engine(pair), _engine(pair)],
                             stats_refresh_s=0.0)
    srv = tserving.RouterHTTPServer(router, port=0)
    yield router, f"http://127.0.0.1:{srv.port}"
    srv.stop()
    router.stop(drain=True, timeout_s=10)


def test_generate_plain_and_streamed(front, prompts, jax_tokens):
    _, base = front
    for i, p in enumerate(prompts):
        code, rec, toks = _generate(base, p, stream=bool(i % 2))
        assert code == 200 and rec["status"] == "completed"
        assert rec["tokens"] == jax_tokens[i]
        assert rec["replica"] in ("r0", "r1") and rec["retries"] == 0
        if toks is not None:
            assert rec["done"] is True and toks == rec["tokens"]


def test_fleet_endpoints(front, prompts):
    """``/replicas`` lists both; ``/metrics`` federates every replica's
    series under ``replica`` labels and the ``fleet`` roll-up; ``/slo``
    reports its three objectives; ``/trace?request=`` merges the
    router's lane with the attempt's (404 unknown, 400 without id)."""
    router, base = front
    code, rec, _ = _generate(base, prompts[0])
    assert code == 200
    rows = json.loads(_call(base, "/replicas")[2])["replicas"]
    assert [r["name"] for r in rows] == ["r0", "r1"]
    code, hdrs, body = _call(base, "/metrics")
    assert code == 200 and hdrs["Content-Type"].startswith("text/plain")
    fams = parse_prometheus_text(body.decode())
    reps = {s["labels"].get("replica") for s in
            fams["paddle_tpu_serving_requests_total"]["samples"]}
    assert {"r0", "r1", "fleet"} <= reps
    assert "paddle_tpu_fleet_scrape_age_seconds" in fams
    slo = json.loads(_call(base, "/slo")[2])
    assert slo["ok"] is True and slo["observed"] >= 1
    assert set(slo["objectives"]) == {"availability", "goodput", "ttft_p95"}
    merged = json.loads(_call(base, f"/trace?request={rec['request_id']}")[2])
    lanes = [ev["args"]["name"] for ev in merged["traceEvents"]
             if ev.get("ph") == "M" and ev["name"] == "process_name"]
    assert f"router request {rec['request_id']}" in lanes
    assert any(n.startswith("attempt 1 ") for n in lanes)
    assert _call(base, "/trace?request=999999")[0] == 404
    assert _call(base, "/trace")[0] == 400
    assert _call(base, "/nowhere")[0] == 404
    assert json.loads(_call(base, "/stats")[2])["requests"] >= 1


def test_healthz_states_and_drain(front, prompts, jax_tokens):
    """200 with both replicas; after ``POST /drain`` of r0 still 200 on
    r1; after a drain of all, 503 ``draining`` / ``stopped`` and a 503
    for ``/generate``; with every replica ejected, 503 ``unavailable``."""
    router, base = front
    code, _, body = _call(base, "/healthz")
    health = json.loads(body)
    assert code == 200 and health["status"] == "ok"
    assert health["healthy_replicas"] == 2
    assert _call(base, "/drain", {"replica": "nope"})[0] == 404
    assert _call(base, "/drain", {"replica": "r0", "timeout_s": 30})[0] == 200
    router.drain("r0")  # joins the drain thread POST /drain started
    code, _, body = _call(base, "/healthz")
    assert code == 200 and json.loads(body)["healthy_replicas"] == 1
    code, rec, _ = _generate(base, prompts[1])
    assert code == 200 and rec["replica"] == "r1"
    assert rec["tokens"] == jax_tokens[1]
    for rep in router._replicas.values():
        rep.state = tserving.ReplicaState.EJECTED
    code, _, body = _call(base, "/healthz")
    assert code == 503 and json.loads(body)["status"] == "unavailable"
    router.drain_all(timeout_s=10)
    code, _, body = _call(base, "/healthz")
    assert code == 503 and json.loads(body)["status"] in ("draining",
                                                         "stopped")
    code, hdrs, body = _call(base, "/generate",
                             {"prompt": [1, 2, 3], "max_new_tokens": 2})
    assert code == 503 and hdrs["Retry-After"]
    assert "no live replicas" in json.loads(body)["error"]


def test_error_answers(front, prompts):
    """400 for a bad body, 400 ``quarantined`` (not retriable) for a
    blacklisted fingerprint, 429 with ``Retry-After`` for batch work
    shed under brownout."""
    router, base = front
    for bad in ({"prompt": []}, {"prompt": "x"}, {"max_new_tokens": 3}):
        assert _call(base, "/generate", bad)[0] == 400
    assert _call(base, "/generate", {"prompt": [1, 2], "bogus": 1})[0] == 400
    p = prompts[2]
    fp = tserving.request_fingerprint(
        np.asarray(p, np.int32), tserving.SamplingParams(max_new_tokens=N_NEW))
    router._learn_quarantine(fp, "r0")
    code, rec, _ = _generate(base, p)
    assert code == 400
    assert rec["quarantined"] is True and rec["retriable"] is False
    assert rec["fingerprint"] == fp and "PoisonedRequestError" in rec["error"]
    burning = {"ok": False, "observed": 5, "objectives": {}}
    router._brownout.update(burning, now=1e9)
    code, hdrs, body = _call(base, "/generate", {
        "prompt": [int(t) for t in prompts[3]], "max_new_tokens": 2,
        "priority": "batch"})
    assert code == 429 and hdrs["Retry-After"]
    assert json.loads(body)["retry_after_s"] >= 1


def test_hostile_traceparent_never_errors(pair, prompts):
    """Malformed ``traceparent`` headers on the routed path through an
    ``HTTPReplica`` cost nothing: 200, a fresh local trace."""
    eng = _engine(pair)
    esrv = tserving.ServingHTTPServer(eng, port=0)
    router = tserving.Router([tserving.HTTPReplica(
        f"http://127.0.0.1:{esrv.port}", name="remote0")])
    srv = tserving.RouterHTTPServer(router, port=0)
    base = f"http://127.0.0.1:{srv.port}"
    hostile = ["", "garbage", "00-zz-11-01",
               "00-" + "0" * 32 + "-" + "0" * 16 + "-01",
               "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01", "x" * 512]
    try:
        for header in hostile:
            code, _, body = _call(base, "/generate", {
                "prompt": [int(t) for t in prompts[0][:4]],
                "max_new_tokens": 2}, headers={"traceparent": header})
            assert code == 200
            assert json.loads(body)["status"] == "completed"
    finally:
        srv.stop()
        esrv.stop()
        eng.stop()
        router.stop()


def test_http_replica_round_trip(pair, prompts, jax_tokens):
    """A router over an ``HTTPReplica``: the probe reads ``/healthz``,
    the request streams through ``POST /generate`` under a propagated
    traceparent, and the replica's lane joins the merged trace."""
    eng = _engine(pair)
    esrv = tserving.ServingHTTPServer(eng, port=0)
    hr = tserving.HTTPReplica(f"http://127.0.0.1:{esrv.port}",
                              name="remote0")
    router = tserving.Router([hr])
    try:
        assert hr.healthz()["status"] == "ok"
        assert hr.stats()["slots"] == KW["max_slots"]
        seen = []
        rr = router.submit(prompts[3], max_new_tokens=N_NEW,
                           on_token=lambda r, t: seen.append(t))
        assert rr.result(timeout=60) == jax_tokens[3] == seen
        assert rr.status == "completed" and rr.replica == "remote0"
        lanes = [ev["args"]["name"]
                 for ev in router.merged_trace(rr.id)["traceEvents"]
                 if ev.get("ph") == "M" and ev["name"] == "process_name"]
        assert any("[remote0]" in n for n in lanes)
        assert "paddle_tpu_serving_requests_total" in hr.metrics_text()
    finally:
        esrv.stop()
        eng.stop()
        router.stop()


def test_record_keys_equal_the_jax_record():
    """The ``/generate`` record and the fleet health payload carry the
    JAX front end's keys."""
    prompt = np.arange(1, 6, dtype=np.int32)
    j = jrouter.RouterRequest(prompt, jserving.SamplingParams(), None, None)
    t = trouter.RouterRequest(prompt, tserving.SamplingParams(), None, None)
    jrec, trec = jrouter_http._record(j), trouter_http._record(t)
    assert sorted(trec) == sorted(jrec)
    assert {k: v for k, v in trec.items() if k != "request_id"} == \
        {k: v for k, v in jrec.items() if k != "request_id"}
    jcode, jpay = jrouter_http.router_health(jserving.Router([]))
    tcode, tpay = trouter_http.router_health(tserving.Router([]))
    assert tcode == jcode == 503
    assert sorted(tpay) == sorted(jpay) and tpay["status"] == jpay["status"]
