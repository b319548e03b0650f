"""The port's ``EngineSupervisor`` against the JAX package's (tiny Llama,
fp32, CPU), mirroring ``tests/test_supervisor.py``: a crash mid-decode
requeues the innocents onto a rebuilt engine, whose tokens equal the JAX
engine's and an uncrashed port engine's; the crash-loop breaker stays
crashed and fails what is pending with its message; a poison request is
quarantined after two crashes in both packages alike while the
innocents survive, and is refused at submit; a quarantine probe is
admitted alone, step for step as the JAX engine admits it; the
``supervisor_stats`` / ``stats()["supervisor"]`` / ``health()`` keys
equal the JAX ones; the HTTP front end answers a quarantined fingerprint
with the actionable 400.

Everything is driven synchronously (``run_until_idle``) or waits on a
request's own event with a time limit of its own: no sleeps."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.serving.supervisor import POISON_MARKER as JPOISON

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving.supervisor import POISON_MARKER
from torch_parity import prompt32, tiny_pair

SEED = 4321
KW = dict(max_slots=2, max_len=64, block_size=16, prefill_chunk=32)
KW["num_blocks"] = tserving.ServingConfig(**KW).default_num_blocks()
SPECS = [dict(max_new_tokens=8),
         dict(max_new_tokens=8, do_sample=True, top_k=8, seed=7),
         dict(max_new_tokens=6, do_sample=True, top_p=0.9, seed=3),
         dict(max_new_tokens=7)]


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(autouse=True)
def _sink(tmp_path, monkeypatch):
    """Crash paths write flight dumps: keep them in the test's folder."""
    monkeypatch.setenv("PADDLE_TPU_SINK_DIR", str(tmp_path))


def _prompts(seed, n, cfg):
    rng = np.random.RandomState(seed)
    return [prompt32(rng, cfg, 4 + i) for i in range(n)]


def _sup(pair, **kw):
    return tserving.EngineSupervisor(pair[1], device="cpu", **KW, **kw)


def _fp(prompt, spec):
    return tserving.request_fingerprint(
        np.asarray(prompt, np.int32), tserving.SamplingParams(**spec))


@pytest.fixture(scope="module")
def jax_ref(pair):
    """The JAX supervisor over the crash test's requests: tokens keyed
    by (prompt, spec), and its stats surfaces before any crash. The
    poison and admission tests go on with this supervisor (the JAX
    package's engines compile at build, the side of these tests that
    costs time)."""
    jm, _, cfg = pair
    sup = jserving.EngineSupervisor(jm, **KW)
    cases = list(zip(_prompts(SEED, len(SPECS), cfg), SPECS))
    reqs = [sup.submit(p, **s) for p, s in cases]
    sup.run_until_idle()
    toks = {(p.tobytes(), json.dumps(s, sort_keys=True)): list(r.output_tokens)
            for (p, s), r in zip(cases, reqs)}
    return {"tokens": toks, "supervisor_stats": sup.supervisor_stats(),
            "stats": sup.stats(), "health": sup.health(), "sup": sup}


def _ref(jax_ref, prompt, spec):
    return jax_ref["tokens"][(prompt.tobytes(),
                              json.dumps(spec, sort_keys=True))]


def test_crash_requeues_innocents_bit_identical(pair, jax_ref):
    """A supervised crash fails no innocent: queued and running requests
    ride to the rebuilt engine (on the supervisor's device) and complete
    with the JAX engine's tokens and an uncrashed port engine's; the dead
    engine's pools are released."""
    cfg = pair[2]
    prompts = _prompts(SEED, len(SPECS), cfg)
    plain = tserving.ServingEngine(pair[1], device="cpu", **KW)
    want = [plain.submit(p, **s) for p, s in zip(prompts, SPECS)]
    plain.run_until_idle()
    sup = _sup(pair)
    sup.warmup()
    chaos = tserving.SupervisedChaos(sup)
    chaos.current.crash_after_steps(2)
    reqs = [sup.submit(p, **s) for p, s in zip(prompts, SPECS)]
    sup.run_until_idle()
    assert chaos.injected["crash"] == 1
    assert sup.restarts == 1 and not sup.broken
    for req, w, p, s in zip(reqs, want, prompts, SPECS):
        assert req.status == "completed", req.error
        assert req.result(1.0) == list(w.output_tokens) == _ref(jax_ref, p, s)
    st = sup.supervisor_stats()
    assert st["crashes"] == 1 and st["restarts"] == 1
    assert st["quarantined"] == []  # one crash implicates no one
    assert sup.engine.device.type == "cpu" and sup.engine.warmed_up
    dead = chaos.monkeys[0].engine
    assert dead is not sup.engine and dead._pools == []


def test_crash_loop_breaker_stays_crashed(pair):
    """More than ``max_restarts`` crashes in the window trip the breaker:
    pending work fails with the crash-loop message, health reports
    ``restarts_exhausted``, submit refuses."""
    cfg = pair[2]
    sup = _sup(pair, max_restarts=1, restart_window_s=60.0)
    sup.warmup()
    chaos = tserving.SupervisedChaos(
        sup, arm=lambda m: m.crash_after_steps(0))
    p = _prompts(SEED + 1, 1, cfg)[0]
    req = sup.submit(p, max_new_tokens=4)
    sup.run_until_idle()
    assert chaos.injected["crash"] == 2  # crash, restart, crash
    assert sup.broken and sup.restarts == 1
    assert req.status == "failed"
    assert req.error.startswith(
        "engine crash-loop: restart budget exhausted (1 restarts in 60.0s); "
        "last crash: ChaosError(")
    code, payload = sup.health()
    assert code == 503 and payload["status"] == "crashed"
    assert payload["restarts_exhausted"] is True
    assert payload["supervisor"]["broken"] is True
    with pytest.raises(RuntimeError, match="crashed"):
        sup.submit(p, max_new_tokens=4)


def _poison_run(pkg, sup, cfg):
    """One poison among three innocents on an idle supervisor of ``pkg``
    (two quarantine crashes, three restarts: the defaults)."""
    prompts = _prompts(SEED + 2, 4, cfg)
    poison_prompt, poison_spec = prompts[0], dict(max_new_tokens=8)
    fp = pkg.request_fingerprint(np.asarray(poison_prompt, np.int32),
                                 pkg.SamplingParams(**poison_spec))
    assert (sup.quarantine_crashes, sup.max_restarts) == (2, 3)
    sup.warmup()
    chaos = pkg.SupervisedChaos(sup, arm=lambda m: m.poison_fingerprint(fp))
    poison = sup.submit(poison_prompt, **poison_spec)
    reqs = [sup.submit(p, **s) for p, s in zip(prompts[1:], SPECS[1:])]
    sup.run_until_idle()
    with pytest.raises(pkg.PoisonedRequestError) as ei:
        sup.submit(poison_prompt, **poison_spec)
    st = sup.supervisor_stats()
    return {
        "fp": fp, "fired": chaos.injected["poison"],
        "restarts": sup.restarts, "broken": sup.broken,
        "poison": (poison.status, poison.error),
        "quarantined": sup.quarantined,
        "refused_fp": ei.value.fingerprint, "refused_msg": str(ei.value),
        "innocents": [(r.status, list(r.output_tokens)) for r in reqs],
        "implicated": st["implicated"],
        "quarantine": [(q["fingerprint"], q["crashes"], q["last_error"])
                       for q in st["quarantine"]],
        "engines": len(chaos.monkeys),
    }


def test_poison_quarantined_as_the_jax_supervisor_does(pair, jax_ref):
    """The same poison run in both packages gives the same verdicts: two
    firings (the co-running crash, then the solo probe's), two restarts,
    the poison failed with the marker and the fingerprint, the same
    implicated counts and quarantine record, the resubmit refused with
    the same message, the innocents completed with equal tokens."""
    got = _poison_run(tserving, _sup(pair), pair[2])
    want = _poison_run(jserving, jax_ref["sup"], pair[2])
    assert got == want
    assert POISON_MARKER == JPOISON
    assert got["fired"] == 2 and got["restarts"] == 2 and not got["broken"]
    assert got["poison"][0] == "failed"
    assert POISON_MARKER in got["poison"][1] and got["fp"] in got["poison"][1]
    assert got["quarantined"] == [got["fp"]]
    assert got["refused_fp"] == got["fp"]
    assert all(s == "completed" for s, _ in got["innocents"])
    assert got["quarantine"][0][1] == 2


def _admission_trace(eng, prompts):
    """Which requests sit in the slots after each step, for an idle
    ``eng`` that is handed a quarantine probe and a request behind it."""
    reqs = [eng.submit(prompts[0], max_new_tokens=6)]
    eng.step()
    probe = eng.submit(prompts[1], max_new_tokens=4)
    probe.quarantine_probe = True
    reqs += [probe, eng.submit(prompts[2], max_new_tokens=3)]
    idx = {r.id: i for i, r in enumerate(reqs)}
    trace = []
    for _ in range(40):
        eng.step()
        trace.append(sorted(idx[r.id] for r in eng._slot_req
                            if r is not None))
        if all(r.status == "completed" for r in reqs):
            break
    return trace, [list(r.output_tokens) for r in reqs]


def test_quarantine_probe_is_admitted_alone(pair, jax_ref):
    """A probe that finds a busy slot waits at the queue front and holds
    the request behind it; once the pool is idle it runs alone, and the
    request behind it is admitted only after it: step for step as the
    JAX engine admits them, with the same tokens."""
    prompts = _prompts(SEED + 5, 3, pair[2])
    got = _admission_trace(
        tserving.ServingEngine(pair[1], device="cpu", **KW), prompts)
    want = _admission_trace(jax_ref["sup"].engine, prompts)
    assert got == want
    trace = got[0]
    assert [0] in trace and [1] in trace and [2] in trace
    assert not any(1 in s and len(s) > 1 for s in trace)  # probe alone
    first_probe = trace.index([1])
    last_r0 = max(i for i, s in enumerate(trace) if 0 in s)
    assert last_r0 < first_probe                    # waited for an idle pool
    last_probe = max(i for i, s in enumerate(trace) if 1 in s)
    assert all(2 not in s for s in trace[:last_probe + 1])  # held behind


def test_stats_and_health_keys_equal_the_jax_supervisor(pair, jax_ref):
    sup = _sup(pair)
    sup.warmup()
    assert sorted(sup.supervisor_stats()) == \
        sorted(jax_ref["supervisor_stats"])
    assert sorted(sup.stats()["supervisor"]) == \
        sorted(jax_ref["stats"]["supervisor"])
    code, payload = sup.health()
    jcode, jpayload = jax_ref["health"]
    assert code == jcode == 200
    assert sorted(payload["supervisor"]) == sorted(jpayload["supervisor"])
    want = {k: v for k, v in jax_ref["supervisor_stats"].items()
            if k != "implicated"}
    assert {k: v for k, v in sup.supervisor_stats().items()
            if k != "implicated"} == want
    with pytest.raises(ValueError, match="max_restarts"):
        _sup(pair, max_restarts=0)
    with pytest.raises(ValueError, match="quarantine_crashes"):
        _sup(pair, quarantine_crashes=0)


def test_http_answers_quarantined_with_400(pair):
    """A fingerprint quarantined by a supervisor behind the HTTP front
    end answers 400 with ``quarantined``, its fingerprint and
    ``retriable`` false; an innocent still completes."""
    cfg = pair[2]
    prompts = _prompts(SEED + 6, 2, cfg)
    spec = dict(max_new_tokens=4)
    fp = _fp(prompts[0], spec)
    sup = _sup(pair, quarantine_crashes=1)
    sup.warmup()
    tserving.SupervisedChaos(sup, arm=lambda m: m.poison_fingerprint(fp))
    first = sup.submit(prompts[0], **spec)
    sup.run_until_idle()
    assert first.status == "failed" and POISON_MARKER in first.error
    srv = tserving.ServingHTTPServer(sup, port=0)
    base = f"http://127.0.0.1:{srv.port}/generate"
    try:
        body = json.dumps({"prompt": [int(t) for t in prompts[0]],
                           **spec}).encode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(base, data=body),
                                   timeout=30)
        assert ei.value.code == 400
        rec = json.loads(ei.value.read())
        assert set(rec) == {"error", "quarantined", "fingerprint",
                            "retriable"}
        assert rec["quarantined"] is True and rec["retriable"] is False
        assert rec["fingerprint"] == fp and POISON_MARKER in rec["error"]
        body = json.dumps({"prompt": [int(t) for t in prompts[1]],
                           **spec}).encode()
        ok = json.loads(urllib.request.urlopen(
            urllib.request.Request(base, data=body), timeout=60).read())
        assert ok["status"] == "completed" and len(ok["tokens"]) == 4
    finally:
        srv.stop()
        sup.stop()
