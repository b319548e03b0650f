"""The port's health states, drain and admission rules against the
JAX package's (tiny Llama, fp32, CPU): ``health()`` walks the same
states with the same codes and payload keys (ok, saturated, crashed,
stalled, draining, stopped), the live table's rows have the same keys,
a drain refuses ``submit`` and its time-out fails the stragglers
explicitly, the scheduler sheds, refuses, requeues and detaches alike,
and the request fingerprints agree."""

import threading
import time

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.serving import metrics as jsm

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving import metrics as tsm
from torch_parity import prompt32, tiny_pair

PKG = {"jax": (jserving, jsm), "torch": (tserving, tsm)}


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(max_position_embeddings=256)


@pytest.fixture(autouse=True)
def _sink(tmp_path, monkeypatch):
    """Crash paths write flight dumps: keep them in the test's folder."""
    monkeypatch.setenv("PADDLE_TPU_SINK_DIR", str(tmp_path))


def _engine(name, pair, **kw):
    jm, tm, _ = pair
    if name == "jax":
        return jserving.ServingEngine(jm, **kw)
    return tserving.ServingEngine(tm, device="cpu", **kw)


def _wait(cond, what, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, what
        time.sleep(0.005)


def _health(eng) -> tuple:
    code, payload = eng.health()
    return code, payload["status"], sorted(payload)


def test_health_states_payloads_and_debug_rows(pair):
    """ok -> saturated -> ok -> stopped (abort), crashed, then stalled ->
    draining -> stopped on a hung started engine: equal codes, statuses
    and payload keys; the live table's rows have equal keys; a draining
    engine refuses ``submit``; the aborted and drained requests end as
    the JAX ones do."""
    _, _, cfg = pair
    rng = np.random.RandomState(72)
    prompts = [prompt32(rng, cfg, 4) for _ in range(4)]
    out = {}
    for name, (srv, sm) in PKG.items():
        states = []
        # ok -> saturated (a sync engine: nothing admits) -> ok -> abort
        eng = _engine(name, pair, max_slots=1, max_len=64,
                      max_queue_depth=2)
        states.append(_health(eng))
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts[:2]]
        states.append(_health(eng))
        assert eng.health()[1]["retry_after_s"] > 0
        eng.step()                    # one admitted, one still queued
        states.append(_health(eng))
        eng.stop(abort=True)
        states.append(_health(eng))
        assert [r.status for r in reqs] == ["failed", "failed"]
        assert all("abort" in r.error for r in reqs)
        with pytest.raises(srv.EngineStoppedError, match="stopped"):
            eng.submit(prompts[0])
        with pytest.raises(srv.EngineStoppedError):
            eng.start()
        # crashed: the first loop step raises
        eng = _engine(name, pair, max_slots=1, max_len=64)
        monkey = srv.ChaosEngine(eng).crash_after_steps(0)
        req = eng.submit(prompts[0], max_new_tokens=4)
        eng.start()
        req.result(timeout=20.0)
        assert req.status == "failed" and "chaos" in req.error
        states.append(_health(eng))
        assert "chaos" in eng.health()[1]["crashed"]
        assert monkey.injected["crash"] == 1
        assert sm.engine_unhealthy.value() == 1
        with pytest.raises(RuntimeError, match="crashed"):
            eng.submit(prompts[0])
        sm.engine_unhealthy.set(0)
        # stalled -> draining -> stopped: a hung started engine
        eng = _engine(name, pair, max_slots=1, max_len=64,
                      stall_timeout_s=0.15)
        monkey = srv.ChaosEngine(eng).hang_after_steps(1)
        reqs = [eng.submit(prompts[2], max_new_tokens=10),
                eng.submit(prompts[3], max_new_tokens=3)]
        eng.start()
        # the JAX engine's first step compiles for longer than the stall
        # timeout: wait for the hang itself
        _wait(lambda: monkey.injected["hang"] == 1, name)
        _wait(lambda: eng.health()[1]["status"] == "stalled", name)
        states.append(_health(eng))
        dbg = eng.debug_requests()
        rows = (sorted(dbg["queued"][0]), sorted(dbg["running"][0]),
                dbg["running"][0]["phase"])
        drain = threading.Thread(target=eng.drain, daemon=True)
        drain.start()
        _wait(lambda: eng.draining, name)
        states.append(_health(eng))
        with pytest.raises(srv.EngineDrainingError, match="draining"):
            eng.submit(prompts[0])
        monkey.release()
        drain.join(timeout=30)
        assert not drain.is_alive()
        # the JAX drain may return while a request moves from the queue
        # to its slot (the port's reads under the step lock): wait for it
        for r in reqs:
            r.result(timeout=30.0)
        assert [r.status for r in reqs] == ["completed", "completed"]
        eng.stop()
        states.append(_health(eng))
        rows += (sorted(eng.debug_requests()["recent"][0]),)
        out[name] = (states, rows)
    assert out["torch"] == out["jax"]
    assert [s[:2] for s in out["torch"][0]] == [
        (200, "ok"), (503, "saturated"), (200, "ok"), (503, "stopped"),
        (503, "crashed"), (503, "stalled"), (503, "draining"),
        (503, "stopped")]
    assert out["torch"][1][2] == "decode"


def test_drain_timeout_fails_stragglers_explicitly(pair):
    """A hung loop (no step ever runs): ``drain(timeout_s=)`` returns
    False and fails the in-flight request with the drain-timeout error,
    in both packages."""
    _, _, cfg = pair
    p = prompt32(np.random.RandomState(71), cfg, 4)
    for name, (srv, _) in PKG.items():
        eng = _engine(name, pair, max_slots=1, max_len=64)
        monkey = srv.ChaosEngine(eng).hang_after_steps(0)
        eng.start()
        req = eng.submit(p, max_new_tokens=20)
        _wait(lambda: monkey.injected["hang"] == 1, name)
        assert eng.drain(timeout_s=0.2) is False
        req.result(timeout=5.0)
        assert req.status == "failed" and "drain timed out" in req.error
        monkey.release()
        eng.stop(abort=True)
        assert eng.stopped


def _scheduler_script(srv, sm):
    """The admission rules on requests of one package: FCFS, the shed
    rule at a full queue (the newest request of the lowest class below
    the arrival's yields), a refusal when nothing lower is queued, the
    front-of-queue requeue, cancellation, ``snapshot`` / ``detach_all``
    / ``len``; the outcome counters' deltas."""
    from importlib import import_module

    rq = import_module(srv.__name__ + ".request")
    sched = srv.Scheduler(max_queue_depth=3)
    before = {o: sm.requests_total.labels(o).value()
              for o in ("rejected", "cancelled")}
    shed0 = sm.requests_shed_total.labels("batch").value()

    def req(n, prio="interactive"):
        return rq.Request(np.arange(1, n + 1, dtype=np.int32),
                          rq.SamplingParams(max_new_tokens=2,
                                            priority=prio))

    log = []
    a, b, c = req(3, "batch"), req(4), req(5, "batch")
    for r in (a, b, c):
        sched.submit(r)
    d = req(6)                                   # full: c (batch) yields
    sched.submit(d)
    log.append((c.status, c.error.split(":")[0]))
    with pytest.raises(srv.QueueFullError):
        sched.submit(req(7, "batch"))            # nothing lower to shed
    log.append([r.prompt.shape[0] for r in sched.snapshot()])
    first = sched.pop_ready()
    first.status = "running"
    sched.requeue(first)                         # a preemption's requeue
    log.append([r.prompt.shape[0] for r in sched.snapshot()])
    log.append(sched.cancel(b))
    log.append((len(sched), sched.depth))
    out = sched.detach_all()
    log.append(([r.prompt.shape[0] for r in out], [r.status for r in out],
                len(sched), sm.queue_depth.value()))
    log.append({o: sm.requests_total.labels(o).value() - before[o]
                for o in before})
    log.append(sm.requests_shed_total.labels("batch").value() - shed0)
    return log


def test_scheduler_rules_match_jax():
    got = {name: _scheduler_script(srv, sm)
           for name, (srv, sm) in PKG.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ("rejected", "shed under queue pressure")


def test_request_fingerprint_matches_jax():
    from paddle_tpu.serving import SamplingParams as JP

    from paddle_tpu_torch.serving import SamplingParams as TP

    prompt = np.arange(3, 40, dtype=np.int32)
    for kw in ({}, {"do_sample": True, "top_p": 0.9, "seed": 7},
               {"spec_k": 0, "eos_token_id": 2}):
        assert tserving.request_fingerprint(prompt, TP(**kw)) == \
            jserving.request_fingerprint(prompt, JP(**kw))
    # priority is scheduling, not work: it leaves the fingerprint alone
    assert tserving.request_fingerprint(prompt, TP(priority="batch")) == \
        tserving.request_fingerprint(prompt, TP())
