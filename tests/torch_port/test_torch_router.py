"""The port's multi-replica router against the JAX package (tiny Llama,
fp32, CPU), mirroring ``tests/test_router.py``: the router's tokens equal
the JAX engine's when spread over two replicas, after a crash failover
(each token delivered once, ``on_token`` never firing for a replica the
request failed away from) and through a supervised warm restart; the
control-plane faults (malformed probes eject and a warm probe re-admits,
a stats time-out keeps the replica in rotation, a pool-exhausted storm
goes to the healthy replica), the amplification cap, cancel and deadline
races, drain, the SIGTERM drain through ``request_preemption()``, restart
pressure in the score, and ``router.stats()``'s keys against the JAX
router's.

No test sleeps to let something happen: each waits on a request's own
event (``result(timeout=)``), on a chaos counter or on a probe round,
always with a time limit of its own."""

import json
import time

import numpy as np
import pytest

from paddle_tpu import serving as jserving

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.fault_tolerance.preemption import (
    clear_preemption, request_preemption, uninstall_preemption_handler)
from torch_parity import prompt32, tiny_pair

SEED = 1234
KW = dict(max_slots=2, max_len=64, block_size=16, prefill_chunk=32)
KW["num_blocks"] = tserving.ServingConfig(**KW).default_num_blocks()


def _cases():
    """Named (prompt, sampling) cases; every test draws its requests
    from here, so one JAX engine run gives every reference."""
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.tiny()
    rng = np.random.RandomState(SEED)
    out = {}
    specs = [dict(max_new_tokens=30),
             dict(max_new_tokens=28, do_sample=True, top_k=8, seed=5),
             dict(max_new_tokens=25, do_sample=True, top_p=0.9, seed=9),
             dict(max_new_tokens=30)]
    for i, (n, s) in enumerate(zip((5, 9, 3, 12), specs)):
        out[f"spread{i}"] = (prompt32(rng, cfg, n), s)
    specs = [dict(max_new_tokens=8),
             dict(max_new_tokens=8, do_sample=True, top_k=8, seed=11),
             dict(max_new_tokens=6), dict(max_new_tokens=7),
             dict(max_new_tokens=8, do_sample=True, top_p=0.9, seed=4),
             dict(max_new_tokens=6)]
    for i, s in enumerate(specs):
        out[f"crash{i}"] = (prompt32(rng, cfg, 4 + i), s)
    for i in range(4):
        out[f"small{i}"] = (prompt32(rng, cfg, 4 + i),
                            dict(max_new_tokens=12))
    out["hang"] = (prompt32(rng, cfg, 5), dict(max_new_tokens=8))
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


@pytest.fixture(autouse=True)
def _sink(tmp_path, monkeypatch):
    """Crash and preemption paths write flight dumps: keep them in the
    test's folder."""
    monkeypatch.setenv("PADDLE_TPU_SINK_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def jax_ref(pair):
    """One JAX engine over every case (the reference tokens), then a
    JAX router over it for the ``stats()`` layout."""
    eng = jserving.ServingEngine(pair[0], **KW)
    reqs = {k: eng.submit(p, **s) for k, (p, s) in CASES.items()}
    eng.run_until_idle()
    toks = {k: list(r.output_tokens) for k, r in reqs.items()}
    router = jserving.Router([jserving.LocalReplica(eng, "r0")],
                             auto_warmup=False)
    stats = router.stats()
    router.stop()
    eng.stop()
    return {"tokens": toks, "stats": stats}


def _engine(pair, **kw):
    return tserving.ServingEngine(pair[1], device="cpu", **dict(KW, **kw))


def _submit(router, name, **kw):
    p, s = CASES[name]
    return router.submit(p, **s, **kw)


def _drive(router, rrs, timeout=60.0, probe=True):
    """Wait out router requests, running a probe round between waits
    (the deterministic stand-in for the background prober)."""
    end = time.monotonic() + timeout
    while True:
        pending = [r for r in rrs if not r.done]
        if not pending:
            return
        assert time.monotonic() < end, \
            f"requests stuck: {[r.status for r in rrs]}"
        if probe:
            router.probe_once()
        try:
            pending[0].result(timeout=0.01)
        except TimeoutError:
            pass


def _until(cond, what, timeout=30.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.002)


def test_spread_over_two_replicas(pair, jax_ref):
    """Greedy and sampled requests over two replicas: every output equal
    to the JAX engine's, and the in-flight-aware pick uses both."""
    router = tserving.Router([_engine(pair), _engine(pair)])
    names = [f"spread{i}" for i in range(4)]
    try:
        rrs = []
        for n in names:
            rrs.append(_submit(router, n))
            # the next pick must see this request in flight
            _until(lambda: rrs[-1].done or rrs[-1].output_tokens,
                   "the first token")
        _drive(router, rrs)
        for rr, n in zip(rrs, names):
            assert rr.status == "completed", rr.error
            assert rr.result(1.0) == jax_ref["tokens"][n]
        assert {rr.replica for rr in rrs} == {"r0", "r1"}
        assert all(rr.retries == 0 for rr in rrs)
    finally:
        router.stop(drain=True, timeout_s=10)


def test_crash_failover_is_bit_identical(pair, jax_ref):
    """r0 dies mid-decode: every request completes with the JAX engine's
    tokens, each delivered once (``stream``, ``on_token`` and
    ``result`` agree), r0 is ejected, amplification stays in its cap,
    and a displaced request's merged trace has a lane per attempt."""
    e1, e2 = _engine(pair), _engine(pair)
    router = tserving.Router([e1, e2], tserving.RouterConfig(
        probe_failures_to_eject=2, max_retries_per_request=2,
        unroutable_timeout_s=10.0))
    monkey = tserving.ChaosEngine(e1).crash_after_steps(2)
    names = [f"crash{i}" for i in range(6)]
    seen = {n: [] for n in names}
    try:
        rrs = [_submit(router, n, on_token=lambda r, t, n=n:
                       seen[n].append(int(t))) for n in names]
        _drive(router, rrs)
        assert monkey.injected["crash"] == 1
        for rr, n in zip(rrs, names):
            assert rr.status == "completed", rr.error
            out = rr.result(1.0)
            assert out == jax_ref["tokens"][n] == seen[n] == list(rr.stream())
        assert sum(rr.retries for rr in rrs) >= 1
        states = {r["name"]: r["state"] for r in router.replicas()}
        assert states == {"r0": "ejected", "r1": "healthy"}
        st, rc = router.stats(), router.config
        assert st["extra_attempts"] <= (rc.retry_amplification_cap
                                        * st["requests"]
                                        + rc.retry_amplification_floor)
        rr = next(r for r in rrs if r.retries)
        lanes = [ev["args"]["name"]
                 for ev in router.merged_trace(rr.id)["traceEvents"]
                 if ev.get("ph") == "M" and ev["name"] == "process_name"]
        assert f"router request {rr.id}" in lanes
        assert any("[r0]" in n for n in lanes)
        assert any("[r1]" in n for n in lanes)
    finally:
        router.stop(drain=True, timeout_s=10)


def test_on_token_never_fires_after_failover(pair, jax_ref):
    """r0's loop hangs with the request in a slot; the probe reads
    ``stalled``, ejects r0 and the request fails over to r1. Released,
    the zombie step runs on, but its tokens never reach the caller."""
    e1 = _engine(pair, stall_timeout_s=0.2)
    e2 = _engine(pair)
    router = tserving.Router([e1, e2], probe_failures_to_eject=1,
                             unroutable_timeout_s=10.0)
    monkey = tserving.ChaosEngine(e1).hang_after_steps(1)
    seen = []
    try:
        rr = _submit(router, "hang", on_token=lambda r, t: seen.append(int(t)))
        _until(lambda: monkey.injected["hang"] == 1, "the hang")
        _drive(router, [rr])
        assert rr.status == "completed"
        assert rr.replica == "r1" and rr.retries >= 1
        monkey.release()
        assert e1.drain(timeout_s=30)  # the zombie step has run out
        assert rr.output_tokens == jax_ref["tokens"]["hang"] == seen
    finally:
        monkey.release()
        router.stop(drain=True, timeout_s=10)


def test_supervised_restart_is_absorbed(pair, jax_ref):
    """r0 is an ``EngineSupervisor`` whose engine crashes mid-decode: the
    supervisor restarts it in place, the router retries nothing, and
    every request still equals the JAX engine's tokens."""
    s0 = tserving.EngineSupervisor(pair[1], device="cpu", **KW)
    s1 = tserving.EngineSupervisor(pair[1], device="cpu", **KW)
    chaos = tserving.SupervisedChaos(s0)
    chaos.current.crash_after_steps(3)
    router = tserving.Router([tserving.LocalReplica(s0, "r0"),
                              tserving.LocalReplica(s1, "r1")])
    names = [f"crash{i}" for i in range(6)]
    try:
        rrs = [_submit(router, n) for n in names]
        _drive(router, rrs)
        assert chaos.injected["crash"] == 1 and s0.restarts == 1
        for rr, n in zip(rrs, names):
            assert rr.status == "completed", rr.error
            assert rr.result(1.0) == jax_ref["tokens"][n]
        st = router.stats()
        assert st["extra_attempts"] == 0
        assert all(rr.retries == 0 for rr in rrs)
        assert {r["name"]: r["state"] for r in st["replicas"]} == \
            {"r0": "healthy", "r1": "healthy"}
    finally:
        router.stop(drain=True, timeout_s=10)


def test_malformed_probes_eject_then_readmit(pair):
    """K malformed probe payloads eject; a cold ``ok`` does not re-admit
    (the warmup gate); the real, warmed payload does."""
    chaos = tserving.ChaosReplica(tserving.LocalReplica(_engine(pair), "c0"))
    router = tserving.Router([chaos], probe_failures_to_eject=2)
    try:
        chaos.fail_probes(2, mode="malformed")
        router.probe_once()
        assert router.replicas()[0]["state"] == "healthy"
        router.probe_once()
        assert router.replicas()[0]["state"] == "ejected"
        assert chaos.injected["probe"] == 2
        chaos.fail_probes(1, mode="malformed",
                          payload={"status": "ok", "warmed_up": False})
        router.probe_once()
        assert router.replicas()[0]["state"] == "ejected"
        router.probe_once()
        assert router.replicas()[0]["state"] == "healthy"
    finally:
        router.stop(drain=True, timeout_s=10)


def test_stats_timeout_keeps_the_replica_in_rotation(pair, jax_ref):
    """A hung ``stats()`` is not a dead replica: it is cut loose after
    ``stats_timeout_s``, the replica is scored on its last-known (stale)
    load and serves."""
    chaos = tserving.ChaosReplica(tserving.LocalReplica(_engine(pair), "s0"))
    router = tserving.Router([chaos], stats_timeout_s=0.05,
                             stats_refresh_s=0.0)
    chaos.fail_stats(50, mode="timeout", hang_s=1.0)
    try:
        t0 = time.monotonic()
        rr = _submit(router, "small0")
        _drive(router, [rr])
        assert rr.status == "completed"
        assert rr.output_tokens == jax_ref["tokens"]["small0"]
        assert chaos.injected["stats"] >= 1
        row = router.replicas()[0]
        assert row["state"] == "healthy" and row["load"]["stale"]
        assert time.monotonic() - t0 < 10.0
    finally:
        router.stop(drain=True, timeout_s=10)


def test_pool_exhausted_storm_goes_to_the_healthy_replica(pair, jax_ref):
    """Submit-time ``PoolExhaustedError`` storms on p0 send the requests
    to r1; p0 stays in rotation (an admission failure is not a death)."""
    chaos = tserving.ChaosReplica(tserving.LocalReplica(_engine(pair), "p0"))
    router = tserving.Router([chaos, _engine(pair)])
    chaos.reject_submits(50, exc="pool")
    names = ["small1", "small2", "small3"]
    try:
        rrs = [_submit(router, n) for n in names]
        _drive(router, rrs)
        for rr, n in zip(rrs, names):
            assert rr.status == "completed" and rr.replica == "r1"
            assert rr.output_tokens == jax_ref["tokens"][n]
        assert chaos.injected["submit"] >= 1
        assert {r["name"]: r["state"] for r in router.replicas()}["p0"] \
            == "healthy"
    finally:
        router.stop(drain=True, timeout_s=10)


def test_amplification_cap_bounds_a_failure_storm(pair):
    """Every replica crashing: retries stop at the global cap and the
    requests fail explicitly."""
    e1 = _engine(pair)
    router = tserving.Router(
        [e1], probe_failures_to_eject=100, max_retries_per_request=50,
        retry_amplification_cap=0.5, retry_amplification_floor=2,
        retry_backoff_base_s=0.001, unroutable_timeout_s=0.5)
    tserving.ChaosEngine(e1).crash_after_steps(0)
    try:
        rrs = [_submit(router, n) for n in ("small0", "small1")]
        _drive(router, rrs, timeout=30, probe=False)
        assert all(r.status in ("failed", "expired") for r in rrs)
        st = router.stats()
        assert st["extra_attempts"] <= 0.5 * st["requests"] + 2
        assert any(r.error and ("retry" in r.error
                                or "no admitting replica" in r.error)
                   for r in rrs)
    finally:
        router.stop()


def test_cancelled_request_is_never_retried(pair):
    """Cancelled while its replica's loop hangs: the request ends
    CANCELLED with no retry."""
    e1 = _engine(pair, stall_timeout_s=30.0)
    router = tserving.Router([e1], probe_failures_to_eject=1)
    monkey = tserving.ChaosEngine(e1).hang_after_steps(1)
    try:
        rr = _submit(router, "small0")
        _until(lambda: monkey.injected["hang"] == 1, "the hang")
        rr.cancel()
        _drive(router, [rr], probe=False)
        assert rr.status == "cancelled" and rr.retries == 0
    finally:
        monkey.release()
        router.stop()


def test_deadline_expiring_in_backoff_gives_expired(pair):
    """A retry whose backoff cannot beat the deadline fails EXPIRED at
    once, not after a doomed attempt."""
    e1 = _engine(pair)
    router = tserving.Router(
        [e1], probe_failures_to_eject=100, max_retries_per_request=5,
        retry_backoff_base_s=5.0, retry_backoff_max_s=5.0,
        retry_jitter=0.0, unroutable_timeout_s=5.0)
    tserving.ChaosEngine(e1).crash_after_steps(0)
    try:
        t0 = time.monotonic()
        rr = _submit(router, "small0", deadline_s=1.0)
        _drive(router, [rr], timeout=30, probe=False)
        assert rr.status == "expired"
        assert "backoff" in rr.error or "deadline" in rr.error
        assert time.monotonic() - t0 < 5.0  # the 5 s backoff never ran
    finally:
        router.stop()


def test_drain_finishes_in_flight_and_routes_elsewhere(pair, jax_ref):
    """``drain("r0")`` with requests in flight on both replicas: they
    complete with the JAX engine's tokens, r0 ends stopped, new traffic
    lands on r1."""
    e1, e2 = _engine(pair), _engine(pair)
    router = tserving.Router([e1, e2])
    names = [f"small{i}" for i in range(4)]
    try:
        inflight = [_submit(router, n, deadline_s=30.0) for n in names]
        _until(lambda: all(r.attempts for r in inflight), "the routing")
        router.drain("r0", wait=True)
        assert e1.stopped
        assert {r["name"]: r["state"] for r in router.replicas()}["r0"] \
            == "stopped"
        rr = _submit(router, "hang")
        _drive(router, inflight + [rr], probe=False)
        for r, n in zip(inflight + [rr], names + ["hang"]):
            assert r.status == "completed", r.error
            assert r.output_tokens == jax_ref["tokens"][n]
        assert rr.replica == "r1"
        with pytest.raises(tserving.EngineStoppedError):
            e1.submit([1, 2, 3])
    finally:
        router.stop(drain=True, timeout_s=10)


def test_request_preemption_drains_the_fleet(pair, jax_ref):
    """The SIGTERM path through the preemption listener: every replica
    drains and nothing in flight is lost."""
    e1, e2 = _engine(pair), _engine(pair)
    router = tserving.Router([e1, e2])
    tserving.install_sigterm_drain(router, timeout_s=30.0)
    names = ["small0", "small1", "small2"]
    try:
        rrs = [_submit(router, n) for n in names]
        _until(lambda: all(r.attempts for r in rrs), "the routing")
        request_preemption()
        _drive(router, rrs, probe=False)
        for r, n in zip(rrs, names):
            assert r.status == "completed", r.error
            assert r.output_tokens == jax_ref["tokens"][n]
        _until(lambda: e1.stopped and e2.stopped, "the drain")
    finally:
        tserving.uninstall_sigterm_drain(router)
        clear_preemption()
        uninstall_preemption_handler()
        router.stop()


def test_restart_pressure_sheds_load(pair):
    """A replica whose supervisor block shows most of its restart budget
    spent scores worse than a clean one by ``w_restart`` times the
    pressure, gossips its quarantine, and gets no traffic."""
    e1, e2 = _engine(pair), _engine(pair)
    router = tserving.Router([e1, e2], w_ttft=0.0)
    try:
        flappy, clean = router._replicas["r0"], router._replicas["r1"]
        real_stats = flappy.client.stats

        def flapping_stats():
            st = real_stats()
            st["supervisor"] = {"max_restarts": 3, "restarts_in_window": 2,
                                "quarantined": ["deadbeef01"]}
            return st

        flappy.client.stats = flapping_stats
        now = time.perf_counter()
        flappy.load.ts = clean.load.ts = 0.0
        router._refresh_load(flappy, now)
        router._refresh_load(clean, now)
        assert flappy.load.restart_pressure == pytest.approx(2 / 3)
        assert flappy.load.quarantined_count == 1
        assert clean.load.restart_pressure == 0.0
        assert (router._score(flappy, 0.0) - router._score(clean, 0.0)
                == pytest.approx(router.config.w_restart * 2 / 3))
        assert "deadbeef01" in router._quarantined
        for n in ("small0", "small1", "small2"):
            rr = _submit(router, n)
            _drive(router, [rr], probe=False)
            assert rr.status == "completed" and rr.replica == "r1"
        with pytest.raises(ValueError, match="w_restart"):
            tserving.RouterConfig(w_restart=-0.1)
    finally:
        router.stop(drain=True, timeout_s=10)


def _layout(obj):
    """The key structure of a JSON-like value (values dropped)."""
    if isinstance(obj, dict):
        return {k: _layout(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_layout(v) for v in obj[:1]]
    return None


def test_stats_layout_equals_the_jax_router(pair, jax_ref):
    """``router.stats()`` has the JAX router's keys at every level (the
    replica row and its load block included), and its JSON encodes."""
    router = tserving.Router([tserving.LocalReplica(_engine(pair), "r0")],
                             auto_warmup=False)
    try:
        st = router.stats()
        assert _layout(st) == _layout(jax_ref["stats"])
        json.dumps(st)
        want = jax_ref["stats"]["config"]
        assert st["config"] == want
    finally:
        router.stop(drain=True, timeout_s=10)


def test_brownout_spec_cap_leaves_the_engine_default(pair, jax_ref):
    """At brownout level ``shrink_spec`` an attempt's explicit ``spec_k``
    is capped as in the JAX router; ``spec_k=None`` (the engine default)
    is left as it is, where the JAX router raises TypeError in the
    request's driver thread (ROADMAP Queue C, C8), and the request
    completes with the JAX engine's tokens."""
    from paddle_tpu.serving import router as jrouter

    from paddle_tpu_torch.serving import router as trouter

    router = tserving.Router([_engine(pair)])
    jr = jserving.Router([])
    burning = {"ok": False, "observed": 5, "objectives": {}}
    try:
        for r in (router, jr):
            for t in range(4):
                r._brownout.update(burning, now=1e9 + 10.0 * t)
            assert r._brownout.level_name == "shrink_spec"
        p = CASES["small0"][0]
        for spec_k in (3, 0):
            got = router._attempt_params(trouter.RouterRequest(
                p, tserving.SamplingParams(spec_k=spec_k), None, None))
            want = jr._attempt_params(jrouter.RouterRequest(
                p, jserving.SamplingParams(spec_k=spec_k), None, None))
            assert got.spec_k == want.spec_k == 0
        rr = trouter.RouterRequest(p, tserving.SamplingParams(), None, None)
        assert router._attempt_params(rr).spec_k is None
        with pytest.raises(TypeError):
            jr._attempt_params(jrouter.RouterRequest(
                p, jserving.SamplingParams(), None, None))
        rr = _submit(router, "small0")
        _drive(router, [rr], probe=False)
        assert rr.status == "completed"
        assert rr.output_tokens == jax_ref["tokens"]["small0"]
    finally:
        router.stop(drain=True, timeout_s=10)
        jr.stop()
