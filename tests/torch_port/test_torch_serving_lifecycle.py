"""The port's engine lifecycle and host stack against the JAX package's
(tiny Llama, fp32, CPU): the started engines serve the same tokens
(greedy and sampled) through ``result`` / ``stream`` / ``on_token``;
the serving instruments move by the same deltas, with and without
preemption; a request's trace has the same events and arguments in the
same order; ``debug_requests()`` rows have the same keys; a synchronous
``stop()`` drains inline; ``warmup`` keeps the JAX contract; requests
exported from an engine resume on a fresh one; the port registers every
serving and router instrument of the JAX module. Health states, drain
and admission: ``test_torch_serving_health.py``."""

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.observability import tracing as jtr
from paddle_tpu.serving import metrics as jsm

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.observability import tracing as ttr
from paddle_tpu_torch.serving import metrics as tsm
from torch_parity import prompt32, tiny_pair

PKG = {"jax": (jserving, jsm, jtr), "torch": (tserving, tsm, ttr)}


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


def _counts(sm) -> dict:
    out = {f"requests_{o}": sm.requests_total.labels(o).value()
           for o in ("completed", "failed", "cancelled", "expired",
                     "rejected")}
    out.update({f"tokens_{k}": sm.tokens_total.labels(k).value()
                for k in ("prompt", "prompt_cached", "generated")})
    for name in ("prefill_chunks_total", "preemptions_total",
                 "cow_forks_total", "prefix_cache_hits",
                 "prefix_cache_misses", "steps_total"):
        out[name] = getattr(sm, name).value()
    out["ttft_count"] = sm.ttft_seconds._d().snapshot()[2]
    out["queue_wait_count"] = sm.queue_wait_seconds._d().snapshot()[2]
    return out


def _trace_rows(tr, req) -> list:
    """(ph, name, cat, args) of one request's events in time order; the
    queue wait's seconds masked, the JAX package's XLA compile events
    (no counterpart) left out."""
    rows = []
    for e in tr.events(trace=req.trace):
        if e["cat"] == "compile":
            continue
        args = dict(e.get("args") or {})
        if "wait_s" in args:
            args["wait_s"] = "t"
        rows.append((e["ph"], e["name"], e["cat"], args))
    return rows


def test_started_engines_serve_the_same_tokens(pair):
    """Greedy and sampled requests, all submitted before ``start()`` (so
    the loop runs the schedule ``run_until_idle`` would): the tokens of
    ``result()``, ``stream()`` and ``on_token`` agree with each other
    and across the packages. ``warmup()`` refuses the busy engine and,
    once idle, names the same programs."""
    _, _, cfg = pair
    rng = np.random.RandomState(31)
    prompts = [prompt32(rng, cfg, n) for n in (5, 19, 40, 9)]
    params = [dict(max_new_tokens=8),
              dict(max_new_tokens=10, do_sample=True, temperature=0.8,
                   top_k=8, seed=5),
              dict(max_new_tokens=6, do_sample=True, top_p=0.9, seed=9),
              dict(max_new_tokens=7, eos_token_id=3)]
    out = {}
    for name in PKG:
        eng = _engine(name, pair, max_slots=2, max_len=64)
        cb = {}
        reqs = [eng.submit(p, on_token=lambda r, t: cb.setdefault(
                    r.id, []).append(t), **kw)
                for p, kw in zip(prompts, params)]
        with pytest.raises(RuntimeError, match="idle"):
            eng.warmup()
        eng.start()
        streamed = list(reqs[1].stream(timeout=60.0))
        results = [r.result(timeout=60.0) for r in reqs]
        assert all(r.status == "completed" for r in reqs), name
        assert streamed == results[1]
        assert [cb[r.id] for r in reqs] == results
        info = eng.warmup()           # idle now; the loop is still up
        assert eng.warmed_up and eng.warmup()["entries"] == info["entries"]
        out[name] = (results, info["entries"], eng.stats()["steps"])
        eng.stop()
        assert eng.stopped and not eng.stats()["running"]
    assert out["torch"] == out["jax"]


def _traffic(cfg):
    rng = np.random.RandomState(21)
    shared = rng.randint(1, cfg.vocab_size, 40)
    prompts = [np.concatenate([shared, rng.randint(1, 256, 4)]),
               rng.randint(1, cfg.vocab_size, 60),
               np.concatenate([shared, rng.randint(1, 256, 9)]),
               rng.randint(1, cfg.vocab_size, 30)]
    return prompts, [30, 24, 30, 16]


@pytest.mark.parametrize("pool", ["default", "preempting"])
def test_metric_deltas_traces_and_debug_rows(pair, pool):
    """The same traffic through both engines: equal instrument deltas,
    equal per-request trace events, equal ``debug_requests`` row keys.
    The default pool is drained by a synchronous ``stop()`` (which drives
    the loop inline); the small pool preempts, and one request's trace
    holds a prefix-cache hit, a COW fork and a preemption."""
    _, _, cfg = pair
    prompts, new = _traffic(cfg)
    kw = dict(max_slots=3, max_len=128, block_size=16, prefill_chunk=32)
    kw["num_blocks"] = 11 if pool == "preempting" else \
        tserving.ServingConfig(**kw).default_num_blocks()
    out = {}
    for name, (_, sm, tr) in PKG.items():
        eng = _engine(name, pair, **kw)
        before = _counts(sm)
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
        queued_row = eng.debug_requests()["queued"][0]
        if pool == "default":
            eng.stop()
            assert eng.stopped
        else:
            eng.run_until_idle()
        assert all(r.status == "completed" for r in reqs), name
        after = _counts(sm)
        dbg = eng.debug_requests()
        out[name] = {
            "tokens": [r.output_tokens for r in reqs],
            "deltas": {k: after[k] - before[k] for k in after},
            "traces": [_trace_rows(tr, r) for r in reqs],
            "rows": (sorted(queued_row), sorted(dbg["recent"][0]),
                     len(dbg["recent"]), dbg["running"], dbg["queued"]),
            "stats": sorted(eng.stats()),
        }
    j, t = out["jax"], out["torch"]
    assert t["tokens"] == j["tokens"]
    assert t["deltas"] == j["deltas"]
    assert t["traces"] == j["traces"]
    assert t["rows"] == j["rows"]
    # the port keeps two keys of its own and has no perf ledger yet
    assert set(t["stats"]) == set(j["stats"]) - {"perf"} \
        | {"prefill_chunks", "kv_bytes_per_token"}
    d = t["deltas"]
    assert d["requests_completed"] == 4 and d["cow_forks_total"] >= 1
    assert d["tokens_generated"] == sum(new)
    names = [{row[1] for row in tr} for tr in t["traces"]]
    if pool == "preempting":
        assert d["preemptions_total"] >= 1 and d["prefix_cache_hits"] >= 1
        assert any({"prefix_cache_hit", "cow_fork", "preempted",
                    "resume"} <= n for n in names)
    else:
        assert d["preemptions_total"] == 0
    for tr in t["traces"]:
        assert [row[1] for row in tr[:2]] == ["queued", "request"]
        assert tr[-1][1] == "completed"


@pytest.mark.parametrize("lane", [{}, {"spec_k": 3}, {"spec_tree": (2, 2)}],
                         ids=["plain", "chain", "tree"])
def test_warmup_is_inert_and_idempotent(pair, lane):
    """On the port: ``warmup()`` names the programs it ran (the JAX
    entries), builds nothing on the CPU, leaves the pool, the prefix
    cache and the slots' decode state as they were, and an engine warmed
    up serves the tokens of one that was not."""
    from paddle_tpu_torch.generation import truncated_draft

    _, tm, cfg = pair
    draft = truncated_draft(tm, 1) if lane else None
    rng = np.random.RandomState(63)
    prompts = [prompt32(rng, cfg, n) for n in (6, 33)]
    outs = []
    for warm in (False, True):
        eng = tserving.ServingEngine(tm, device="cpu", draft_model=draft,
                                     max_slots=2, max_len=64, **lane)
        first = eng.submit(prompts[0], max_new_tokens=5)
        eng.run_until_idle()
        if warm:
            state = [x.clone() for x in (eng._tokens, eng._pos, eng._keys)]
            pool, cache = eng.pool.stats(), eng.prefix_cache.stats()
            info = eng.warmup()
            assert info["compiles"] == 0 and eng.warmed_up
            assert info == dict(eng.warmup(), wall_s=info["wall_s"])
            want = ["serving.prefill_chunk", "serving.cow"] + (
                ["serving.spec_draft", "serving.spec_verify"] if lane
                else ["serving.step"])
            assert info["entries"] == want
            for a, b in zip(state, (eng._tokens, eng._pos, eng._keys)):
                assert a.equal(b)
            assert eng.pool.stats() == pool
            assert eng.prefix_cache.stats() == cache
            assert eng.health()[1]["warmed_up"] is True
            assert eng.stats()["steps"] == info_steps
        else:
            info_steps = eng.stats()["steps"]
        second = eng.submit(prompts[1], max_new_tokens=9)
        eng.run_until_idle()
        outs.append((first.output_tokens, second.output_tokens))
    assert outs[0] == outs[1]


def test_port_registers_every_serving_instrument():
    """Every instrument of the JAX ``serving/metrics.py`` (the two perf
    gauges aside) exists in the port under the same name, type, help
    text and label names; the digest helpers answer alike."""
    from paddle_tpu.observability.metrics import _MetricBase as JBase

    from paddle_tpu_torch.observability.metrics import _MetricBase as TBase

    def instruments(mod, base):
        return {m.name: (m.kind, m.help, m.labelnames)
                for m in vars(mod).values() if isinstance(m, base)}

    j = instruments(jsm, JBase)
    t = instruments(tsm, TBase)
    perf = {jsm.mfu_gauge.name, jsm.hbm_bw_util_gauge.name}
    assert perf == {"paddle_tpu_mfu", "paddle_tpu_hbm_bw_util"}
    assert t == {k: v for k, v in j.items() if k not in perf}
    assert any(k.startswith("paddle_tpu_router_") for k in t)
    assert set(tsm.latency_digests()) == set(jsm.latency_digests())
    assert tsm.queue_wait_retry_after(2.5) > 0


def test_exported_inflight_requests_resume_on_a_fresh_engine(pair):
    """``_export_inflight`` (the capture a supervisor's crash hook makes)
    detaches the running requests with their resume state and the queued
    ones untouched, finishing none; requeued on a fresh engine, each
    ends with the tokens of an uninterrupted run (greedy and sampled)."""
    _, tm, cfg = pair
    rng = np.random.RandomState(81)
    prompts = [prompt32(rng, cfg, n) for n in (7, 40, 12, 9)]
    params = [dict(max_new_tokens=12),
              dict(max_new_tokens=10, do_sample=True, top_k=8, seed=2),
              dict(max_new_tokens=9), dict(max_new_tokens=6)]
    kw = dict(max_slots=2, max_len=64, block_size=16, prefill_chunk=32)

    def engine():
        return tserving.ServingEngine(tm, device="cpu", **kw)

    ref = engine()
    want = [ref.submit(p, **pk) for p, pk in zip(prompts, params)]
    ref.run_until_idle()
    eng = engine()
    reqs = [eng.submit(p, **pk) for p, pk in zip(prompts, params)]
    for _ in range(4):
        eng.step()
    with eng._step_lock:
        running, queued = eng._export_inflight()
    assert running and queued and not eng.busy_slots() and not len(
        eng.scheduler)
    assert all(not r.done for r in running + queued)
    assert all(r._resume is not None for r in running if r.output_tokens)
    assert "captured" in [e["name"] for e in ttr.events(trace=running[0].trace)]
    fresh = engine()
    for r in reversed(running):
        fresh.scheduler.requeue(r)
    for r in queued:
        fresh.scheduler.submit(r)
    fresh.run_until_idle()
    assert [r.output_tokens for r in reqs] == [r.output_tokens for r in want]
    assert all(r.status == "completed" for r in reqs)

