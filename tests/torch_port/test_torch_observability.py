"""The port's observability stack against the JAX package's: the same
operations on a fresh registry of each give byte-equal Prometheus text,
the reader round-trips it, the tracers record the same events and render
the same Chrome trace (timestamps aside), the digests give the same
quantiles, and the traceparent parser gives the same answer on hostile
and valid headers. No model runs here."""

import json
import os
import sys
import threading
import urllib.request

import numpy as np
import pytest

from paddle_tpu.observability import exporters as jexp
from paddle_tpu.observability import fleet as jfleet
from paddle_tpu.observability import metrics as jmet
from paddle_tpu.observability import tracing as jtr

from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.observability import exporters as texp
from paddle_tpu_torch.observability import fleet as tfleet
from paddle_tpu_torch.observability import metrics as tmet
from paddle_tpu_torch.observability import tracing as ttr

PACKAGES = {"jax": (jmet, jexp, jtr, jfleet),
            "torch": (tmet, texp, ttr, tfleet)}

# tests/test_serving.py's hostile traceparent headers, and odd types
HOSTILE = ["", " ", "garbage", "00", "00-", "00-ab-cd-01",
           "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
           "00-" + "AB" * 16 + "-" + "cd" * 8 + "-01",
           "00-" + "0" * 32 + "-" + "cd" * 8 + "-01",
           "00-" + "ab" * 16 + "-" + "0" * 16 + "-01",
           "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01-extra",
           "\x01\x02bin", "0" * 2048, None, 7, b"00-ab", ["00"]]


def _script(met):
    """One sequence of instrument operations on a fresh registry: every
    kind, labels by position and by name, help and label values that
    need escaping, a custom-bucket histogram, a summary with samples."""
    reg = met.MetricsRegistry()
    c = reg.counter("app_requests_total", 'requests "served"\nby outcome',
                    ("outcome", "route"))
    c.labels("completed", "/generate").inc()
    c.labels(outcome="failed", route='a"b\\c\nd').inc(3)
    c.labels("completed", "/generate").inc(2.5)
    reg.counter("app_plain_total", "no labels").inc(7)
    g = reg.gauge("app_depth", "queue depth")
    g.set(5)
    g.inc(2)
    g.dec(0.5)
    reg.gauge("app_big", "a large value").set(2 ** 60)
    reg.gauge("app_neg", "negative infinity").set(float("-inf"))
    h = reg.histogram("app_step_seconds", "step wall",
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.01, 0.05, 0.5, 3.0, 0.1):
        h.observe(v)
    hl = reg.histogram("app_lat_seconds", "latency by kind", ("kind",))
    hl.labels("prefill").observe(0.3)
    hl.labels("decode").observe(0.003)
    s = reg.summary("app_ttft_seconds", "ttft digest")
    for v in np.random.RandomState(3).exponential(0.2, 50):
        s.observe(float(v))
    reg.summary("app_empty_seconds", "no samples yet")
    return reg


def test_prometheus_text_byte_equal():
    texts = {k: m[1].prometheus_text(_script(m[0]))
             for k, m in PACKAGES.items()}
    assert texts["torch"] == texts["jax"]
    assert texts["torch"].count("# TYPE") == 9


def test_parse_prometheus_text_round_trip():
    text = texp.prometheus_text(_script(tmet))
    fams = texp.parse_prometheus_text(text)
    assert fams == jexp.parse_prometheus_text(text)
    assert fams["app_requests_total"]["help"] == 'requests "served"\nby outcome'
    assert fams["app_ttft_seconds"]["type"] == "summary"
    odd = [s for s in fams["app_requests_total"]["samples"]
           if s["labels"]["outcome"] == "failed"]
    assert odd[0]["labels"]["route"] == 'a"b\\c\nd' and odd[0]["value"] == 3
    # parse -> render -> parse keeps every family, kind and sample
    again = texp.parse_prometheus_text(texp.render_families(fams))
    assert again == fams
    assert texp.render_families(fams) == jexp.render_families(fams)


def test_collect_and_snapshot_values():
    regs = {k: _script(m[0]) for k, m in PACKAGES.items()}
    assert regs["torch"].collect() == regs["jax"].collect()
    reg = regs["torch"]
    assert reg.get("app_depth").value() == 6.5
    with pytest.raises(ValueError):
        reg.gauge("app_plain_total")          # registered as a counter
    with pytest.raises(ValueError):
        reg.get("app_requests_total").labels("only-one")
    assert reg.counter("app_plain_total") is reg.get("app_plain_total")


@pytest.mark.parametrize("kind", ["counter", "histogram", "summary"])
def test_instruments_exact_under_threads(kind):
    """More writer threads than cores, switching every microsecond, lose
    nothing: the lock-free writers (a deque append each) fold into exact
    totals, and a reader folding meanwhile changes none of them."""
    reg = tmet.MetricsRegistry()
    n_threads, n = 2 * (os.cpu_count() or 8), 3000
    if kind == "counter":
        m = reg.counter("t_total", "", ("who",))
        write = lambda i: m.labels(str(i % 2)).inc()  # noqa: E731
    elif kind == "histogram":
        m = reg.histogram("t_seconds", "", buckets=(0.5,))
        write = lambda i: m.observe(0.25 if i % 2 else 0.75)  # noqa: E731
    else:
        m = reg.summary("t_summary", "", window=n_threads * n)
        write = lambda i: m.observe(float(i))  # noqa: E731
    start = threading.Barrier(n_threads)

    def worker():
        start.wait()
        for i in range(n):
            write(i)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n
    if kind == "counter":
        assert m.labels("0").value() + m.labels("1").value() == total
        assert m.labels("0").value() == total / 2
    elif kind == "histogram":
        counts, s, c = m._d().snapshot()
        assert c == total and counts == [total // 2, total // 2]
        assert s == pytest.approx(0.5 * total)
    else:
        assert len(m._d()._q) == total
        assert m.quantile(0.5) == pytest.approx((n - 1) / 2)


@pytest.mark.parametrize("window", [4096, 16])
def test_digest_quantiles_equal(window):
    xs = np.random.RandomState(5).lognormal(0.0, 1.0, 200).tolist()
    dj, dt = jtr.Digest(window), ttr.Digest(window)
    for v in xs:
        dj.observe(v)
        dt.observe(v)
    assert dt.percentiles() == dj.percentiles()
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert dt.quantile(q) == dj.quantile(q)
    tail = xs[-window:]
    assert dt.quantile(0.95) == pytest.approx(np.percentile(tail, 95))
    s = tmet.MetricsRegistry().summary("d", "", window=window)
    for v in xs:
        s.observe(v)
    assert s.quantile(0.95) == dt.quantile(0.95)


def _record(tr, trace):
    """The same spans and instants through one tracer: a root span with
    a nested lexical span, an instant under a trace context, a span
    closed on another thread, a complete event, an idempotent end."""
    root = tr.begin_span("request", cat="request", trace=trace,
                         args={"prompt_len": 4})
    with tr.trace_context(trace):
        with tr.span("prefill", cat="request", args={"chunk": 0}):
            tr.instant("admitted", cat="request", args={"slot": 1})
        assert tr.current_trace() == trace
    assert tr.current_trace() is None
    sp = tr.begin_span("decode", cat="request", trace=trace)
    t = threading.Thread(target=tr.end_span, args=(sp,),
                         kwargs={"args": {"tokens": 3}})
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    tr.end_span(sp)                               # already ended: skipped
    tr.complete("serving.step", "engine", trace, 1000, 250,
                {"active": 2})
    tr.instant("completed", cat="request", trace=trace,
               args={"generated": 3})
    tr.end_span(root, args={"status": "completed"})


def _shape(ev):
    return {k: v for k, v in ev.items()
            if k not in ("ts", "dur", "ts_ns", "dur_ns", "pid", "tid")}


def test_tracers_record_the_same_events_and_chrome_trace():
    out = {}
    for name, (_, _, tr, _) in PACKAGES.items():
        trace = f"parity-{name}"
        _record(tr, trace)
        evs = tr.events(trace=trace)
        ct = tr.chrome_trace(trace)
        out[name] = (evs, ct, trace)
    (jevs, jct, jt), (tevs, tct, tt) = out["jax"], out["torch"]
    assert [_shape(e) for e in tevs] == \
        [dict(_shape(e), trace=tt) for e in jevs]
    assert [e["name"] for e in tevs] == [
        "serving.step", "request", "prefill", "admitted", "decode",
        "completed"]
    lanes = lambda ct, t: [  # noqa: E731
        dict(_shape(e), **({"args": {"name": "LANE"}}
                           if e.get("args") == {"name": t} else {}))
        for e in ct["traceEvents"]]
    assert lanes(tct, tt) == lanes(jct, jt)
    # the root span holds its children; the tid of the decode span is
    # the opening thread's
    root = next(e for e in tevs if e["name"] == "request")
    for e in tevs:
        if e["cat"] == "request":
            assert root["ts_ns"] <= e["ts_ns"] <= root["ts_ns"] + \
                root["dur_ns"]
    assert ttr.span_counts()["request"] >= 1
    summ = ttr.summary()
    assert set(summ) == set(jtr.summary())
    assert summ["events_recorded"] >= len(tevs)


def test_disable_records_nothing():
    trace = "disabled"
    tobs.disable()
    try:
        assert not ttr.tracing_enabled()
        assert ttr.begin_span("x", trace=trace) is None
        ttr.instant("y", trace=trace)
        ttr.end_span(None)
    finally:
        tobs.enable()
    ttr.disable_tracing()
    try:
        ttr.complete("z", "engine", trace, 0, 1)
    finally:
        ttr.enable_tracing()
    assert ttr.events(trace=trace) == []
    assert tobs.enabled() and ttr.tracing_enabled()


@pytest.mark.parametrize("header", HOSTILE, ids=repr)
def test_parse_traceparent_hostile(header):
    assert tfleet.parse_traceparent(header) is None
    assert jfleet.parse_traceparent(header) is None


@pytest.mark.parametrize("rid,gen", [(0, 0), (4242, 1), (2 ** 127, 7),
                                     (-1, 2 ** 64)])
def test_traceparent_round_trip(rid, gen):
    tid = tfleet.attempt_trace_id(rid, gen)
    assert tid == jfleet.attempt_trace_id(rid, gen)
    header = tfleet.traceparent_of(tid)
    assert header == jfleet.traceparent_of(tid)
    assert tfleet.parse_traceparent(header) == tid
    assert tfleet.parse_traceparent(" " + header + "\n") == \
        jfleet.parse_traceparent(" " + header + "\n")
    assert tfleet.traceparent_of("not-a-trace-id") is None


def test_sinks_rotation_and_flight_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SINK_DIR", str(tmp_path / "sink"))
    assert texp.resolve_sink_path("a.jsonl") == \
        str(tmp_path / "sink" / "a.jsonl")
    assert texp.resolve_sink_path("/abs/b.jsonl") == "/abs/b.jsonl"
    sink = texp.RotatingJsonlSink("rot.jsonl", max_bytes=200)
    for i in range(20):
        sink.write({"i": i, "pad": "x" * 20})
    sink.close()
    assert os.path.getsize(sink.path) <= 200
    assert os.path.exists(sink.path + ".1")
    reg = _script(tmet)
    path = str(tmp_path / "snap.jsonl")
    texp.write_jsonl_snapshot(path, reg, extra={"run": 1})
    texp.write_jsonl_snapshot(path, reg)
    lines = open(path).read().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])["run"] == 1
    ttr.register_state_provider("probe", lambda: {"depth": 3})
    ttr.register_state_provider("broken", lambda: 1 / 0)
    try:
        ttr.instant("before_dump", trace="dump")
        dump = ttr.flight_dump("unit_test")
    finally:
        ttr.unregister_state_provider("probe")
        ttr.unregister_state_provider("broken")
    assert dump.startswith(str(tmp_path / "sink"))
    rec = json.load(open(dump))
    assert rec["reason"] == "unit_test"
    assert rec["state"]["probe"] == {"depth": 3}
    assert "ZeroDivisionError" in rec["state"]["broken"]["error"]
    assert any(e["name"] == "before_dump" for e in rec["events"])
    assert ttr.last_flight_dump() == dump
    out = ttr.export_jsonl("trace.jsonl", trace="dump")
    assert json.loads(open(out).readline())["name"] == "before_dump"
    chrome = ttr.export_chrome_trace("trace.json", trace="dump")
    assert json.load(open(chrome))["traceEvents"]


def test_flight_dump_defaults_to_the_temp_dir(monkeypatch, tmp_path):
    import tempfile

    monkeypatch.delenv("PADDLE_TPU_SINK_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = ttr.flight_dump("tmp_default")
    assert os.path.dirname(path) == str(tmp_path)


def test_scrape_server_and_snapshot():
    from paddle_tpu_torch.serving import metrics as sm

    port = texp.start_http_server(port=0)
    try:
        assert texp.start_http_server(port=0) == port   # one per process
        base = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(f"{base}/metrics", timeout=10) \
            .read().decode()
        fams = texp.parse_prometheus_text(text)
        assert fams["paddle_tpu_serving_ttft_summary_seconds"]["type"] \
            == "summary"
        health = json.loads(urllib.request.urlopen(
            f"{base}/healthz", timeout=10).read())
        assert set(health) == {"status", "ts", "serving_queue_depth",
                               "serving_slots_busy",
                               "serving_slot_occupancy",
                               "serving_engine_crashes"}
        assert health["serving_queue_depth"] == sm.queue_depth.value()
        snap = json.loads(urllib.request.urlopen(
            f"{base}/snapshot", timeout=10).read())
        assert set(snap) == {"ts", "metrics", "serving", "tracing"}
        assert "paddle_tpu_serving_slots_busy" in snap["serving"]["gauges"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=10)
        assert ei.value.code == 404
    finally:
        texp.stop_http_server()
    snap = tobs.snapshot()
    assert snap["tracing"]["enabled"] is True
    assert "paddle_tpu_serving_requests_total" in snap["metrics"]
