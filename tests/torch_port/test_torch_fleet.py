"""The port's fleet observability plane against the JAX package's
(``observability/fleet.py``): the same inputs through both modules give
equal results. ``merge_catapult`` and ``mad_zscores`` on the shapes
``tests/test_fleet_obs.py`` uses; ``SLOTracker.report`` and
``BrownoutController`` on injected clocks (both windows, cancelled
requests left out, the TTFT bound, the ladder and its hysteresis);
``FleetMetricsAggregator.render`` byte for byte on the same expositions
(relabelling, roll-ups, the count-weighted summary merge, staleness,
``forget``). No engine runs here."""

import json
import time

import pytest

from paddle_tpu.observability import fleet as jfleet

from paddle_tpu_torch.observability import exporters as texporters
from paddle_tpu_torch.observability import fleet as tfleet

FLEETS = {"jax": jfleet, "torch": tfleet}


def _both(fn):
    """``fn(module)`` for each package; asserts the results are equal
    and returns the port's."""
    out = {k: fn(m) for k, m in FLEETS.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


# ---------------------------------------------------------------------------
# merge_catapult
# ---------------------------------------------------------------------------

_LANE_A = {"traceEvents": [
    {"name": "process_name", "ph": "M", "pid": 77, "tid": 0,
     "args": {"name": "orig"}},
    {"name": "process_name", "ph": "M", "pid": 77, "tid": 1,
     "args": {"name": "dup"}},
    {"name": "s", "ph": "X", "pid": 77, "tid": 1, "ts": 0, "dur": 5,
     "cat": "c", "args": {}}]}
_LANE_B = {"traceEvents": [
    {"name": "t", "ph": "X", "pid": 99, "tid": 2, "ts": 1, "dur": 2,
     "cat": "c", "args": {}},
    {"name": "i", "ph": "i", "pid": 99, "tid": 2, "ts": 3, "s": "t",
     "cat": "c", "args": {"k": 1}}]}

MERGES = {
    "two_lanes": [("router", _LANE_A), ("attempt 1 [r0]", _LANE_B)],
    "one_lane": [("lane", _LANE_A)],
    "empty_part": [("router", {}), ("attempt 1 [r1]", {"traceEvents": []})],
    "none": [],
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_merge_catapult(case):
    parts = MERGES[case]
    before = json.dumps(parts, sort_keys=True)
    merged = _both(lambda m: m.merge_catapult(parts))
    assert json.dumps(parts, sort_keys=True) == before  # inputs untouched
    assert json.loads(json.dumps(merged)) == merged
    assert {ev["pid"] for ev in merged["traceEvents"]} \
        == set(range(len(parts)))


# ---------------------------------------------------------------------------
# mad_zscores
# ---------------------------------------------------------------------------

ZSCORES = {
    "empty": [],
    "identical": [3.0, 3.0, 3.0],
    "twins_and_one_straggler": [1.0, 1.0, 1.0, 1.0, 10.0],
    "spread": [1.0, 1.1, 0.9, 1.05, 0.95, 8.0],
    "fast_outlier": [1.0, 1.0, 1.0, 1.0, 0.1],
    "two": [0.02, 0.05],
}


@pytest.mark.parametrize("case", sorted(ZSCORES))
def test_mad_zscores(case):
    zs = _both(lambda m: m.mad_zscores(ZSCORES[case]))
    if case in ("twins_and_one_straggler", "spread"):
        assert zs[-1] > 3.5 and all(abs(z) < 3.5 for z in zs[:-1])
    if case == "fast_outlier":
        assert zs[-1] < 0


# ---------------------------------------------------------------------------
# SLOTracker
# ---------------------------------------------------------------------------

def _report(m, script, **cfg):
    """Run ``script`` — (advance seconds, status, ttft, met, repeat)
    rows — on a tracker of ``m`` with an injected clock; the report at
    the end."""
    cfg.setdefault("fast_window_s", 1.0)
    cfg.setdefault("slow_window_s", 10.0)
    clock = {"t": 1000.0}
    tr = m.SLOTracker(m.SLOConfig(**cfg), clock=lambda: clock["t"])
    for dt, status, ttft, met, n in script:
        clock["t"] += dt
        for _ in range(n):
            tr.observe(status, ttft_s=ttft, met_deadline=met)
    return tr.report()


SLO_SCRIPTS = {
    "all_good": ([(0, "completed", 0.01, True, 20)], {}),
    # a fast-window blip after a long good run: fast burns, slow does not
    "blip_needs_both_windows": ([(0, "completed", 0.01, True, 1000),
                                 (9.5, "failed", None, False, 5)], {}),
    "sustained_failures": ([(0, "failed", None, False, 20)], {}),
    "cancelled_excluded": ([(0, "cancelled", None, False, 10)], {}),
    "ttft_bound": ([(0, "completed", 5.0, True, 10)],
                   {"ttft_p95_s": 0.1}),
    "expired_and_slow_window": ([(0, "completed", 0.02, True, 30),
                                 (2.0, "expired", 0.3, False, 8),
                                 (12.0, "completed", 0.01, True, 4)], {}),
}


@pytest.mark.parametrize("case", sorted(SLO_SCRIPTS))
def test_slo_tracker_report(case):
    script, cfg = SLO_SCRIPTS[case]
    rep = _both(lambda m: _report(m, script, **cfg))
    if case == "blip_needs_both_windows":
        avail = rep["objectives"]["availability"]
        assert avail["windows"]["fast"]["burn_rate"] >= 14.4
        assert avail["ok"] and rep["ok"]
    if case == "sustained_failures":
        assert not rep["ok"]
        assert rep["objectives"]["ttft_p95"]["windows"]["fast"]["total"] == 0
    if case == "cancelled_excluded":
        assert rep["observed"] == 0 and rep["ok"]
    if case == "ttft_bound":
        assert not rep["objectives"]["ttft_p95"]["ok"]


@pytest.mark.parametrize("kw", [{"availability": 1.0},
                                {"goodput_floor": 0.0},
                                {"fast_window_s": 60.0,
                                 "slow_window_s": 30.0}])
def test_slo_config_validation(kw):
    for m in FLEETS.values():
        with pytest.raises(ValueError):
            m.SLOConfig(**kw)


# ---------------------------------------------------------------------------
# BrownoutController
# ---------------------------------------------------------------------------

BAD = {"ok": False, "observed": 10,
       "objectives": {"availability": {"ok": False},
                      "goodput": {"ok": True}}}
GOOD = {"ok": True, "observed": 10, "objectives": {}}
IDLE = {"ok": False, "observed": 0, "objectives": {}}

# (time, report) ticks: escalations one per dwell, an idle fleet counted
# healthy, recovery only after a streak, dwell-limited both ways
LADDER = [(0.0, BAD), (0.5, BAD), (2.0, BAD), (4.0, BAD), (6.0, BAD),
          (8.0, BAD), (8.5, IDLE), (9.0, GOOD), (9.5, GOOD), (10.0, GOOD),
          (10.5, GOOD), (11.0, GOOD), (11.5, GOOD), (20.0, None),
          (21.0, BAD), (30.0, GOOD)]


@pytest.mark.parametrize("max_level", [None, 2])
def test_brownout_ladder_and_hysteresis(max_level):
    def run(m):
        bc = m.BrownoutController(recover_reports=3, min_dwell_s=2.0,
                                  max_level=max_level, clock=lambda: 0.0)
        levels = [bc.update(rep, now=t) for t, rep in LADDER]
        return levels, (bc.shed_batch, bc.hedge_disabled,
                        bc.cap_batch_tokens, bc.shrink_spec), bc.report()

    levels, actions, report = _both(run)
    assert max(levels) == (4 if max_level is None else 2)
    assert report["levels"] == list(tfleet.BROWNOUT_LEVELS)
    assert tfleet.BROWNOUT_LEVELS == jfleet.BROWNOUT_LEVELS


def test_brownout_rejects_zero_streak():
    for m in FLEETS.values():
        with pytest.raises(ValueError):
            m.BrownoutController(recover_reports=0)


# ---------------------------------------------------------------------------
# FleetMetricsAggregator
# ---------------------------------------------------------------------------

def _exposition(reqs, goodput, util, p50, count):
    """A replica exposition with every family kind the roll-ups branch
    on (``tests/test_fleet_obs.py``'s shape)."""
    return f"""\
# HELP paddle_tpu_serving_requests_total serving requests by outcome
# TYPE paddle_tpu_serving_requests_total counter
paddle_tpu_serving_requests_total{{outcome="completed"}} {reqs}
paddle_tpu_serving_requests_total{{outcome="failed"}} {reqs // 10}
# TYPE paddle_tpu_serving_goodput_tokens_per_second gauge
paddle_tpu_serving_goodput_tokens_per_second {goodput}
# TYPE paddle_tpu_serving_slot_occupancy gauge
paddle_tpu_serving_slot_occupancy {util}
# TYPE paddle_tpu_serving_ttft_seconds histogram
paddle_tpu_serving_ttft_seconds_bucket{{le="0.1"}} {count}
paddle_tpu_serving_ttft_seconds_bucket{{le="+Inf"}} {count}
paddle_tpu_serving_ttft_seconds_sum {p50 * count}
paddle_tpu_serving_ttft_seconds_count {count}
# TYPE paddle_tpu_serving_tpot_summary_seconds summary
paddle_tpu_serving_tpot_summary_seconds{{quantile="0.5"}} {p50}
paddle_tpu_serving_tpot_summary_seconds{{quantile="0.95"}} {p50 * 2}
paddle_tpu_serving_tpot_summary_seconds_sum {p50 * count}
paddle_tpu_serving_tpot_summary_seconds_count {count}
# TYPE paddle_tpu_router_replica_healthy gauge
paddle_tpu_router_replica_healthy{{replica="inner"}} 1
"""


def _fed(m, steps):
    agg = m.FleetMetricsAggregator()
    for step in steps:
        getattr(agg, step[0])(*step[1:])
    return agg


R0 = ("update", "r0", _exposition(10, 100.0, 0.5, 0.010, 10), 1.0)
R1 = ("update", "r1", _exposition(30, 300.0, 0.9, 0.030, 30), 1.0)
R2 = ("update", "r2", _exposition(0, 0.0, 0.0, 0.0, 0), 2.0)
FEDERATIONS = {
    "two_replicas": [R0, R1],
    "three_with_idle": [R0, R1, R2],
    "stale": [R0, R1, ("mark_stale", "r1")],
    "forget": [R0, R1, ("forget", "r0")],
    "rescrape": [R0, R1, ("update", "r0",
                          _exposition(12, 90.0, 0.4, 0.02, 14), 3.0)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(FEDERATIONS))
def test_federated_render_byte_for_byte(case, monkeypatch):
    """The same scrapes give the same exposition text, byte for byte
    (the scrape-age gauge reads a pinned clock)."""
    monkeypatch.setattr(time, "perf_counter", lambda: 5.0)
    steps = FEDERATIONS[case]
    text = _both(lambda m: _fed(m, steps).render())
    _both(lambda m: _fed(m, steps).federated_families())
    _both(lambda m: _fed(m, steps).stats())
    fams = texporters.parse_prometheus_text(text)
    if case == "forget":
        reps = {s["labels"]["replica"] for s in
                fams["paddle_tpu_serving_requests_total"]["samples"]}
        assert reps == {"r1", "fleet"}
    if case == "stale":
        stale = {s["labels"]["replica"]: s["value"] for s in
                 fams["paddle_tpu_fleet_scrape_stale"]["samples"]}
        assert stale == {"r0": 0, "r1": 1}
    if case == "two_replicas":
        q = [s for s in
             fams["paddle_tpu_serving_tpot_summary_seconds"]["samples"]
             if s["labels"] == {"replica": "fleet", "quantile": "0.5"}]
        assert q[0]["value"] == pytest.approx(0.025)  # count-weighted


def test_should_scrape_claims_the_window():
    def run(m):
        agg = m.FleetMetricsAggregator()
        return [agg.should_scrape("r0", now=t, refresh_s=1.0)
                for t in (10.0, 10.5, 11.5, 11.6)]

    assert _both(run) == [True, False, True, False]


def test_fleet_exports():
    """The port's ``observability`` package exports the fleet names the
    JAX one does, and its ``fleet`` module every name of the JAX
    module's ``__all__``."""
    from paddle_tpu import observability as jobs

    from paddle_tpu_torch import observability as tobs

    assert set(jfleet.__all__) <= set(tfleet.__all__)
    for name in ("FleetMetricsAggregator", "SLOConfig", "SLOTracker",
                 "mad_zscores", "merge_catapult", "attempt_trace_id",
                 "format_traceparent", "parse_traceparent"):
        assert name in jobs.__all__ and name in tobs.__all__, name
