"""Fleet observability plane (counterpart of
``paddle_tpu/observability/fleet.py``): the pieces that make the
multi-replica router read as ONE system instead of N disjoint processes.

Four mechanisms, each consumed by ``serving/router.py``:

- **Trace propagation** (the Dapper idea): the router derives a
  deterministic per-attempt trace id from ``(request id, attempt
  generation)`` and carries it across the replica boundary — as a
  W3C-traceparent-style header on ``HTTPReplica``'s ``POST /generate``,
  or through the existing thread-local ``tracing.trace_context`` for
  ``LocalReplica``. The replica-side ``Request`` adopts the propagated
  id as its trace, so its whole span tree (queued → prefill → decode →
  terminal) lands under an id the router can fetch back and merge.
  Each retry/hedge gets a DISTINCT id (the generation is in it), so a
  failover request renders as one catapult file with one swimlane per
  attempt. Malformed or absent headers parse to ``None`` — a hostile
  header means a fresh local trace, never an error.

- **Metric federation** (the Monarch/Prometheus-federation idea):
  ``FleetMetricsAggregator`` caches each replica's ``/metrics``
  exposition (scraped by the router on its staleness-bounded stats
  cadence), relabels every series with ``replica=<name>`` (an existing
  ``replica`` label is preserved as ``exported_replica``, the
  honor-labels convention), and renders the union plus fleet roll-ups
  under ``replica="fleet"``: counters and histogram buckets sum,
  summary quantiles merge count-weighted (an approximation — exact
  distributed quantiles need sketches; the count weighting keeps a
  busy replica from being averaged away by an idle one), and the
  goodput gauge sums (fleet goodput IS the sum; other gauges —
  utilizations, depths — are left per-replica where summing would
  lie). A hung scrape keeps serving the last-known series with a
  ``paddle_tpu_fleet_scrape_stale`` marker — staleness is visible,
  never an ejection.

- **SLO tracking**: ``SLOConfig`` declares the latency contract (TTFT
  p95 bound, deadline-met goodput floor, availability target) and
  ``SLOTracker`` evaluates it as multi-window burn rates in the SRE-
  workbook style: ``burn = bad_fraction / error_budget`` over a fast
  (default 1 min) and a slow (default 30 min) window, and an objective
  is breached only when BOTH windows burn above their thresholds — the
  fast window makes alerts responsive, the slow window keeps a
  transient blip from paging. Windows and thresholds are knobs so the
  test clock can compress them.

- **Straggler detection**: ``mad_zscores`` is the robust modified
  z-score (0.6745 · (x − median) / MAD, the LossSpikeSentinel idiom;
  mean-absolute-deviation fallback when MAD degenerates to 0) the
  router applies to per-replica TPOT p50s — a replica whose decode
  cadence sits far above the fleet median is flagged ``straggler``
  without any absolute latency threshold to mis-tune.

- **SLO-driven brownout**: ``BrownoutController`` closes the loop the
  ``SLOTracker`` leaves open — when BOTH burn windows run hot it steps
  the serving plane through a declarative degradation ladder (shed
  batch-class work → disable hedging → cap batch decode length →
  shrink speculation), one level per burning report with a minimum
  dwell, and walks back down only after a streak of consecutive
  healthy reports (hysteresis: a single good minute must not re-admit
  the load that caused the burn). Every transition is a counter, a
  gauge move, and a traced instant — brownout is an OPERATED state,
  never a silent one.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from . import metrics as _m
from . import tracing as _tracing
from .exporters import parse_prometheus_text, render_families

__all__ = [
    "TRACEPARENT_HEADER",
    "attempt_trace_id", "format_traceparent", "parse_traceparent",
    "traceparent_of", "merge_catapult",
    "FleetMetricsAggregator", "FLEET_REPLICA_LABEL",
    "SLOConfig", "SLOTracker",
    "BrownoutController", "BROWNOUT_LEVELS",
    "mad_zscores",
]

# ---------------------------------------------------------------------------
# trace propagation (W3C traceparent subset)
# ---------------------------------------------------------------------------

TRACEPARENT_HEADER = "traceparent"

_TRACE_HEX = 32   # 16-byte trace id, lowercase hex
_PARENT_HEX = 16  # 8-byte parent/span id, lowercase hex


def attempt_trace_id(request_id: int, attempt_gen: int) -> str:
    """The propagated trace id for one router attempt:
    ``<32-hex trace>-<16-hex parent>``. The trace half is the router
    request id, the parent half the attempt generation — deterministic,
    collision-free per attempt, and distinct per retry/hedge so each
    attempt renders as its own swimlane."""
    t = (int(request_id) + 1) & ((1 << 128) - 1)  # +1: all-zero is invalid
    p = int(attempt_gen) & ((1 << 64) - 1)
    return f"{t or 1:0{_TRACE_HEX}x}-{p or 1:0{_PARENT_HEX}x}"


def format_traceparent(trace_hex: str, parent_hex: str) -> str:
    """``00-<trace>-<parent>-01`` (version 00, sampled flag)."""
    return f"00-{trace_hex}-{parent_hex}-01"


def traceparent_of(trace_id: str) -> Optional[str]:
    """The header value carrying an ``attempt_trace_id`` — None when
    the id isn't in the propagated shape (never raises)."""
    parts = str(trace_id).split("-")
    if len(parts) != 2:
        return None
    t, p = parts
    if len(t) != _TRACE_HEX or len(p) != _PARENT_HEX:
        return None
    return format_traceparent(t, p)


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in "0123456789abcdef" for c in s)


def parse_traceparent(value) -> Optional[str]:
    """Parse a traceparent header into the propagated trace id
    (``<trace>-<parent>``), or None for anything malformed: wrong
    version, wrong field count/width, uppercase or non-hex digits,
    all-zero ids, non-string input. NEVER raises — a hostile header
    must cost a fresh local trace, not a 400/500."""
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace, parent, flags = parts
    if version != "00" or len(flags) != 2 or not _is_hex(flags):
        return None
    if len(trace) != _TRACE_HEX or not _is_hex(trace) \
            or trace == "0" * _TRACE_HEX:
        return None
    if len(parent) != _PARENT_HEX or not _is_hex(parent) \
            or parent == "0" * _PARENT_HEX:
        return None
    return f"{trace}-{parent}"


def merge_catapult(parts: Sequence[Tuple[str, dict]]) -> dict:
    """Merge several chrome-trace (catapult) dicts into one multi-
    swimlane file: each part becomes its own process (pid = part
    index) named by its label, so the router's lane and every
    attempt's replica-side lane sit side by side on the shared
    monotonic clock. Input dicts are not mutated."""
    out: List[dict] = []
    for pid, (label, ct) in enumerate(parts):
        named = False
        for ev in (ct or {}).get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                if named:
                    continue  # one process_name per lane group
                named = True
                ev["args"] = {"name": label}
            out.append(ev)
        if not named:
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": label}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# metric federation
# ---------------------------------------------------------------------------

FLEET_REPLICA_LABEL = "fleet"  # roll-up series carry replica="fleet"

_fleet_scrapes_total = _m.counter(
    "paddle_tpu_fleet_scrapes_total",
    "replica /metrics scrapes by the router-side federation aggregator",
    ("outcome",))
_federated_series = _m.gauge(
    "paddle_tpu_fleet_federated_series",
    "series in the last federated /metrics exposition (union of every "
    "replica's relabeled series plus the fleet roll-ups)")

# gauges where a fleet sum is the truthful roll-up (rates/throughputs);
# utilization/depth gauges stay per-replica — summing them would lie
_ROLLUP_GAUGES = frozenset({
    "paddle_tpu_serving_goodput_tokens_per_second",
})


def _group_key(series: str, labels: Dict[str, str]) -> tuple:
    rest = tuple(sorted((k, v) for k, v in labels.items()
                        if k not in ("replica", "exported_replica")))
    return series, rest


class FleetMetricsAggregator:
    """Router-side cache of per-replica Prometheus expositions.

    ``should_scrape`` enforces the staleness bound (and claims the
    refresh window even when the scrape then fails, so a hung replica
    is retried on the cadence, not hammered); ``update``/``mark_stale``
    record the outcome; ``federated_families``/``render`` produce the
    union + roll-ups. Thread-safe: the router's driver threads scrape
    while the HTTP thread renders."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"ts", "families", "stale", "ever"}
        self._scraped: Dict[str, dict] = {}
        self.scrapes = 0
        self.scrape_errors = 0

    # -- scrape bookkeeping --------------------------------------------------
    def should_scrape(self, name: str, now: float, refresh_s: float) -> bool:
        with self._lock:
            e = self._scraped.setdefault(
                name, {"ts": 0.0, "families": {}, "stale": False,
                       "ever": False})
            if e["ever"] and now - e["ts"] <= refresh_s:
                return False
            e["ts"] = now  # claim the window even if the scrape fails
            e["ever"] = True
            return True

    def update(self, name: str, text: str, now: Optional[float] = None):
        families = parse_prometheus_text(text)
        with self._lock:
            e = self._scraped.setdefault(
                name, {"ts": 0.0, "families": {}, "stale": False,
                       "ever": True})
            e["families"] = families
            e["stale"] = False
            if now is not None:
                e["ts"] = now
            self.scrapes += 1
        _fleet_scrapes_total.labels("ok").inc()

    def mark_stale(self, name: str):
        """A scrape failed/timed out: keep the last-known series,
        flagged stale — visibility degrades, rotation does not."""
        with self._lock:
            e = self._scraped.get(name)
            if e is not None:
                e["stale"] = True
            self.scrape_errors += 1
        _fleet_scrapes_total.labels("error").inc()

    def forget(self, name: str):
        with self._lock:
            self._scraped.pop(name, None)

    # -- federation ----------------------------------------------------------
    def federated_families(self) -> Dict[str, dict]:
        """The union of every replica's families, each sample relabeled
        ``replica=<name>``, plus the ``replica="fleet"`` roll-ups."""
        with self._lock:
            snap = {n: e["families"] for n, e in self._scraped.items()
                    if e["families"]}
        fams: Dict[str, dict] = {}
        for replica in sorted(snap):
            for fname, fam in snap[replica].items():
                dst = fams.setdefault(
                    fname, {"type": fam.get("type", "untyped"),
                            "help": fam.get("help", ""), "samples": []})
                if not dst["help"] and fam.get("help"):
                    dst["help"] = fam["help"]
                for s in fam["samples"]:
                    labels = dict(s["labels"])
                    if "replica" in labels:
                        labels["exported_replica"] = labels.pop("replica")
                    labels["replica"] = replica
                    dst["samples"].append({"series": s["series"],
                                           "labels": labels,
                                           "value": s["value"]})
        for fname, fam in fams.items():
            fam["samples"].extend(self._rollup(fname, fam))
        return fams

    def _rollup(self, fname: str, fam: dict) -> List[dict]:
        kind = fam["type"]
        if kind == "summary":
            return self._rollup_summary(fname, fam)
        if kind not in ("counter", "histogram") \
                and fname not in _ROLLUP_GAUGES:
            return []
        sums: Dict[tuple, float] = {}
        for s in fam["samples"]:
            key = _group_key(s["series"], s["labels"])
            sums[key] = sums.get(key, 0.0) + s["value"]
        return [{"series": series,
                 "labels": {**dict(rest), "replica": FLEET_REPLICA_LABEL},
                 "value": v}
                for (series, rest), v in sums.items()]

    def _rollup_summary(self, fname: str, fam: dict) -> List[dict]:
        """Count-weighted summary merge: quantiles average weighted by
        each replica's ``_count`` (approximate by construction),
        ``_sum``/``_count`` sum exactly."""
        # group by the label set minus replica/quantile
        groups: Dict[tuple, dict] = {}
        for s in fam["samples"]:
            labels = dict(s["labels"])
            replica = labels.pop("replica", "")
            labels.pop("exported_replica", None)
            q = labels.pop("quantile", None)
            key = tuple(sorted(labels.items()))
            g = groups.setdefault(key, {"labels": labels, "counts": {},
                                        "sums": {}, "quantiles": {}})
            if s["series"] == fname + "_count":
                g["counts"][replica] = s["value"]
            elif s["series"] == fname + "_sum":
                g["sums"][replica] = s["value"]
            elif q is not None:
                g["quantiles"].setdefault(q, {})[replica] = s["value"]
        out: List[dict] = []
        for g in groups.values():
            base = {**g["labels"], "replica": FLEET_REPLICA_LABEL}
            total = sum(g["counts"].values())
            for q, per_rep in sorted(g["quantiles"].items()):
                w = [(v, g["counts"].get(rep, 0.0))
                     for rep, v in per_rep.items()]
                wsum = sum(c for _, c in w)
                if wsum <= 0:
                    continue
                merged = sum(v * c for v, c in w) / wsum
                out.append({"series": fname,
                            "labels": {**base, "quantile": q},
                            "value": merged})
            out.append({"series": fname + "_sum", "labels": dict(base),
                        "value": sum(g["sums"].values())})
            out.append({"series": fname + "_count", "labels": dict(base),
                        "value": total})
        return out

    def render(self) -> str:
        """The federated exposition text (what router ``GET /metrics``
        serves), including the scrape-health families."""
        fams = self.federated_families()
        now = time.perf_counter()
        with self._lock:
            health = [(n, e["ts"], e["stale"])
                      for n, e in sorted(self._scraped.items()) if e["ever"]]
        if health:
            fams["paddle_tpu_fleet_scrape_age_seconds"] = {
                "type": "gauge",
                "help": "seconds since the replica's /metrics was last "
                        "scraped (claimed window start on failures)",
                "samples": [{"series": "paddle_tpu_fleet_scrape_age_seconds",
                             "labels": {"replica": n},
                             "value": round(max(now - ts, 0.0), 3)}
                            for n, ts, _ in health]}
            fams["paddle_tpu_fleet_scrape_stale"] = {
                "type": "gauge",
                "help": "1 while the replica's federated series are "
                        "last-known values from before a failed scrape",
                "samples": [{"series": "paddle_tpu_fleet_scrape_stale",
                             "labels": {"replica": n},
                             "value": 1 if stale else 0}
                            for n, _, stale in health]}
        n_series = sum(len(f["samples"]) for f in fams.values())
        _federated_series.set(n_series)
        return render_families(fams)

    def stats(self) -> dict:
        with self._lock:
            replicas = {
                n: {"stale": e["stale"],
                    "families": len(e["families"]),
                    "series": sum(len(f["samples"])
                                  for f in e["families"].values())}
                for n, e in self._scraped.items() if e["ever"]}
        return {"replicas": replicas, "scrapes": self.scrapes,
                "scrape_errors": self.scrape_errors}


# ---------------------------------------------------------------------------
# SLO burn-rate tracking
# ---------------------------------------------------------------------------

_slo_burn = _m.gauge(
    "paddle_tpu_slo_burn_rate",
    "error-budget burn rate per objective and window (1.0 = consuming "
    "budget exactly at the sustainable rate)", ("objective", "window"))
_slo_ok = _m.gauge(
    "paddle_tpu_slo_ok",
    "1 while the objective is within its multi-window burn-rate "
    "thresholds (0 = both windows burning too hot)", ("objective",))


@dataclass
class SLOConfig:
    """The fleet's declarative latency contract.

    Targets are good-event fractions: ``ttft_target_fraction`` of
    requests must see first token within ``ttft_p95_s`` (the "p95
    bound" shape), ``goodput_floor`` must complete within their
    deadline, ``availability`` must not FAIL. The error budget of each
    objective is ``1 - target``; burn rate is the windowed bad-fraction
    divided by that budget. ``fast``/``slow`` windows + thresholds are
    the SRE-workbook multi-window convention (defaults 1 min at 14.4x
    / 30 min at 1.0x), sized down by tests to fit the test clock."""

    ttft_p95_s: float = 1.0
    ttft_target_fraction: float = 0.95
    goodput_floor: float = 0.95
    availability: float = 0.99
    fast_window_s: float = 60.0
    slow_window_s: float = 1800.0
    fast_burn_threshold: float = 14.4
    slow_burn_threshold: float = 1.0
    history: int = 65536  # retained observations (bounded memory)

    def __post_init__(self):
        for name in ("ttft_target_fraction", "goodput_floor",
                     "availability"):
            v = getattr(self, name)
            if not 0.0 < v < 1.0:
                raise ValueError(f"{name} must be in (0, 1): an SLO of "
                                 f"{v} has no error budget to burn")
        if self.fast_window_s <= 0 or self.slow_window_s <= 0:
            raise ValueError("SLO windows must be positive")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast_window_s must not exceed slow_window_s")


class SLOTracker:
    """Sliding-window burn-rate evaluation over terminal request
    observations. ``observe`` is called by the router as each request
    finishes; ``report`` evaluates every objective over both windows
    (and publishes the ``paddle_tpu_slo_*`` gauges)."""

    def __init__(self, config: Optional[SLOConfig] = None,
                 clock=time.perf_counter):
        self.config = config or SLOConfig()
        self._clock = clock
        self._lock = threading.Lock()
        from collections import deque
        # (ts, available, goodput_ok, ttft_ok-or-None)
        self._obs = deque(maxlen=int(self.config.history))
        self.observed = 0
        self._last_publish = 0.0

    def observe(self, status: str, ttft_s: Optional[float],
                met_deadline: bool, ts: Optional[float] = None):
        """One terminal request. ``cancelled`` requests are excluded
        from every objective (a caller hanging up is not a fleet
        failure); requests that never produced a first token are
        excluded from the TTFT objective only."""
        if status == "cancelled":
            return
        now = ts if ts is not None else self._clock()
        rec = (now,
               status != "failed",
               bool(met_deadline),
               None if ttft_s is None
               else ttft_s <= self.config.ttft_p95_s)
        with self._lock:
            self._obs.append(rec)
            self.observed += 1
        # keep the gauges fresh without paying a full report per finish
        if now - self._last_publish >= 0.5:
            self._last_publish = now
            self.report(now=now)

    def report(self, now: Optional[float] = None) -> dict:
        cfg = self.config
        if now is None:
            now = self._clock()
        with self._lock:
            obs = list(self._obs)
        objectives = {}
        overall_ok = True
        for name, target, good in (
                ("availability", cfg.availability, lambda o: o[1]),
                ("goodput", cfg.goodput_floor, lambda o: o[2]),
                ("ttft_p95", cfg.ttft_target_fraction, lambda o: o[3])):
            budget = 1.0 - target
            windows = {}
            breached = {}
            for wname, wsec, thr in (
                    ("fast", cfg.fast_window_s, cfg.fast_burn_threshold),
                    ("slow", cfg.slow_window_s, cfg.slow_burn_threshold)):
                rel = [good(o) for o in obs if now - o[0] <= wsec]
                rel = [g for g in rel if g is not None]
                total = len(rel)
                bad = sum(1 for g in rel if not g)
                frac = bad / total if total else 0.0
                burn = frac / budget
                windows[wname] = {"window_s": wsec, "total": total,
                                  "bad": bad,
                                  "bad_fraction": round(frac, 6),
                                  "burn_rate": round(burn, 4),
                                  "threshold": thr}
                breached[wname] = total > 0 and burn >= thr
                _slo_burn.labels(name, wname).set(burn)
            # multi-window rule: alert only when BOTH windows burn hot
            ok = not (breached["fast"] and breached["slow"])
            _slo_ok.labels(name).set(1 if ok else 0)
            objectives[name] = {"target": target,
                                "error_budget": round(budget, 6),
                                "windows": windows, "ok": ok}
            overall_ok = overall_ok and ok
        return {
            "ok": overall_ok,
            "observed": self.observed,
            "config": {"ttft_p95_s": cfg.ttft_p95_s,
                       "ttft_target_fraction": cfg.ttft_target_fraction,
                       "goodput_floor": cfg.goodput_floor,
                       "availability": cfg.availability,
                       "fast_window_s": cfg.fast_window_s,
                       "slow_window_s": cfg.slow_window_s},
            "objectives": objectives,
        }


# ---------------------------------------------------------------------------
# SLO-driven brownout
# ---------------------------------------------------------------------------

_brownout_level = _m.gauge(
    "paddle_tpu_brownout_level",
    "current degradation level (0 = normal; higher = more load shed "
    "to protect the interactive SLO)")
_brownout_transitions = _m.counter(
    "paddle_tpu_brownout_transitions_total",
    "brownout ladder transitions", ("direction",))

# the degradation ladder, mildest first. Each level IMPLIES every level
# below it: at "cap_batch_tokens" the fleet is also shedding batch and
# not hedging. The ordering is goodput-per-cost: shed the work whose
# deadline tolerates a retry first, spend compile-cache-warm capacity
# (spec) last.
BROWNOUT_LEVELS = (
    "normal",            # 0: no degradation
    "shed_batch",        # 1: reject batch-class submits at the router
    "no_hedge",          # 2: stop duplicating slow attempts
    "cap_batch_tokens",  # 3: clamp batch-class max_new_tokens
    "shrink_spec",       # 4: cap speculation width (verify FLOPs back)
)


class BrownoutController:
    """Hysteresis ladder from SLO burn to degradation actions.

    Feed it ``SLOTracker.report()`` dicts on a fixed cadence (the
    router's probe loop). When a report is unhealthy (``ok`` False —
    both burn windows hot on some objective) the controller escalates
    ONE level, at most once per ``min_dwell_s``; when
    ``recover_reports`` consecutive healthy reports arrive it
    de-escalates one level (again dwell-limited). Asymmetry is the
    point: escalation needs one bad report because budget is burning
    NOW; recovery needs a streak because re-admitting load on a single
    good sample re-triggers the burn (the classic overload-control
    flap). Action predicates (``shed_batch`` etc.) are what the
    router/engine consult inline — reading them is lock-free-cheap and
    allocation-free."""

    GUARDED_BY = {"_level": "_lock", "_streak": "_lock",
                  "_last_move": "_lock", "_transitions": "_lock"}

    def __init__(self, recover_reports: int = 3,
                 min_dwell_s: float = 2.0, max_level: int = None,
                 clock=time.perf_counter):
        if recover_reports < 1:
            raise ValueError("recover_reports must be >= 1")
        top = len(BROWNOUT_LEVELS) - 1
        self.recover_reports = int(recover_reports)
        self.min_dwell_s = float(min_dwell_s)
        self.max_level = top if max_level is None else min(int(max_level),
                                                           top)
        self._clock = clock
        self._lock = threading.Lock()
        self._level = 0
        self._streak = 0           # consecutive healthy reports
        self._last_move = -1e18    # so the first escalation is immediate
        self._transitions = deque(maxlen=64)  # (ts, from, to, direction)
        _brownout_level.set(0)

    # -- the control loop ----------------------------------------------------
    def update(self, slo_report: Optional[dict],
               now: Optional[float] = None) -> int:
        """One control tick. Returns the (possibly new) level."""
        if now is None:
            now = self._clock()
        healthy = bool(slo_report.get("ok", True)) if slo_report else True
        # an SLO report with nothing observed is vacuously healthy —
        # browning out an idle fleet would be pure self-harm
        if slo_report and not slo_report.get("observed"):
            healthy = True
        with self._lock:
            if not healthy:
                self._streak = 0
                if self._level < self.max_level \
                        and now - self._last_move >= self.min_dwell_s:
                    self._move(self._level + 1, "escalate", now,
                               slo_report)
            else:
                self._streak += 1
                if self._level > 0 \
                        and self._streak >= self.recover_reports \
                        and now - self._last_move >= self.min_dwell_s:
                    self._streak = 0
                    self._move(self._level - 1, "recover", now, slo_report)
            return self._level

    # holds-lock: _lock
    def _move(self, new_level: int, direction: str, now: float,
              slo_report: Optional[dict]):
        """Caller holds the lock."""
        old = self._level
        self._level = new_level
        self._last_move = now
        self._transitions.append(
            {"ts": round(now, 3), "from": BROWNOUT_LEVELS[old],
             "to": BROWNOUT_LEVELS[new_level], "direction": direction})
        _brownout_level.set(new_level)
        _brownout_transitions.labels(direction).inc()
        burning = []
        if slo_report:
            burning = [n for n, o in
                       slo_report.get("objectives", {}).items()
                       if not o.get("ok", True)]
        _tracing.instant(
            "brownout_" + direction, cat="brownout", trace="brownout",
            args={"from": BROWNOUT_LEVELS[old],
                  "to": BROWNOUT_LEVELS[new_level],
                  "burning": burning})

    # -- action predicates (what the serving plane consults inline) ---------
    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    @property
    def level_name(self) -> str:
        return BROWNOUT_LEVELS[self.level]

    @property
    def shed_batch(self) -> bool:
        """Level >= 1: reject batch-class work at the router door."""
        return self.level >= 1

    @property
    def hedge_disabled(self) -> bool:
        """Level >= 2: a hedge is a deliberate duplicate — the first
        capacity to reclaim after shedding deferrable work."""
        return self.level >= 2

    @property
    def cap_batch_tokens(self) -> bool:
        """Level >= 3: batch work that DID get in decodes short."""
        return self.level >= 3

    @property
    def shrink_spec(self) -> bool:
        """Level >= 4: cap spec_k — verify-bundle FLOPs back to decode."""
        return self.level >= 4

    def report(self) -> dict:
        with self._lock:
            return {
                "level": self._level,
                "level_name": BROWNOUT_LEVELS[self._level],
                "levels": list(BROWNOUT_LEVELS),
                "max_level": self.max_level,
                "healthy_streak": self._streak,
                "recover_reports": self.recover_reports,
                "min_dwell_s": self.min_dwell_s,
                "actions": {
                    "shed_batch": self._level >= 1,
                    "hedge_disabled": self._level >= 2,
                    "cap_batch_tokens": self._level >= 3,
                    "shrink_spec": self._level >= 4,
                },
                "transitions": list(self._transitions),
            }


# ---------------------------------------------------------------------------
# straggler scoring
# ---------------------------------------------------------------------------


def mad_zscores(values: Sequence[float]) -> List[float]:
    """Modified (robust) z-scores: ``0.6745 * (x - median) / MAD``.
    When the MAD degenerates to 0 (most values identical — the common
    fleet case of N twins and one straggler), falls back to the mean
    absolute deviation with the matching 0.7979 consistency constant
    (Iglewicz & Hoaglin); all-identical input scores all zeros."""
    xs = sorted(values)
    n = len(xs)
    if n == 0:
        return []
    med = (xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2]))
    devs = sorted(abs(v - med) for v in values)
    mad = (devs[n // 2] if n % 2 else 0.5 * (devs[n // 2 - 1]
                                             + devs[n // 2]))
    if mad > 0:
        return [0.6745 * (v - med) / mad for v in values]
    mean_ad = sum(devs) / n
    if mean_ad > 0:
        return [0.7979 * (v - med) / mean_ad for v in values]
    return [0.0 for _ in values]
