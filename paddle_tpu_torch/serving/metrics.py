"""Serving metrics (counterpart of ``paddle_tpu/serving/metrics.py``:
every instrument under the same name, type, help text and label names),
registered at import so a scrape of ``/metrics`` shows serving state
(queue depth, slot occupancy, TTFT/TPOT) without anyone having to take
a snapshot first.

Names follow the ``paddle_tpu_serving_*`` prefix; all instruments live
in the port's observability registry (lock-free writer hot path), so
``observability.prometheus_text()`` / ``/metrics`` pick them up
automatically. The router, supervisor and KV-tier instruments are
registered for the modules still to come. The roofline gauges
(``mfu_gauge``, ``hbm_bw_util_gauge``) belong to the JAX package's
``observability/perf.py``, which has no counterpart yet.
"""

from __future__ import annotations

from ..observability import metrics as _m

__all__ = [
    "requests_total", "tokens_total", "queue_depth", "slots_busy",
    "slot_occupancy", "steps_total", "step_seconds", "prefill_seconds",
    "ttft_seconds", "tpot_seconds", "engine_crashes_total",
    "kv_blocks_total", "kv_blocks_in_use", "kv_blocks_shared",
    "prefix_cache_hits", "prefix_cache_misses", "prefix_cache_evictions",
    "cow_forks_total", "preemptions_total", "prefill_chunks_total",
    "kv_bytes_per_token",
    "kv_tier_demoted_blocks", "kv_tier_readmitted_blocks",
    "kv_tier_readmitted_tokens", "kv_tier_spills", "kv_tier_disk_loads",
    "kv_tier_disk_skipped", "kv_tier_host_blocks", "kv_tier_host_bytes",
    "kv_tier_disk_entries",
    "ttft_summary", "tpot_summary", "queue_wait_seconds",
    "prefill_chunk_seconds", "goodput_tokens_per_second",
    "latency_digests", "spec_drafted_tokens", "spec_accepted_tokens",
    "spec_rejected_tokens", "spec_accept_len", "spec_accept_depth",
    "spec_tree_nodes_drafted", "spec_tree_nodes_accepted",
    "queue_wait_retry_after",
    "queue_wait_p50",
    "requests_shed_total", "deadline_rejected_total",
    "supervisor_restarts_total", "supervisor_requeued_total",
    "requests_quarantined_total",
    "router_requests_total", "router_attempts_total",
    "router_retries_total", "router_hedges_total",
    "router_probe_failures_total", "router_ejections_total",
    "router_readmissions_total", "router_drains_total",
    "router_replica_healthy", "router_replica_inflight",
    "router_unroutable_total",
    "router_stragglers_total", "router_replica_straggler",
    "router_poison_blocked_total",
]

requests_total = _m.counter(
    "paddle_tpu_serving_requests_total",
    "serving requests by terminal outcome", ("outcome",))
tokens_total = _m.counter(
    "paddle_tpu_serving_tokens_total",
    "tokens through the serving engine (prompt = prefilled, "
    "generated = decoded)", ("kind",))
queue_depth = _m.gauge(
    "paddle_tpu_serving_queue_depth",
    "requests waiting for a decode slot")
slots_busy = _m.gauge(
    "paddle_tpu_serving_slots_busy",
    "decode slots currently running a request")
slot_occupancy = _m.gauge(
    "paddle_tpu_serving_slot_occupancy",
    "busy fraction of the decode slot pool (0..1)")
steps_total = _m.counter(
    "paddle_tpu_serving_steps_total",
    "batched decode steps executed")
engine_crashes_total = _m.counter(
    "paddle_tpu_serving_engine_crashes_total",
    "decode-loop crashes outside the per-request guards (every queued "
    "and running request is failed, /healthz flips unhealthy)")
# -- self-healing supervision (serving/supervisor.py) ----------------------
supervisor_restarts_total = _m.counter(
    "paddle_tpu_serving_supervisor_restarts_total",
    "warm engine restarts the supervisor performed after a decode-loop "
    "crash (fresh pools + warmup() zero-compile boot; innocent "
    "requests requeued, crash suspects re-admitted as solo probes)")
supervisor_requeued_total = _m.counter(
    "paddle_tpu_serving_supervisor_requeued_total",
    "requests carried across a supervised engine restart instead of "
    "failed, by where the crash caught them ('queued' = waiting for a "
    "slot, untouched by the crashing step; 'running' = active in the "
    "crashing step, requeued under the seed-deterministic PRNG replay "
    "so the resumed output stays bit-identical)", ("kind",))
requests_quarantined_total = _m.counter(
    "paddle_tpu_serving_quarantined_total",
    "requests failed terminally as poison: their fingerprint was "
    "implicated in the quarantine budget's worth of distinct engine "
    "crashes, and no replica will re-admit it")
# -- priority-aware overload control (DAGOR-style shedding) ----------------
requests_shed_total = _m.counter(
    "paddle_tpu_serving_requests_shed_total",
    "queued requests shed (REJECTED) to admit a higher-priority class "
    "under queue pressure, by the shed request's class", ("cls",))
deadline_rejected_total = _m.counter(
    "paddle_tpu_serving_deadline_rejected_total",
    "requests rejected at admission because their deadline could not "
    "beat the live queue-wait p50 (429 + Retry-After: failing fast "
    "beats queueing work that is already dead), by class", ("cls",))
engine_unhealthy = _m.gauge(
    "paddle_tpu_serving_engine_unhealthy",
    "1 while the most recent serving engine is crash-dead; constructing "
    "a fresh engine resets it (drives /healthz 503s)")
# -- paged KV cache (block pool + prefix sharing) --------------------------
kv_blocks_total = _m.gauge(
    "paddle_tpu_kv_blocks_total",
    "usable KV blocks in the device pool (excludes the reserved dump "
    "block)")
kv_blocks_in_use = _m.gauge(
    "paddle_tpu_kv_blocks_in_use",
    "KV blocks currently allocated (request-owned or prefix-cached)")
kv_blocks_shared = _m.gauge(
    "paddle_tpu_kv_blocks_shared",
    "KV blocks with more than one reference (COW-protected prefix "
    "sharing)")
prefix_cache_hits = _m.counter(
    "paddle_tpu_prefix_cache_hits_total",
    "prompt KV blocks adopted from the prefix cache instead of "
    "prefilled")
prefix_cache_misses = _m.counter(
    "paddle_tpu_prefix_cache_misses_total",
    "prompt KV blocks that had to be prefilled (no cached prefix)")
prefix_cache_evictions = _m.counter(
    "paddle_tpu_prefix_cache_evictions_total",
    "prefix-cache entries evicted (LRU) to reclaim pool blocks, by what "
    "happened to the KV: 'demoted' = copied down to the host tier, "
    "'dropped' = freed outright (no tier, or the cost model said "
    "recompute is cheaper)", ("outcome",))
cow_forks_total = _m.counter(
    "paddle_tpu_serving_cow_forks_total",
    "copy-on-write forks: first divergent write into a shared KV block")
preemptions_total = _m.counter(
    "paddle_tpu_serving_preemptions_total",
    "running requests preempted (blocks reclaimed, requeued for "
    "recompute) under KV-pool pressure")
prefill_chunks_total = _m.counter(
    "paddle_tpu_serving_prefill_chunks_total",
    "fixed-size prefill chunks executed (chunked-prefill admission)")
# -- hierarchical KV tiers (serving/kv_tier.py: host RAM + disk) -----------
kv_tier_demoted_blocks = _m.counter(
    "paddle_tpu_kv_tier_demoted_blocks_total",
    "KV blocks demoted device->host instead of freed, by trigger "
    "('evict' = prefix-cache LRU victim, 'preempt' = preempted "
    "request's private blocks, 'flush' = drain-time persistence "
    "sweep, 'promote' = disk entry pulled back into host RAM)",
    ("reason",))
kv_tier_readmitted_blocks = _m.counter(
    "paddle_tpu_kv_tier_readmitted_blocks_total",
    "demoted KV blocks spliced host->HBM at admission instead of "
    "recomputed, by source tier", ("src",))
kv_tier_readmitted_tokens = _m.counter(
    "paddle_tpu_kv_tier_readmitted_tokens_total",
    "prompt tokens whose prefill was skipped because their block was "
    "re-admitted from a lower tier (the recompute work the hierarchy "
    "saved)")
kv_tier_spills = _m.counter(
    "paddle_tpu_kv_tier_spills_total",
    "tier entries committed to the persistent disk store (host-LRU "
    "spill victims + drain-time flush; each one an atomic-commit "
    "write)")
kv_tier_disk_loads = _m.counter(
    "paddle_tpu_kv_tier_disk_loads_total",
    "tier entries loaded (deep-verified) from the persistent disk "
    "store")
kv_tier_disk_skipped = _m.counter(
    "paddle_tpu_kv_tier_disk_skipped_total",
    "persisted spill entries refused at scan or load: 'corrupt' = "
    "uncommitted / digest-mismatch (kill-mid-spill debris), "
    "'incompatible' = written by a different engine configuration "
    "(fingerprint mismatch)", ("reason",))
kv_tier_host_blocks = _m.gauge(
    "paddle_tpu_kv_tier_host_blocks",
    "KV blocks currently resident in the host-RAM tier")
kv_tier_host_bytes = _m.gauge(
    "paddle_tpu_kv_tier_host_bytes",
    "host RAM the resident tier entries occupy (values + quant scales "
    "+ draft-model rows, at quantized width)")
kv_tier_disk_entries = _m.gauge(
    "paddle_tpu_kv_tier_disk_entries",
    "committed entries in the persistent disk tier")
# -- quantized KV (int8/fp8 block pools) -----------------------------------
kv_bytes_per_token = _m.gauge(
    "paddle_tpu_kv_bytes_per_token",
    "HBM bytes one cached token costs across all layers (K+V values "
    "plus, for quantized formats, the per-token-per-head f32 absmax "
    "scales) — set per engine at construction; the capacity math "
    "bf16_bytes / fmt_bytes is the pool-size multiplier a fixed HBM "
    "budget buys", ("format",))
# -- speculative decoding (draft-model engines) ----------------------------
spec_drafted_tokens = _m.counter(
    "paddle_tpu_serving_spec_drafted_tokens_total",
    "draft tokens proposed to speculative verify rounds")
spec_accepted_tokens = _m.counter(
    "paddle_tpu_serving_spec_accepted_tokens_total",
    "draft tokens accepted by the target model (each one a decode step "
    "the pool did not have to run)")
spec_rejected_tokens = _m.counter(
    "paddle_tpu_serving_spec_rejected_tokens_total",
    "draft tokens rejected at verify (the round still emits the "
    "target's own token, so rejection costs draft work, never output)")
# tree lane (ServingConfig.spec_tree): node accounting is distinct from
# the token counters above — a tree drafts width-1 NODES per round but
# can accept at most depth of them (one root-to-leaf path), so node
# accept RATE is structurally low even when every path matches; the
# depth histogram is the tuning surface (shift width toward the depths
# that actually accept)
spec_tree_nodes_drafted = _m.counter(
    "paddle_tpu_serving_spec_tree_nodes_drafted_total",
    "draft tree nodes proposed to tree-speculative verify rounds "
    "(tree width - 1 per live row per round)")
spec_tree_nodes_accepted = _m.counter(
    "paddle_tpu_serving_spec_tree_nodes_accepted_total",
    "draft tree nodes on accepted root-to-leaf paths (each one a decode "
    "step the pool did not have to run)")
spec_accept_depth = _m.histogram(
    "paddle_tpu_serving_spec_accept_depth",
    "accepted path depth per tree-speculative verify round (0 = only "
    "the root's own target token emitted, d = a depth-d draft path "
    "fully matched)",
    buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16))

step_seconds = _m.histogram(
    "paddle_tpu_serving_step_seconds",
    "wall time of one batched decode step",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0))
prefill_seconds = _m.histogram(
    "paddle_tpu_serving_prefill_seconds",
    "wall time of one bucketed prefill (+ cache splice)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))
ttft_seconds = _m.histogram(
    "paddle_tpu_serving_ttft_seconds",
    "time to first token (request arrival -> first token delivered)",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0, 30.0, 60.0))
tpot_seconds = _m.histogram(
    "paddle_tpu_serving_tpot_seconds",
    "per-token decode latency (time between consecutive tokens of one "
    "request)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5))

# -- streaming latency digests (summaries: exact p50/p95/p99 over a
# sliding sample window — the tails the fixed histogram buckets above
# quantize away; surfaced on /stats and in observability.snapshot()) ----
ttft_summary = _m.summary(
    "paddle_tpu_serving_ttft_summary_seconds",
    "time to first token, streaming p50/p95/p99 over the recent window")
tpot_summary = _m.summary(
    "paddle_tpu_serving_tpot_summary_seconds",
    "inter-token decode latency, streaming p50/p95/p99 over the recent "
    "window")
queue_wait_seconds = _m.summary(
    "paddle_tpu_serving_queue_wait_seconds",
    "time a request waited for a decode slot (submission-or-requeue -> "
    "admission), streaming p50/p95/p99")
prefill_chunk_seconds = _m.summary(
    "paddle_tpu_serving_prefill_chunk_seconds",
    "host wall time of one chunked-prefill dispatch, streaming "
    "p50/p95/p99")
spec_accept_len = _m.summary(
    "paddle_tpu_serving_spec_accept_len_summary",
    "accepted draft tokens per speculative verify round (0..k), "
    "streaming p50/p95/p99 — the live accept-length distribution the "
    "spec_k knob should be tuned against")
goodput_tokens_per_second = _m.gauge(
    "paddle_tpu_serving_goodput_tokens_per_second",
    "deadline-met throughput: tokens of requests that COMPLETED within "
    "their deadline (or had none), per second over the recent window — "
    "the number a load-aware router balances on (tokens delivered past "
    "a deadline are work, not goodput)")

# -- multi-replica router (serving/router.py) ------------------------------
router_requests_total = _m.counter(
    "paddle_tpu_router_requests_total",
    "router requests by terminal outcome", ("outcome",))
router_attempts_total = _m.counter(
    "paddle_tpu_router_attempts_total",
    "replica submissions the router made (first attempts + retries + "
    "hedges) — attempts/requests is the amplification factor the retry "
    "cap bounds")
router_retries_total = _m.counter(
    "paddle_tpu_router_retries_total",
    "requests re-submitted to another replica after their attempt died "
    "with the replica (crash/eject/stop)")
router_hedges_total = _m.counter(
    "paddle_tpu_router_hedges_total",
    "tail-latency hedges: a second replica was raced because TTFT "
    "exceeded the digest-derived threshold")
router_probe_failures_total = _m.counter(
    "paddle_tpu_router_probe_failures_total",
    "health-probe failures by reason (error/timeout/malformed/crashed)",
    ("reason",))
router_ejections_total = _m.counter(
    "paddle_tpu_router_ejections_total",
    "replicas ejected from rotation after K consecutive probe failures")
router_readmissions_total = _m.counter(
    "paddle_tpu_router_readmissions_total",
    "ejected replicas re-admitted after passing the warmup probe")
router_drains_total = _m.counter(
    "paddle_tpu_router_drains_total",
    "graceful replica drains initiated through the router")
router_unroutable_total = _m.counter(
    "paddle_tpu_router_unroutable_total",
    "requests that found no admitting replica (all ejected/draining/"
    "saturated) at some point in their routing loop")
router_replica_healthy = _m.gauge(
    "paddle_tpu_router_replica_healthy",
    "1 while the replica is in rotation (0 = ejected/draining/stopped)",
    ("replica",))
router_replica_inflight = _m.gauge(
    "paddle_tpu_router_replica_inflight",
    "router-attributed in-flight attempts per replica", ("replica",))
router_stragglers_total = _m.counter(
    "paddle_tpu_router_stragglers_total",
    "straggler flag transitions: a replica's TPOT p50 crossed the "
    "robust-MAD deviation threshold vs the fleet median (detection, "
    "not ejection — the replica stays in rotation)")
router_replica_straggler = _m.gauge(
    "paddle_tpu_router_replica_straggler",
    "1 while the replica's decode cadence is a robust-MAD outlier vs "
    "the fleet median (optionally fed into the admission score via "
    "RouterConfig.straggler_penalty)", ("replica",))
router_poison_blocked_total = _m.counter(
    "paddle_tpu_router_poison_blocked_total",
    "router-side poison verdicts: submissions refused for a quarantined "
    "fingerprint plus attempts failed terminally on a replica's "
    "PoisonedRequestError (either way, the poison never reaches "
    "another engine)", ("site",))

_DIGESTS = {
    "ttft_s": ttft_summary,
    "tpot_s": tpot_summary,
    "queue_wait_s": queue_wait_seconds,
    "prefill_chunk_s": prefill_chunk_seconds,
}


def queue_wait_retry_after(default: float = 1.0) -> float:
    """Retry-After hint for saturated/backpressure responses: the
    queue-wait digest's p50 is the best live estimate of when a slot
    frees up (falls back to ``default`` before any sample lands)."""
    quantiles, _total, count = queue_wait_seconds._d().snapshot()
    if not count:
        return default
    p50 = quantiles.get(0.5)
    if p50 is None:
        return default
    return max(round(float(p50), 3), 0.05)


def queue_wait_p50(min_count: int = 8) -> "float | None":
    """The queue-wait digest's live p50, or ``None`` before the digest
    has ``min_count`` samples — the deadline-feasibility estimate the
    scheduler rejects against. The warm-up guard matters: rejecting on
    one early outlier would turn a cold start into a 429 storm."""
    quantiles, _total, count = queue_wait_seconds._d().snapshot()
    if count < min_count:
        return None
    p50 = quantiles.get(0.5)
    return None if p50 is None else float(p50)


def latency_digests() -> dict:
    """Percentile snapshot of every serving latency digest — the
    ``/stats`` ``latency_digests`` block and the CI trace summary."""
    out = {}
    for name, s in _DIGESTS.items():
        quantiles, total, count = s._d().snapshot()
        out[name] = {f"p{round(q * 100)}": v for q, v in quantiles.items()}
        out[name]["count"] = count
        out[name]["mean"] = (total / count) if count else None
    return out
