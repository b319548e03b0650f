"""Fleet trace propagation: the trace-id helpers of
``paddle_tpu/observability/fleet.py`` (W3C traceparent subset).

A router derives a deterministic per-attempt trace id from ``(request
id, attempt generation)`` and carries it across the replica boundary as
a ``traceparent`` header on ``POST /generate``. The replica-side
``Request`` adopts the propagated id as its trace, so its whole span
tree (queued -> prefill -> decode -> terminal) lands under an id the
router can fetch back (``GET /trace?trace=<id>``). Malformed or absent
headers parse to ``None``: a hostile header means a fresh local trace,
never an error.

The metric-federation aggregator, the SLO tracker and the brownout
controller of the JAX module come with the router.
"""

from __future__ import annotations

from typing import Optional

__all__ = [
    "TRACEPARENT_HEADER",
    "attempt_trace_id", "format_traceparent", "parse_traceparent",
    "traceparent_of",
]

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
