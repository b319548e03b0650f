"""Shared block-size selection for the port's kernels (counterpart of
``paddle_tpu/pallas_kernels/_blocks.py``).

The flash-decode wrappers use it to cut the KV length into splits that
tile it exactly: the wanted size is clamped to the dimension and
halved until it divides it (the final fallback of 1 always divides).
"""

from __future__ import annotations

__all__ = ["pick_block"]


def pick_block(s: int, want: int) -> int:
    """Largest power-of-two-ish divisor of ``s`` at most ``want``.

    Starts from ``min(want, s)`` and halves until the candidate divides
    ``s``. For power-of-two lengths this returns ``want`` (or ``s`` when
    shorter); for awkward lengths it degrades gracefully instead of
    producing a split that drops the tail.
    """
    b = min(want, s)
    while s % b and b > 1:
        b //= 2
    return b
