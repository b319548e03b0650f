"""Host-side KV block allocator and prefix cache for the paged serving
engine (a copy of ``paddle_tpu/serving/block_pool.py``; the port may not
import the JAX package, whose ``__init__`` pulls in jax).

The device holds ONE pool of ``num_blocks`` KV blocks of ``block_size``
tokens per layer; a slot's cache is an int32 block table into it. All
allocation policy lives here on the host.

- ``BlockPool``: LIFO free-list allocator with per-block reference
  counts. Block 0 is the *dump* block: the decode step's inactive rows
  and the pad tokens of a prefill chunk still write, and routing those
  writes to block 0 keeps them out of every live block. A block with
  refcount > 1 is shared; a writer forks it first (copy-on-write,
  ``ServingEngine._ensure_writable``).
- ``PrefixCache``: exact-prefix reuse map ``prompt[:end] -> block id``
  with LRU eviction. A prompt that starts with an already-prefilled
  prefix adopts those blocks by reference.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np

from . import metrics as _sm

__all__ = ["BlockPool", "PrefixCache", "PoolExhaustedError",
           "BlockPoolError", "DUMP_BLOCK"]

# physical block 0: the write sink for inactive/padded rows. Never
# allocated, never freed, never cached.
DUMP_BLOCK = 0


class PoolExhaustedError(RuntimeError):
    """No free KV blocks. Callers evict the prefix cache / preempt a
    running request and retry, or surface admission backpressure."""


class BlockPoolError(RuntimeError):
    """Allocator invariant violation (double free, bad block id)."""


class BlockPool:
    """Ref-counted free-list allocator over ``num_blocks`` KV blocks.

    Allocation is all-or-nothing: ``alloc(n)`` returns ``n`` block ids or
    raises ``PoolExhaustedError`` leaving the pool untouched. The free
    list is LIFO, low ids first, so layouts are deterministic (and equal
    to the JAX package's under the same sequence of calls).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved dump "
                f"block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = np.zeros(num_blocks, np.int64)
        self._ref[DUMP_BLOCK] = 1  # pinned forever
        self.alloc_total = 0
        self.free_total = 0
        self.cow_forks = 0
        self.high_watermark = 0
        with self._lock:
            self._set_gauges()

    def alloc(self, n: int = 1) -> List[int]:
        """Take ``n`` fresh blocks (refcount 1 each). All-or-nothing."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        with self._lock:
            if n > len(self._free):
                raise PoolExhaustedError(
                    f"KV block pool exhausted: need {n} block(s), "
                    f"{len(self._free)} free of {self.usable_blocks} usable "
                    f"(block_size={self.block_size})")
            ids = [self._free.pop() for _ in range(n)]
            for b in ids:
                self._ref[b] = 1
            self.alloc_total += n
            self.high_watermark = max(self.high_watermark,
                                      self._used_unlocked())
            self._set_gauges()
            return ids

    def incref(self, block_id: int) -> None:
        """Adopt a shared reference to a live block."""
        with self._lock:
            self._check_live(block_id)
            self._ref[block_id] += 1
            self._set_gauges()

    def decref(self, block_id: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        with self._lock:
            self._check_live(block_id)
            self._ref[block_id] -= 1
            freed = self._ref[block_id] == 0
            if freed:
                self._free.append(block_id)
                self.free_total += 1
            self._set_gauges()
            return bool(freed)

    def ref(self, block_id: int) -> int:
        with self._lock:
            if not (0 <= block_id < self.num_blocks):
                raise BlockPoolError(f"bad block id {block_id}")
            return int(self._ref[block_id])

    def _check_live(self, block_id: int):  # holds-lock: _lock
        if not (0 < block_id < self.num_blocks):
            raise BlockPoolError(
                f"bad block id {block_id} (usable ids are "
                f"1..{self.num_blocks - 1}; 0 is the reserved dump block)")
        if self._ref[block_id] <= 0:
            raise BlockPoolError(
                f"block {block_id} is not allocated (double free / "
                f"use-after-free)")

    def note_cow_fork(self) -> None:
        with self._lock:
            self.cow_forks += 1

    def _used_unlocked(self) -> int:  # holds-lock: _lock
        return self.usable_blocks - len(self._free)

    def _shared_unlocked(self) -> int:  # holds-lock: _lock
        return int((self._ref[1:] > 1).sum())

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1  # minus the dump block

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def stats(self) -> dict:
        with self._lock:
            used = self._used_unlocked()
            return {
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "usable": self.usable_blocks,
                "in_use": used,
                "free": len(self._free),
                "shared": self._shared_unlocked(),
                "utilization": used / max(1, self.usable_blocks),
                "high_watermark": self.high_watermark,
                "alloc_total": self.alloc_total,
                "free_total": self.free_total,
                "cow_forks": self.cow_forks,
            }

    def _set_gauges(self):  # holds-lock: _lock
        _sm.kv_blocks_total.set(self.usable_blocks)
        _sm.kv_blocks_in_use.set(self._used_unlocked())
        _sm.kv_blocks_shared.set(self._shared_unlocked())


class PrefixCache:
    """Exact token-prefix -> KV block map with LRU eviction.

    One entry per cached block: the key is the prompt's bytes up to and
    including the tokens that block covers, so a hit guarantees both the
    block's own tokens AND its whole left context match. The cache holds
    its own reference on every registered block; eviction (LRU, only
    blocks nobody else references) releases it.
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        # key -> (block_id, covered_end); ordered for LRU (oldest first)
        self._map: "OrderedDict[bytes, Tuple[int, int]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(tokens: np.ndarray, end: int) -> bytes:
        return np.ascontiguousarray(tokens[:end], dtype=np.int32).tobytes()

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def note(self, hit_blocks: int, miss_blocks: int) -> None:
        """Admission-side hit/miss accounting."""
        with self._lock:
            self.hits += hit_blocks
            self.misses += miss_blocks

    def match(self, tokens: np.ndarray, limit: int) -> Tuple[int, List[int]]:
        """Longest reusable prefix of ``tokens`` covering at most
        ``limit`` tokens (callers pass ``len(prompt) - 1`` so the last
        prompt token is always recomputed for its logits). Increfs every
        matched block for the caller; returns ``(n_tokens_covered,
        block_ids)``."""
        bs = self.pool.block_size
        matched: List[int] = []
        covered = 0
        with self._lock:
            while covered < limit:
                hit = None
                # the full next block first, then every shorter tail
                top = min(covered + bs, limit)
                for end in range(top, covered, -1):
                    ent = self._map.get(self._key(tokens, end))
                    if ent is not None:
                        hit = (end, ent[0])
                        break
                if hit is None:
                    break
                end, bid = hit
                self.pool.incref(bid)
                self._map.move_to_end(self._key(tokens, end))
                matched.append(bid)
                covered = end
                if end % bs:
                    break  # a partial block is always the last reusable one
        return covered, matched

    def insert(self, tokens: np.ndarray, length: int,
               block_ids: Sequence[int]) -> int:
        """Register the blocks covering ``tokens[:length]`` after a
        prefill completes. Present keys are left alone (first writer
        wins). Returns the number of new entries."""
        bs = self.pool.block_size
        added = 0
        with self._lock:
            for i, bid in enumerate(block_ids):
                end = min((i + 1) * bs, length)
                if end <= i * bs:
                    break
                key = self._key(tokens, end)
                if key in self._map:
                    self._map.move_to_end(key)
                    continue
                self.pool.incref(bid)
                self._map[key] = (bid, end)
                added += 1
        return added

    def evict(self, n: int) -> int:
        """Free up to ``n`` blocks by dropping LRU entries whose block only
        the cache references. Returns how many were freed."""
        freed = 0
        with self._lock:
            for key in list(self._map.keys()):
                if freed >= n:
                    break
                bid, _ = self._map[key]
                if self.pool.ref(bid) == 1:
                    del self._map[key]
                    self.pool.decref(bid)
                    freed += 1
                    # no KV tier below the pool: an evicted block is
                    # freed outright
                    _sm.prefix_cache_evictions.labels("dropped").inc()
        return freed

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._map), "hits": self.hits,
                    "misses": self.misses}
