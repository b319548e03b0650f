"""Continuous-batching serving engine over a paged KV cache
(counterpart of the paged core of ``paddle_tpu/serving/engine.py``).

The device holds ONE pool of KV blocks per layer ([num_blocks,
block_size, kv_heads, d]); each slot's cache is an int32 block table
into it, so capacity is bounded by tokens in flight, not slots times
the worst-case length. On top of the pool:

- prefix sharing: a prompt whose prefix was already prefilled (same
  tokens at the same positions) adopts those blocks by reference from
  the host-side prefix cache; a ref-counted copy-on-write fork protects
  a shared block on the first divergent write;
- chunked prefill: prompts run in fixed ``prefill_chunk`` bundles
  interleaved with decode steps, through the paged flash-decode kernel;
- preemption by recompute: under pool pressure the latest-admitted
  request gives its blocks back and is requeued at the front with its
  generated tokens folded into its next prefill; nothing is delivered
  twice;
- quantized KV blocks (``kv_format="int8"`` / ``"fp8"``): the pools hold
  narrow values with per-token-per-head f32 scale pools (``ks``/``vs``)
  on the same blocks; chunks and decode steps write quantized and read
  through the dequantizing paged kernel, and a COW fork copies the
  scales with the values.

Each iteration runs the three programs of the JAX engine as eager
PyTorch: a prefill chunk (``_chunk``), one decode step for the whole
slot pool (``_step``) and the COW block copy (``_cow``). Inactive rows
keep the JAX conventions: a zeroed block-table row, so their writes
land in the dump block, and ``pos`` pinned to 0.

The engine is driven synchronously (``submit`` + ``step`` /
``run_until_idle``) and decodes greedily; outputs equal
``generation.generate`` token for token.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..generation import (_paged_flat_indices, kv_cache_bytes_per_token,
                          make_cached_runner, make_paged_kv_pools)
from ..quantization.intx import KV_FORMATS, format_dtype
from . import metrics as _sm
from .block_pool import BlockPool, PoolExhaustedError, PrefixCache
from .request import Request, RequestStatus, SamplingParams
from .scheduler import Scheduler

__all__ = ["ServingConfig", "ServingEngine"]


@dataclass
class ServingConfig:
    """Engine knobs.

    - ``max_slots``: the decode batch B.
    - ``max_len``: per-slot KV capacity (prompt + new tokens).
    - ``block_size``: tokens per KV block; must divide ``max_len``.
    - ``num_blocks``: pool size INCLUDING the dump block. Default
      ``max_slots * max_len / block_size + 1`` (never runs out); smaller
      pools oversubscribe and preempt.
    - ``prefill_chunk``: tokens per prefill chunk.
    - ``prefix_caching``: reuse prefilled prompt prefixes.
    - ``max_queue_depth``: admission backpressure bound.
    - ``pad_token_id``: filler of a chunk's tail (its writes go to the
      dump block).
    - ``kv_format``: KV block storage, ``"bf16"`` (the model's own
      dtype), ``"int8"`` or ``"fp8"`` (e4m3), the narrow ones with f32
      per-token-per-head absmax scales. Quantized blocks live in the
      paged pool, the only KV mode of this engine.
    """

    max_slots: int = 4
    max_len: int = 256
    max_queue_depth: int = 64
    pad_token_id: int = 0
    block_size: int = 16
    num_blocks: Optional[int] = None
    prefill_chunk: int = 32
    prefix_caching: bool = True
    kv_format: str = "bf16"

    def __post_init__(self):
        if self.kv_format not in KV_FORMATS:
            raise ValueError(
                f"kv_format must be one of {KV_FORMATS}, got "
                f"{self.kv_format!r}")
        if self.kv_format != "bf16":
            format_dtype(self.kv_format)  # actionable fp8-missing error
        if self.block_size < 1 or self.max_len % self.block_size:
            raise ValueError(
                f"block_size ({self.block_size}) must divide max_len "
                f"({self.max_len}): the per-slot block table covers max_len "
                f"in whole KV blocks")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.num_blocks is not None and self.num_blocks < 2:
            raise ValueError(
                f"num_blocks ({self.num_blocks}) must be >= 2: block 0 is "
                f"the reserved dump block")

    def blocks_per_slot(self) -> int:
        return self.max_len // self.block_size

    def default_num_blocks(self) -> int:
        return self.max_slots * self.blocks_per_slot() + 1


@dataclass
class _PrefillJob:
    """Host-side progress of one chunked prefill."""

    req: Request
    tokens: np.ndarray           # prompt (+ replayed generation on resume)
    total: int
    done: int                    # tokens already in the cache
    skip: int                    # 1 on resume: the final select re-derives
    #                              a token already delivered


class ServingEngine:
    """Request-level serving over one decoder model speaking the
    ``generation`` static-cache protocol. ``device=None`` resolves to
    ``cuda``; the model must live on the engine's device."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device=None, **overrides):
        if config is None:
            config = ServingConfig(**overrides)
        elif overrides:
            raise ValueError("pass ServingConfig OR keyword overrides, not both")
        self.device = resolve_device(device)
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"the model lives on {param.device}, the engine "
                             f"on {self.device}: build them on one device")
        self.config = config
        self.model = model
        mcfg = model.config
        if config.max_len > mcfg.max_position_embeddings:
            raise ValueError(
                f"max_len ({config.max_len}) exceeds the model's "
                f"max_position_embeddings ({mcfg.max_position_embeddings})")
        B = int(config.max_slots)
        self.scheduler = Scheduler(config.max_queue_depth)
        self._dtype = param.dtype
        self._run = make_cached_runner(model)

        # per-slot decode state on the device: last token and the next
        # cache write index
        self._tokens = torch.zeros(B, dtype=torch.long, device=self.device)
        self._pos = torch.zeros(B, dtype=torch.int32, device=self.device)

        self._slot_req: List[Optional[Request]] = [None] * B
        self._decoding = [False] * B       # past prefill, in the step batch
        self._slot_seq = [0] * B           # admission order (victim pick)
        self._admit_seq = 0
        self._steps = 0
        self._chunks = 0
        self._outcomes: dict = {}
        self._preempt_count = 0

        bs = config.block_size
        self._nblocks = int(config.num_blocks or config.default_num_blocks())
        self.pool = BlockPool(self._nblocks, bs)
        self.prefix_cache = PrefixCache(self.pool) if config.prefix_caching \
            else None
        self._pools = make_paged_kv_pools(mcfg, self._nblocks, bs,
                                          self._dtype, config.kv_format,
                                          device=self.device)
        self._kv_bytes_per_token = kv_cache_bytes_per_token(
            mcfg, config.kv_format, self._dtype)
        _sm.set_gauge("kv_bytes_per_token", self._kv_bytes_per_token,
                      label=config.kv_format)
        self._bt = np.zeros((B, config.blocks_per_slot()), np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(B)]
        self._slot_len = [0] * B                          # host mirror of pos
        self._jobs: List[Optional[_PrefillJob]] = [None] * B

    # -- the three device programs --------------------------------------------
    def _chunk(self, bt_row, ids, pos0: int, valid: int, slot: int,
               is_last: bool, last_idx: int) -> Optional[int]:
        """ONE fixed-shape prefill chunk: forward ``ids`` [1, C] at
        ``pos0`` through the paged caches (pad tokens past ``valid`` write
        to the dump block; the write slots are computed once for all
        layers). The last chunk selects the first token and
        sets the slot's decode state; returns it, else None."""
        slots = _paged_flat_indices(bt_row, pos0, valid,
                                    self.config.block_size, 1, ids.shape[1],
                                    self.device)
        caches = [dict(c, bt=bt_row, slots=slots) for c in self._pools]
        logits, _ = self._run(ids, caches, pos0)
        self._chunks += 1
        if not is_last:
            return None
        token = logits[0, last_idx].argmax()
        self._tokens[slot] = token
        self._pos[slot] = pos0 + valid
        return int(token)

    def _step(self, bt, active):
        """ONE decode iteration for the whole slot pool through the block
        tables ``bt`` [B, nb] (inactive rows zeroed: their writes land in
        the dump block); free rows pinned to pos 0. Returns the [B]
        next tokens on the device."""
        slots = _paged_flat_indices(bt, self._pos, None,
                                    self.config.block_size, bt.shape[0], 1,
                                    self.device)
        caches = [dict(c, bt=bt, slots=slots) for c in self._pools]
        logits, _ = self._run(self._tokens[:, None], caches, self._pos)
        nxt = logits[:, 0].argmax(dim=-1)
        self._tokens = nxt
        self._pos = torch.where(
            active, torch.clamp(self._pos + 1, max=self.config.max_len - 1),
            torch.zeros((), dtype=torch.int32, device=self.device)
        ).to(torch.int32)
        self._steps += 1
        return nxt

    def _cow(self, src: int, dst: int):
        """Copy-on-write fork: duplicate physical block ``src`` into
        ``dst`` in every pool of every layer (K and V, and their scales
        when quantized)."""
        with torch.no_grad():
            for c in self._pools:
                for t in c.values():
                    t[dst].copy_(t[src])

    # -- submission ------------------------------------------------------------
    def submit(self, prompt, deadline_s: Optional[float] = None,
               on_token=None, params: Optional[SamplingParams] = None,
               **sampling) -> Request:
        """Enqueue one request; returns its handle immediately. Raises
        ``ValueError`` for a request that cannot fit a slot and
        ``QueueFullError`` under backpressure."""
        if params is None:
            params = SamplingParams(**sampling)
        elif sampling:
            raise ValueError("pass params OR sampling kwargs, not both")
        if params.do_sample:
            raise NotImplementedError(
                "do_sample=True: sampled decode comes with the sampled-decode "
                "slice (the threefry key chain ported bit for bit); the "
                "engine decodes greedily")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        L = int(prompt.shape[0])
        if L < 1:
            raise ValueError("empty prompt")
        if params.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if L + params.max_new_tokens > self.config.max_len:
            raise ValueError(
                f"prompt ({L}) + max_new_tokens ({params.max_new_tokens}) "
                f"exceeds the slot KV capacity max_len={self.config.max_len}")
        bs = self.config.block_size
        worst = -(-(L + params.max_new_tokens - 1) // bs)
        if worst > self.pool.usable_blocks:
            raise ValueError(
                f"prompt ({L}) + max_new_tokens ({params.max_new_tokens}) "
                f"needs up to {worst} KV blocks of {bs} tokens, but the pool "
                f"only has {self.pool.usable_blocks} usable blocks")
        req = Request(prompt, params, deadline_s=deadline_s, on_token=on_token)
        self.scheduler.submit(req)
        return req

    def cancel(self, req: Request) -> bool:
        return self.scheduler.cancel(req)

    # -- slot bookkeeping --------------------------------------------------------
    def busy_slots(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def _update_occupancy_gauges(self):
        _sm.set_gauge("slots_busy", self.busy_slots())

    def _clear_slot(self, slot: int):
        """Reset every host-side trace of a slot's occupant."""
        self._slot_req[slot] = None
        self._decoding[slot] = False
        self._jobs[slot] = None
        for b in self._slot_blocks[slot]:
            self.pool.decref(b)
        self._slot_blocks[slot] = []
        self._bt[slot, :] = 0
        self._slot_len[slot] = 0

    def _free_slot(self, slot: int, status: str, outcome: str,
                   error: Optional[str] = None):
        req = self._slot_req[slot]
        self._clear_slot(slot)
        if req is not None:
            req.finish(status, error=error)
            _sm.inc("requests_total", label=outcome)
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
        self._update_occupancy_gauges()

    def _finish_or_keep(self, slot: int, req: Request, token: int,
                        now: float) -> bool:
        """Terminal checks after a delivered token; True when freed."""
        p = req.params
        if req.cancel_requested:
            self._free_slot(slot, RequestStatus.CANCELLED, "cancelled")
            return True
        if req.deadline_ts is not None and now > req.deadline_ts:
            self._free_slot(slot, RequestStatus.EXPIRED, "expired",
                            error="deadline passed during decode")
            return True
        if (p.eos_token_id is not None and token == p.eos_token_id) \
                or len(req.output_tokens) >= p.max_new_tokens:
            self._free_slot(slot, RequestStatus.COMPLETED, "completed")
            return True
        return False

    # -- pool pressure: eviction, then preemption ------------------------------
    def _reclaim_alloc(self, n: int, requester: int,
                       allow_preempt: bool = True) -> List[int]:
        """Allocate ``n`` blocks; under pressure evict unreferenced
        prefix-cache entries, then (decode/COW paths only) preempt the
        latest-admitted OTHER request. Admission never preempts."""
        while True:
            try:
                return self.pool.alloc(n)
            except PoolExhaustedError:
                deficit = max(1, n - self.pool.free_blocks)
                if self.prefix_cache is not None \
                        and self.prefix_cache.evict(deficit) > 0:
                    continue
                victim = self._pick_victim(exclude=requester) \
                    if allow_preempt else None
                if victim is None:
                    raise
                self._preempt(victim)

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """Latest-admitted busy slot (other than ``exclude``) whose
        release frees at least one block; the oldest request is never
        the first victim, so preemption terminates."""
        best, best_seq = None, -1
        for slot in range(self.config.max_slots):
            if slot == exclude or self._slot_req[slot] is None:
                continue
            if not any(self.pool.ref(b) == 1 for b in self._slot_blocks[slot]):
                continue  # all shared: releasing frees nothing
            if self._slot_seq[slot] > best_seq:
                best, best_seq = slot, self._slot_seq[slot]
        return best

    def _build_resume(self, slot: int):
        """Resume state for the slot's occupant: mid-prefill restarts the
        same chunk job; mid-decode folds the generated tokens but the last
        into the next prefill, whose final select re-derives the last one
        (skipped, never re-delivered)."""
        req = self._slot_req[slot]
        job = self._jobs[slot]
        if job is not None:
            req._resume = (job.tokens, job.skip)
            return
        g = len(req.output_tokens)
        if g == 0:
            req._resume = None
            return
        tokens = np.concatenate(
            [req.prompt, np.asarray(req.output_tokens[:g - 1], np.int32)])
        req._resume = (tokens, 1)

    def _preempt(self, slot: int):
        """Preemption by recompute: release the slot's blocks and push its
        request back to the QUEUE FRONT."""
        req = self._slot_req[slot]
        self._build_resume(slot)
        req.slot = None
        req.preempt_count += 1
        self._clear_slot(slot)
        self.scheduler.requeue(req)
        self._preempt_count += 1
        _sm.inc("preemptions_total")
        self._update_occupancy_gauges()

    def _ensure_writable(self, slot: int, block_idx: int):
        """COW: the first write into a SHARED block forks it."""
        bid = self._slot_blocks[slot][block_idx]
        if self.pool.ref(bid) <= 1:
            return
        new_id = self._reclaim_alloc(1, slot)[0]
        self._cow(bid, new_id)
        self.pool.decref(bid)
        self._slot_blocks[slot][block_idx] = new_id
        self._bt[slot, block_idx] = new_id
        self.pool.note_cow_fork()
        _sm.inc("cow_forks_total")

    # -- admission + chunked prefill ---------------------------------------------
    def _begin_prefill(self, req: Request, slot: int):
        """Claim the slot: match the prompt against the prefix cache,
        allocate the remaining prompt blocks, and queue the chunk job."""
        resume = req._resume
        tokens, skip = resume if resume is not None else (req.prompt, 0)
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        total = int(tokens.shape[0])
        bs = self.config.block_size
        n_blocks = -(-total // bs)
        matched_tok, mblocks = 0, []
        if self.prefix_cache is not None:
            matched_tok, mblocks = self.prefix_cache.match(tokens, total - 1)
        try:
            fresh = self._reclaim_alloc(n_blocks - len(mblocks), slot,
                                        allow_preempt=False)
        except PoolExhaustedError:
            # admission retries later; the resume state must survive
            for b in mblocks:
                self.pool.decref(b)
            raise
        req._resume = None
        if self.prefix_cache is not None:
            self.prefix_cache.note(len(mblocks), n_blocks - len(mblocks))
            _sm.inc("prefix_cache_hits", len(mblocks))
            _sm.inc("prefix_cache_misses", n_blocks - len(mblocks))
            _sm.inc("tokens_total", matched_tok, label="prompt_cached")
        blocks = mblocks + fresh
        self._slot_blocks[slot] = blocks
        self._bt[slot, :] = 0
        self._bt[slot, :len(blocks)] = blocks
        self._slot_len[slot] = 0
        self._decoding[slot] = False
        self._slot_req[slot] = req
        self._admit_seq += 1
        self._slot_seq[slot] = self._admit_seq
        req.slot = slot
        req.status = RequestStatus.RUNNING
        now = time.perf_counter()
        wait = max(now - req.queued_since_ts, 0.0)
        req.queue_wait_total_s += wait
        req.admitted_ts = now
        _sm.observe_queue_wait(wait)
        self._jobs[slot] = _PrefillJob(req=req, tokens=tokens, total=total,
                                       done=matched_tok, skip=skip)
        self._update_occupancy_gauges()

    def _advance_prefill(self, slot: int):
        """Run ONE prefill chunk for the slot. The final chunk selects
        the first token and moves the slot into the decode batch; its
        prompt blocks are registered with the prefix cache before any
        decode write can dirty them."""
        job = self._jobs[slot]
        req = job.req
        if req.cancel_requested:
            self._free_slot(slot, RequestStatus.CANCELLED, "cancelled")
            return
        if req.deadline_ts is not None \
                and time.perf_counter() > req.deadline_ts:
            self._free_slot(slot, RequestStatus.EXPIRED, "expired",
                            error="deadline passed during prefill")
            return
        C = self.config.prefill_chunk
        bs = self.config.block_size
        start = job.done
        end = min(start + C, job.total)
        is_last = end == job.total
        for bi in range(start // bs, (end - 1) // bs + 1):
            self._ensure_writable(slot, bi)
        ids = np.full((1, C), self.config.pad_token_id, np.int64)
        ids[0, :end - start] = job.tokens[start:end]
        tok0 = self._chunk(
            torch.from_numpy(self._bt[slot:slot + 1]).to(self.device),
            torch.from_numpy(ids).to(self.device), start, end - start, slot,
            is_last, job.total - 1 - start)
        job.done = end
        _sm.inc("prefill_chunks_total")
        _sm.inc("tokens_total", end - start, label="prompt")
        if not is_last:
            return
        if self.prefix_cache is not None:
            n_reg = min(int(req.prompt.shape[0]), job.total)
            self.prefix_cache.insert(job.tokens, n_reg,
                                     self._slot_blocks[slot][:-(-n_reg // bs)])
        now = time.perf_counter()
        self._jobs[slot] = None
        self._decoding[slot] = True
        self._slot_len[slot] = job.total
        req.prefill_done_ts = now
        if job.skip:
            return  # resumed: tok0 re-derives the last delivered token
        req.push_token(tok0, now)
        _sm.inc("tokens_total", label="generated")
        self._finish_or_keep(slot, req, tok0, now)
        self._update_occupancy_gauges()

    def _admit(self):
        """Fill every free slot FCFS from the queue. Admission only claims
        blocks and queues the chunk job."""
        for slot in range(self.config.max_slots):
            while self._slot_req[slot] is None:
                req = self.scheduler.pop_ready()
                if req is None:
                    return
                try:
                    self._begin_prefill(req, slot)
                except PoolExhaustedError:
                    # FCFS holds: the request waits at the queue front
                    self.scheduler.requeue(req)
                    return
                except Exception as e:  # noqa: BLE001 — engine must survive
                    self._clear_slot(slot)
                    req.finish(RequestStatus.FAILED, error=repr(e))
                    _sm.inc("requests_total", label="failed")
                    self._outcomes["failed"] = \
                        self._outcomes.get("failed", 0) + 1

    # -- the iteration -----------------------------------------------------------
    def step(self) -> bool:
        """One iteration: admit into free slots, advance every in-flight
        prefill by one chunk, then (if any slot is decoding) run one
        decode step for the whole pool and deliver per-slot tokens.
        Returns True when any work happened."""
        self._admit()
        worked = False
        for slot in range(self.config.max_slots):
            if self._jobs[slot] is None:
                continue
            worked = True
            try:
                self._advance_prefill(slot)
            except PoolExhaustedError:
                self._preempt(slot)  # retried from the queue front
            except Exception as e:  # noqa: BLE001
                self._free_slot(slot, RequestStatus.FAILED, "failed",
                                error=repr(e))

        active = [i for i, r in enumerate(self._slot_req)
                  if r is not None and self._decoding[i]]
        for i in list(active):
            if self._slot_req[i].cancel_requested:
                self._free_slot(i, RequestStatus.CANCELLED, "cancelled")
                active.remove(i)
        if not active:
            self._update_occupancy_gauges()
            return worked

        # every active row writes this step's K/V at its current length:
        # crossing a block boundary allocates, a shared block forks;
        # allocation pressure preempts the latest-admitted request
        bs = self.config.block_size
        for i in list(active):
            if self._slot_req[i] is None or not self._decoding[i]:
                continue  # preempted by an earlier row's reclaim
            bi = self._slot_len[i] // bs
            try:
                if bi >= len(self._slot_blocks[i]):
                    nid = self._reclaim_alloc(1, i)[0]
                    self._slot_blocks[i].append(nid)
                    self._bt[i, bi] = nid
                else:
                    self._ensure_writable(i, bi)
            except PoolExhaustedError:
                self._preempt(i)
        active = [i for i in active
                  if self._slot_req[i] is not None and self._decoding[i]]
        if not active:
            self._update_occupancy_gauges()
            return True

        active_mask = np.zeros(self.config.max_slots, bool)
        active_mask[active] = True
        bt_step = self._bt.copy()
        bt_step[~active_mask] = 0  # inactive rows -> dump block
        toks = self._step(torch.from_numpy(bt_step).to(self.device),
                          torch.from_numpy(active_mask).to(self.device))
        toks_np = toks.cpu().numpy()  # the step's one device->host sync
        now = time.perf_counter()
        _sm.inc("steps_total")
        for i in active:
            req = self._slot_req[i]
            self._slot_len[i] = min(self._slot_len[i] + 1,
                                    self.config.max_len - 1)
            t = int(toks_np[i])
            req.push_token(t, now)
            _sm.inc("tokens_total", label="generated")
            self._finish_or_keep(i, req, t, now)
        return True

    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        """Drive ``step()`` until queue and slots are empty; returns the
        iterations executed."""
        n = 0
        while n < max_steps and (self.scheduler.depth or self.busy_slots()):
            if not self.step():
                break
            n += 1
        self._admit()
        return n

    def kv_block_stats(self) -> dict:
        """Pool utilization and internal fragmentation (allocated token
        slots the slots' sequences do not fill), with the quantization
        accounting: the storage format, bytes per cached token (values
        and scales, all layers), the pool's token capacity and the
        capacity multiplier against a bf16 pool of the same bytes."""
        stats = self.pool.stats()
        bs = self.config.block_size
        frag = 0
        for slot in range(self.config.max_slots):
            if self._slot_req[slot] is None:
                continue
            used = self._jobs[slot].done if self._jobs[slot] is not None \
                else self._slot_len[slot]
            frag += len(self._slot_blocks[slot]) * bs - used
        stats["internal_fragmentation_tokens"] = frag
        stats["kv_format"] = self.config.kv_format
        stats["bytes_per_token"] = self._kv_bytes_per_token
        stats["effective_capacity_tokens"] = self.pool.usable_blocks * bs
        bf16 = kv_cache_bytes_per_token(self.model.config, "bf16",
                                        self._dtype)
        stats["capacity_vs_bf16"] = round(
            bf16 / max(1, self._kv_bytes_per_token), 3)
        return stats

    def stats(self) -> dict:
        """Host-side counts: iterations, pool and prefix-cache state."""
        return {
            "steps": self._steps,
            "prefill_chunks": self._chunks,
            "preemptions": self._preempt_count,
            "outcomes": dict(self._outcomes),
            "queue_depth": self.scheduler.depth,
            "slots_busy": self.busy_slots(),
            "kv_format": self.config.kv_format,
            "kv_blocks": self.kv_block_stats(),
            "kv_bytes_per_token": self._kv_bytes_per_token,
            "prefix_cache": (self.prefix_cache.stats()
                             if self.prefix_cache is not None else None),
        }
