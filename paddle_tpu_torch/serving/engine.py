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
  scales with the values;
- speculative decoding (``draft_model=``): a chain lane (``spec_k``
  draft tokens a round, verified by the target as one q_len spec_k + 1
  bundle) or a tree lane (``spec_tree`` branching factors; all nodes of
  the flattened draft tree verified in one bundle under their ancestor
  mask, the paged kernel's K8 path, and the accepted path's K/V moved
  onto consecutive positions in both models' pools). The draft's pools
  mirror the target's and share its block tables, so prefix sharing,
  COW, chunked prefill and preemption drive both; rejected K/V is
  rolled back by position. A request opts out, or shrinks its draft,
  with ``SamplingParams.spec_k``.
- sampled decode (``SamplingParams(do_sample=True, temperature, top_k,
  top_p, seed)``): each slot carries its parameters and its threefry key
  on the device. The final prefill chunk selects the first token with
  ``split(PRNGKey(seed))``, every decode step splits every slot's key
  once (``split_keys``) and runs the per-row sampler only when a slot in
  the step samples; the speculative lanes draft and verify with the
  chain walked ahead (``split_key_levels``) and commit one split per
  emitted token. A slot's tokens are thus a function of (seed, params,
  logits), the same as ``generation.generate``'s for one request, and a
  preempted request resumes from its seed's chain walked back to the
  token it re-derives.

Each iteration runs the programs of the JAX engine as eager PyTorch: a
prefill chunk (``_chunk``), one decode step for the whole slot pool
(``_step``; with a draft model a draft and a verify, ``_spec_step``)
and the COW block copy (``_cow``). Inactive rows
keep the JAX conventions: a zeroed block-table row, so their writes
land in the dump block, and ``pos`` pinned to 0.

The engine is driven synchronously (``submit`` + ``step`` /
``run_until_idle``); outputs equal ``generation.generate`` token for
token (greedy, or sampled at B = 1 with the request's seed), with
speculation or without.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import prng
from ..device import resolve_device
from ..generation import (_check_draft_vocab, _commit_keys,
                          _paged_flat_indices, _plan_tensors, _with_tree,
                          draft_tree, kv_cache_bytes_per_token, kv_path_move,
                          make_cached_runner, make_paged_kv_pools,
                          path_commit, rows_select,
                          select_tokens, spec_accept_length,
                          spec_tree_plan, split_key_levels, split_keys,
                          tree_accept)
from ..kernels.decode_attention import (MAX_PAGED_Q_LEN, MAX_SPEC_K,
                                        spec_tree_width,
                                        spec_verify_eligibility)
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
      ``max_slots * (max_len / block_size + 1) + 1`` (never runs out:
      each slot also has room for the copy-on-write fork of a partial
      tail block it shares with the prefix cache); smaller pools
      oversubscribe and preempt.
    - ``prefill_chunk``: tokens per prefill chunk.
    - ``prefix_caching``: reuse prefilled prompt prefixes.
    - ``max_queue_depth``: admission backpressure bound.
    - ``pad_token_id``: filler of a chunk's tail (its writes go to the
      dump block).
    - ``kv_format``: KV block storage, ``"bf16"`` (the model's own
      dtype), ``"int8"`` or ``"fp8"`` (e4m3), the narrow ones with f32
      per-token-per-head absmax scales. Quantized blocks live in the
      paged pool, the only KV mode of this engine.
    - ``spec_k``: draft tokens per speculative round on an engine built
      with a ``draft_model`` (the verify bundle is spec_k + 1 positions
      through the paged kernel); ignored without one.
    - ``spec_tree``: per-level branching factors (e.g. ``[4, 2, 2]``)
      turning the chain lane into a draft token TREE verified in one
      bundle of ``spec_tree_width`` nodes. Mutually exclusive with a
      non-default ``spec_k``; ``SamplingParams.spec_k`` then clamps the
      tree depth per request.
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
    spec_k: int = 4
    spec_tree: Optional[Sequence[int]] = None

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
        if not 0 <= int(self.spec_k) <= MAX_SPEC_K:
            raise ValueError(
                f"spec_k ({self.spec_k}) must be in [0, {MAX_SPEC_K}]: the "
                f"speculative verify scores spec_k + 1 bundle positions in "
                f"one paged flash-decode call, whose query window is "
                f"MAX_PAGED_Q_LEN = {MAX_PAGED_Q_LEN}")
        if self.spec_tree is not None:
            factors = tuple(int(f) for f in self.spec_tree)
            if not factors or any(f < 1 for f in factors):
                raise ValueError(
                    f"spec_tree must be a non-empty sequence of branching "
                    f"factors >= 1 per draft level (e.g. [4, 2, 2]), got "
                    f"{self.spec_tree!r}")
            if int(self.spec_k) != 4:
                raise ValueError(
                    f"spec_tree ({list(factors)}) and a non-default spec_k "
                    f"({self.spec_k}) are mutually exclusive: one engine "
                    f"runs ONE speculative lane, the chain or the tree. "
                    f"Drop spec_k (per-request depth clamps still ride "
                    f"SamplingParams.spec_k) or drop spec_tree")
            wnodes = spec_tree_width(factors)
            if wnodes > MAX_PAGED_Q_LEN:
                raise ValueError(
                    f"spec_tree {list(factors)} flattens to {wnodes} nodes, "
                    f"but the verify bundle scores every node in one paged "
                    f"flash-decode call whose query window is "
                    f"MAX_PAGED_Q_LEN = {MAX_PAGED_Q_LEN}: shrink the "
                    f"branching factors or the depth")
            self.spec_tree = factors

    def validate_draft(self, model_config, draft_config):
        """Speculative-lane compatibility of the target and draft models
        (called by the engine when ``draft_model`` is given)."""
        if self.spec_k < 1:
            raise ValueError(
                f"spec_k ({self.spec_k}) must be >= 1 when a draft_model is "
                f"given: with 0 draft tokens per round the draft model is "
                f"dead weight; drop draft_model instead")
        _check_draft_vocab(model_config, draft_config)
        if self.max_len > draft_config.max_position_embeddings:
            raise ValueError(
                f"max_len ({self.max_len}) exceeds the DRAFT model's "
                f"max_position_embeddings "
                f"({draft_config.max_position_embeddings}); the draft "
                f"decodes the same positions the target does")

    def blocks_per_slot(self) -> int:
        return self.max_len // self.block_size

    def default_num_blocks(self) -> int:
        """A pool that never runs out: every slot's ``blocks_per_slot``
        blocks, one more per slot, and the dump block. The extra block
        is the copy-on-write fork of a prompt's partial tail block: the
        prefix cache registers that block, so the slot's first decode
        write forks it while every other block of the pool may be the
        slot's own (cached, hence not evictable). Without it a prompt
        that ends inside the slot's last block is preempted and
        re-admitted onto the same cached blocks forever."""
        return self.max_slots * (self.blocks_per_slot() + 1) + 1


@dataclass
class _PrefillJob:
    """Host-side progress of one chunked prefill."""

    req: Request
    tokens: np.ndarray           # prompt (+ replayed generation on resume)
    total: int
    done: int                    # tokens already in the cache
    skip: int                    # 1 on resume: the final select re-derives
    #                              a token already delivered
    key: torch.Tensor            # [2] chain key the final select splits


class ServingEngine:
    """Request-level serving over one decoder model speaking the
    ``generation`` static-cache protocol. ``device=None`` resolves to
    ``cuda``; the model (and the ``draft_model`` of a speculative
    engine) must live on the engine's device."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device=None, draft_model=None, **overrides):
        if config is None:
            config = ServingConfig(**overrides)
        elif overrides:
            raise ValueError("pass ServingConfig OR keyword overrides, not both")
        self.device = resolve_device(device)
        param = next(model.parameters())
        for m in (model, draft_model):
            if m is not None and \
                    next(m.parameters()).device.type != self.device.type:
                raise ValueError(
                    f"the model lives on {next(m.parameters()).device}, the "
                    f"engine on {self.device}: build them on one device")
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

        # per-slot decode state on the device: last token, the next cache
        # write index, the PRNG chain key and the sampling parameters
        # (set by the final prefill chunk); a host mirror of do_sample
        # gates the sampler without reading the device
        dev = self.device
        self._tokens = torch.zeros(B, dtype=torch.long, device=dev)
        self._pos = torch.zeros(B, dtype=torch.int32, device=dev)
        self._keys = torch.zeros((B, 2), dtype=torch.long, device=dev)
        self._ds = torch.zeros(B, dtype=torch.bool, device=dev)
        self._temp = torch.ones(B, dtype=torch.float32, device=dev)
        self._tk = torch.zeros(B, dtype=torch.long, device=dev)
        self._tp = torch.ones(B, dtype=torch.float32, device=dev)
        self._slot_sampling = np.zeros(B, bool)

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
        self.draft_model = draft_model
        self.spec = draft_model is not None
        if self.spec:
            self._init_spec(draft_model)

    def _init_spec(self, draft_model):
        """The speculative lane: the draft's pools (in the configuration's
        ``kv_format``) mirror the target's and are addressed through the
        same block tables, so one allocator, prefix cache and COW drive
        both models' caches."""
        config = self.config
        config.validate_draft(self.model.config, draft_model.config)
        self._spec_tree = config.spec_tree
        if self._spec_tree is not None:
            self._tree = spec_tree_plan(self._spec_tree)
            self._tree_t = _plan_tensors(self._tree, self.device)
            # SamplingParams.spec_k clamps the tree DEPTH on this lane, so
            # the depth bounds it and sizes the accept histogram
            self._spec_k = int(self._tree["depth"])
        else:
            self._tree = None
            self._spec_k = int(config.spec_k)
        # the verify bundle's expected path, recorded once; a decline is
        # counted under spec_<reason> / spec_tree_<reason>
        self._spec_verify_kernel, _ = spec_verify_eligibility(
            self._spec_k, self._dtype, spec_tree=self._spec_tree)
        self._drun = make_cached_runner(draft_model)
        self._dpools = make_paged_kv_pools(
            draft_model.config, self._nblocks, self.config.block_size,
            next(draft_model.parameters()).dtype, config.kv_format,
            device=self.device)
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_rounds = 0
        self._spec_draft_rounds = 0
        # accepted drafts per round, 0..k (the path depth on the tree lane)
        self._accept_hist = [0] * (self._spec_k + 1)

    # -- the three device programs --------------------------------------------
    def _padded_table(self, bt, width: int):
        """The block tables ``bt`` [B, nb] widened by dump-block (block 0)
        columns for a bundle of ``width`` tokens. The bundle is always
        launched at full width, and the paged kernel takes a row's length
        as min(pos + width, table span): without the columns a bundle
        whose padded end passes max_len (a final prefill chunk, a verify
        bundle near the slot's end) would sit at shifted positions. Pad
        tokens write to the dump block and no live row attends them, so
        nothing else changes."""
        pad = -(-(width - 1) // self.config.block_size)
        return np.concatenate(
            [bt, np.zeros((bt.shape[0], pad), np.int32)], axis=1)

    def _chunk(self, bt_row, ids, pos0: int, valid: int, slot: int,
               is_last: bool, last_idx: int, key=None,
               params: Optional[SamplingParams] = None) -> Optional[int]:
        """ONE fixed-shape prefill chunk: forward ``ids`` [1, C] at
        ``pos0`` through the paged caches (pad tokens past ``valid`` write
        to the dump block; the write slots are computed once for all
        layers). The last chunk selects the first token (argmax, or the
        request's sampler with the subkey of ``split(key)``) and sets
        the slot's decode state, its chain key and parameters included;
        returns the token, else None."""
        slots = _paged_flat_indices(bt_row, pos0, valid,
                                    self.config.block_size, 1, ids.shape[1],
                                    self.device)
        caches = [dict(c, bt=bt_row, slots=slots) for c in self._pools]
        logits, _ = self._run(ids, caches, pos0)
        if self.spec:
            # the draft rides along: both models' pools take the chunk
            # through the one block table, so prefix-cached blocks carry
            # both models' K/V and a resumed request re-prefills both
            self._drun(ids, [dict(c, bt=bt_row, slots=slots)
                             for c in self._dpools], pos0)
        self._chunks += 1
        if not is_last:
            return None
        p = params if params is not None else SamplingParams()
        last = logits[:, last_idx]
        if p.do_sample:
            key, sub = prng.split(key).unbind(0)
            token = select_tokens(last, sub[None], [True], [p.temperature],
                                  [p.top_k], [p.top_p])[0]
            self._keys[slot] = key
        else:
            token = last[0].argmax()
        self._tokens[slot] = token
        self._pos[slot] = pos0 + valid
        self._ds[slot] = bool(p.do_sample)
        self._temp[slot] = float(p.temperature)
        self._tk[slot] = int(p.top_k)
        self._tp[slot] = float(p.top_p)
        self._slot_sampling[slot] = bool(p.do_sample)
        return int(token)

    def _sampler(self, active):
        """The rows' sampling parameters (do_sample, temperature, top_k,
        top_p) when a slot of ``active`` samples, else None:
        pure-greedy steps skip the sampler and the key advance (greedy
        rows never read their keys)."""
        if not self._slot_sampling[active].any():
            return None
        return self._ds, self._temp, self._tk, self._tp

    def _step(self, bt, active, params):
        """ONE decode iteration for the whole slot pool through the block
        tables ``bt`` [B, nb] (inactive rows zeroed: their writes land in
        the dump block); free rows pinned to pos 0. With sampling
        ``params`` every slot's key splits once and the per-row sampler
        selects with the subkeys. Returns the [B] next tokens on the
        device."""
        slots = _paged_flat_indices(bt, self._pos, None,
                                    self.config.block_size, bt.shape[0], 1,
                                    self.device)
        caches = [dict(c, bt=bt, slots=slots) for c in self._pools]
        logits, _ = self._run(self._tokens[:, None], caches, self._pos)
        if params is None:
            nxt = logits[:, 0].argmax(dim=-1)
        else:
            self._keys, subs = split_keys(self._keys)
            nxt = rows_select(logits, subs[:, None], params)[:, 0]
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
        when quantized; the draft's pools too)."""
        with torch.no_grad():
            for c in self._pools + (self._dpools if self.spec else []):
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
        # With prefix caching, a write into a cached partial block forks
        # it while the slot still holds every other block: the prompt's
        # own registered tail at the first decode write, or a matched
        # partial tail during a (resumed) prefill. The cache keeps the
        # old block until the fork is done, so a slot may need one block
        # beyond its span; without it, reclaim frees nothing and the
        # request preempts itself onto the same cached blocks forever.
        need = worst + (self.prefix_cache is not None)
        if need > self.pool.usable_blocks:
            raise ValueError(
                f"prompt ({L}) + max_new_tokens ({params.max_new_tokens}) "
                f"needs up to {need} KV blocks of {bs} tokens (a copy-on-"
                f"write fork included when prefix caching is on), but the "
                f"pool only has {self.pool.usable_blocks} usable blocks")
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
        self._slot_sampling[slot] = False

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
        """Seed-deterministic resume state for the slot's occupant:
        mid-prefill restarts the same chunk job; mid-decode folds the
        generated tokens but the last into the next prefill, with the
        PRNG chain of the request's seed split g - 1 times (the key
        before the last delivered token), so the resumed prefill's final
        select re-derives that token (skipped, never re-delivered) and
        the decode goes on bit-identical."""
        req = self._slot_req[slot]
        job = self._jobs[slot]
        if job is not None:
            req._resume = (job.tokens, job.key, job.skip)
            return
        g = len(req.output_tokens)
        if g == 0:
            req._resume = None
            return
        # greedy rows never read the key
        key = prng.chain_key(req.params.seed,
                             g - 1 if req.params.do_sample else 0,
                             self.device)
        tokens = np.concatenate(
            [req.prompt, np.asarray(req.output_tokens[:g - 1], np.int32)])
        req._resume = (tokens, key, 1)

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
        tokens, key, skip = resume if resume is not None else (
            req.prompt, prng.PRNGKey(req.params.seed, self.device), 0)
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
                                       done=matched_tok, skip=skip, key=key)
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
            torch.from_numpy(self._padded_table(self._bt[slot:slot + 1], C))
            .to(self.device),
            torch.from_numpy(ids).to(self.device), start, end - start, slot,
            is_last, job.total - 1 - start, job.key, req.params)
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

        # every active row writes this step's K/V at its current length,
        # or, speculatively, its whole bundle window [len, len + width):
        # crossing a block boundary allocates, a shared block forks;
        # allocation pressure preempts the latest-admitted request
        bs = self.config.block_size
        for i in list(active):
            if self._slot_req[i] is None or not self._decoding[i]:
                continue  # preempted by an earlier row's reclaim
            # _row_spec_len depends on host state that holds until the
            # dispatch, so the bundle never writes past this coverage
            m = self._row_spec_len(i) if self.spec else 1
            try:
                for bi in range(self._slot_len[i] // bs,
                                (self._slot_len[i] + m - 1) // bs + 1):
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
        params = self._sampler(active)
        if self.spec:
            return self._spec_step(active, active_mask, bt_step, params)
        toks = self._step(torch.from_numpy(bt_step).to(self.device),
                          torch.from_numpy(active_mask).to(self.device),
                          params)
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

    # -- the speculative iteration ---------------------------------------------
    def _row_spec_len(self, slot: int) -> int:
        """Live bundle width of one decoding slot this round: 1 + its
        draft count, clamped by the request's own ``spec_k`` (0 -> width
        1, a plain decode step riding the bundle), its remaining token
        budget and the slot's KV room. On the tree lane the request's
        spec_k clamps the DEPTH and the width is that BFS prefix."""
        req = self._slot_req[slot]
        p = req.params
        k_req = self._spec_k if p.spec_k is None \
            else max(0, min(int(p.spec_k), self._spec_k))
        remaining = p.max_new_tokens - len(req.output_tokens)
        room = self.config.max_len - self._slot_len[slot]
        if self._spec_tree is not None:
            depth_cap = max(0, min(k_req, remaining - 1))
            width = int(self._tree["offsets"][depth_cap + 1])
            return max(1, min(width, room))
        return max(1, min(k_req + 1, remaining, room))

    def _caches(self, pools, bt, pos, valid, n: int):
        """Per-layer cache dicts of ``pools`` for a forward of ``n``
        tokens per row at ``pos``: tokens past each row's ``valid`` write
        to the dump block; on the tree lane the n-node ancestor mask and
        depths ride along."""
        slots = _paged_flat_indices(bt, pos, valid, self.config.block_size,
                                    bt.shape[0], n, self.device)
        if self._spec_tree is not None:
            return _with_tree(pools, self._tree, self._tree_t, n,
                              bt.shape[0], bt=bt, slots=slots)
        return [dict(c, bt=bt, slots=slots) for c in pools]

    def _draft_chain(self, bt, spec_valid, subs, params):
        """k cached draft forwards (q_len 1) proposing the bundle's draft
        tokens, draft j with the chain subkey ``subs[:, j]`` the verify
        selects position j with (common-noise coupling), then a
        write-only forward of the last one (a full accept advances past
        pos + k, whose draft K/V would otherwise be a hole). Returns
        [B, k]."""
        k = self._spec_k
        tok, pos, drafts = self._tokens, self._pos, []
        for j in range(k + 1):
            logits, _ = self._drun(
                tok[:, None],
                self._caches(self._dpools, bt, pos + j,
                             torch.clamp(spec_valid - j, min=0), 1),
                pos + j)
            if j < k:
                tok = rows_select(logits, None if subs is None
                                  else subs[:, j:j + 1], params)[:, 0]
                drafts.append(tok)
        return torch.stack(drafts, dim=1)

    def _verify(self, bt, drafts, spec_valid, active, levels, subs, params):
        """ONE target forward over the [B, width] bundle (the paged
        kernel's q_len > 1 path; the tree lane under its ancestor mask),
        each position selecting with its chain subkey (a tree node with
        its depth's), the accept walk, and the state update: each row
        advances by its own emit count and commits its chain at
        ``levels[:, n_emit]``. The tree lane then moves the accepted
        path's K/V onto consecutive positions in both models' pools.
        Returns (the emitted tokens [B, >= n_emit], n_emit [B])."""
        pos = self._pos
        bundle = torch.cat([self._tokens[:, None], drafts], dim=1)
        logits, _ = self._run(bundle, self._caches(
            self._pools, bt, pos, spec_valid, bundle.shape[1]), pos)
        if subs is not None and self._spec_tree is not None:
            subs = subs[:, self._tree_t["depth_vec"].long()]
        cand = rows_select(logits, subs, params)
        if self._spec_tree is not None:
            n_emit, path, emitted, last = tree_accept(
                bundle, cand, spec_valid, self._tree, self._tree_t)
            src, dst = path_commit(pos, path, n_emit)
            bs = self.config.block_size
            btl = bt.long()

            def flat(tok):
                blk = torch.clamp(tok // bs, 0, bt.shape[1] - 1)
                return btl.gather(1, blk) * bs + tok % bs

            kv_path_move(self._pools + self._dpools, flat(src), flat(dst))
        else:
            n_emit = spec_accept_length(drafts, cand, spec_valid)
            emitted = cand
            last = cand.gather(1, (n_emit - 1).clamp(min=0)[:, None])[:, 0]
        if levels is not None:
            self._keys = _commit_keys(levels, n_emit)
        self._tokens = torch.where(n_emit > 0, last, self._tokens)
        self._pos = torch.where(
            active, torch.clamp(pos + n_emit, max=self.config.max_len - 1),
            torch.zeros((), dtype=torch.long, device=self.device)
        ).to(torch.int32)
        return emitted, n_emit

    def _spec_step(self, active, active_mask, bt_step, params) -> bool:
        """One speculative iteration for the whole pool: the draft (k
        forwards on the chain lane, depth + 1 on the tree lane; skipped
        when no live row wants more than a plain step), then ONE verify;
        with sampling ``params`` both select with the chain walked
        ahead. Delivers each row's emitted tokens."""
        B = self.config.max_slots
        spec_valid = np.zeros(B, np.int64)
        for i in active:
            spec_valid[i] = self._row_spec_len(i)
        tree = self._spec_tree is not None
        width = int(self._tree["nodes"]) if tree else self._spec_k + 1
        bt = torch.from_numpy(self._padded_table(bt_step, width)) \
            .to(self.device)
        sv = torch.from_numpy(spec_valid).to(self.device)
        levels = subs = None
        if params is not None:
            # a token per level: k + 1 on the chain, depth + 1 on the tree
            levels, subs = split_key_levels(self._keys, self._spec_k + 1)
        with torch.no_grad():
            if (spec_valid > 1).any():
                if tree:
                    drafts = draft_tree(
                        self._drun,
                        lambda n: self._caches(self._dpools, bt, self._pos,
                                               torch.clamp(sv, max=n), n),
                        self._tokens, self._pos, self._tree, subs,
                        params)[:, 1:]
                else:
                    drafts = self._draft_chain(bt, sv, subs, params)
                self._spec_draft_rounds += 1
            else:
                drafts = torch.zeros((B, width - 1), dtype=torch.long,
                                     device=self.device)
            emitted, n_emit = self._verify(
                bt, drafts, sv, torch.from_numpy(active_mask).to(self.device),
                levels, subs, params)
        em_np = emitted.cpu().numpy()   # the round's device->host sync
        n_np = n_emit.cpu().numpy()
        now = time.perf_counter()
        _sm.inc("steps_total")
        self._steps += 1
        self._spec_rounds += 1
        for i in active:
            req = self._slot_req[i]
            n = int(n_np[i])
            drafted = int(spec_valid[i]) - 1
            accepted = n - 1
            if drafted > 0:
                self._spec_drafted += drafted
                self._spec_accepted += accepted
                req.spec_drafted += drafted
                req.spec_accepted += accepted
                _sm.inc("spec_drafted_tokens", drafted)
                _sm.inc("spec_accepted_tokens", accepted)
                _sm.inc("spec_rejected_tokens", drafted - accepted)
                _sm.observe("spec_accept_len", accepted)
                if tree:
                    # on the tree lane ``accepted`` is the accepted path's
                    # depth: one draft node per committed level
                    _sm.inc("spec_tree_nodes_drafted", drafted)
                    _sm.inc("spec_tree_nodes_accepted", accepted)
                    _sm.observe("spec_accept_depth", accepted)
                self._accept_hist[accepted] += 1
            self._slot_len[i] = min(self._slot_len[i] + n,
                                    self.config.max_len - 1)
            for j in range(n):
                t = int(em_np[i, j])
                req.push_token(t, now)
                _sm.inc("tokens_total", label="generated")
                if self._finish_or_keep(i, req, t, now):
                    break
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

    def spec_stats(self) -> dict:
        """Speculative-lane accounting: engine-lifetime drafted, accepted
        and rejected totals, the accept rate and the accept-length digest
        (exact percentiles over this engine's rounds)."""
        if not self.spec:
            return {"enabled": False}
        hist = self._accept_hist
        count = sum(hist)
        total = sum(i * n for i, n in enumerate(hist))

        def _pct(p):
            target, seen = p * count, 0
            for i, n in enumerate(hist):
                seen += n
                if seen >= target:
                    return float(i)
            return float(len(hist) - 1)

        out = {
            "enabled": True,
            "mode": "tree" if self._spec_tree is not None else "chain",
            "k": self._spec_k,
            "verify_kernel": self._spec_verify_kernel,
            "rounds": self._spec_rounds,
            "draft_rounds": self._spec_draft_rounds,
            "drafted_tokens": self._spec_drafted,
            "accepted_tokens": self._spec_accepted,
            "rejected_tokens": self._spec_drafted - self._spec_accepted,
            "accept_rate": (self._spec_accepted / self._spec_drafted
                            if self._spec_drafted else None),
            "queue_spec_opted_out": self.scheduler.depth_spec_opted_out(),
            "accept_len": {
                **({f"p{round(p * 100)}": _pct(p)
                    for p in (0.5, 0.95, 0.99)} if count else {}),
                "hist": list(hist),
                "mean": (total / count) if count else None,
                "count": count},
        }
        if self._spec_tree is not None:
            # drafted/accepted count NODES on this lane (most siblings lose
            # by construction); the accepted path depth is the signal
            out["tree"] = {
                "factors": list(self._spec_tree),
                "depth": int(self._tree["depth"]),
                "nodes": int(self._tree["nodes"]),
                "drafted_nodes": self._spec_drafted,
                "accepted_nodes": self._spec_accepted,
                # +1: the root's own target token commits with the path
                "mean_accepted_path_len":
                    (total / count) + 1.0 if count else None,
            }
        return out

    def stats(self) -> dict:
        """Host-side counts: iterations, pool and prefix-cache state, and
        the speculative lane's (``spec``)."""
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
            "spec": self.spec_stats(),
        }
