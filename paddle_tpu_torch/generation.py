"""KV caches and generation (counterpart of the serving subset of
``paddle_tpu/generation.py``).

Caches are pre-allocated per layer: contiguous ``{"k", "v"}`` buffers
[B, max_len, kv_heads, d] (``make_kv_caches``) or paged pools
[num_blocks, block_size, kv_heads, d] addressed through per-row int32
block tables (``make_paged_kv_pools``). Unlike the JAX package, whose
arrays are immutable, the writes here update the buffers IN PLACE
(``index_copy_`` / slice assignment) and hand the same tensors back, so
a step costs no copy of the cache.

``kv_format="int8"`` / ``"fp8"`` stores K/V narrow (int8, float8 e4m3)
with per-token-per-head f32 absmax scales ``ks``/``vs`` beside them
([.., kv_heads], the cache's shape without the head dimension): a write
quantizes each token's head vector by its own absmax
(``*_write_quant``), the flash-decode kernels dequantize where they
load, and the plain attention reads a dequantized view
(``dequantize_kv_buffer``, ``gather_paged_kv_dequant``). The storage
dtype is the format (``kv_format_of``).

``generate`` prefills the prompts (equal-length, or ragged and
left-padded under ``pad_token_id``) in one cached forward, then runs one
cached forward per token in a Python loop, with EOS masking; ``stream``
yields the tokens as they land. Tokens are greedy, or sampled with
temperature / top-k / top-p (``_select_token``; ``select_tokens`` per
row) on the JAX package's threefry key chain (``prng``), so a seed gives
the reference's tokens. With ``draft_model=`` it decodes speculatively
(``_generate_speculative``: a draft chain of ``spec_k`` tokens a round,
or ``_generate_speculative_tree``: a draft token tree of ``spec_tree``
branching factors, scored by the target in one cached forward under the
tree's ancestor mask); draft and target select with the same subkeys, so
the tokens equal plain decode, greedy or sampled, and the draft only
decides how far a round advances.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import prng
from .kernels.decode_attention import ancestor_visibility
from .quantization.intx import (KV_FORMATS, absmax_along, format_dtype,
                                format_itemsize, format_of_dtype,
                                pack_absmax, unpack_absmax)

__all__ = ["GenerationConfig", "generate", "generate_uncached",
           "make_kv_caches", "select_tokens", "split_keys",
           "split_key_levels",
           "spec_accept_length", "spec_tree_plan", "truncated_draft",
           "make_paged_kv_pools", "kv_cache_write", "paged_kv_cache_write",
           "kv_cache_write_quant", "paged_kv_cache_write_quant",
           "gather_paged_kv", "gather_paged_kv_dequant",
           "dequantize_kv_buffer", "update_static_kv_cache",
           "make_cached_runner", "kv_cache_bytes_per_token", "kv_format_of"]


def _is_per_row(position_offset) -> bool:
    """True for a per-row [B] position vector (the serving engine's
    decode step), False for a shared scalar."""
    return isinstance(position_offset, torch.Tensor) \
        and position_offset.dim() == 1


def _check_format(kv_format: str) -> None:
    if kv_format not in KV_FORMATS:
        raise ValueError(
            f"kv_format must be one of {KV_FORMATS}, got {kv_format!r}")
    if kv_format != "bf16":
        format_dtype(kv_format)  # actionable error when fp8 is absent


def kv_format_of(buf) -> str:
    """Storage format of a KV buffer, from its dtype (int8/fp8 storage IS
    the format; anything else is "bf16", the unquantized cache)."""
    return format_of_dtype(buf.dtype)


def _bytes(t):
    """A narrow buffer as its bytes (index and copy kernels for fp8 are
    not in every build); other buffers as they are."""
    return t.view(torch.uint8) if t.element_size() == 1 \
        and t.is_floating_point() else t


def _row_window(position_offset, s: int, max_len: int, device):
    """[b, s] cache positions of a per-row write: row b's window starts
    at its offset, clamped so the window fits (the start clamp of the
    JAX package's dynamic_update_slice)."""
    start = position_offset.to(device).long().clamp(0, max_len - s)
    return start[:, None] + torch.arange(s, device=device)[None, :]


def _write_rows(buf, new, position_offset):
    """``new`` [b, s, ...] into ``buf`` [b, max_len, ...] at the shared
    or per-row ``position_offset``; in place."""
    s = new.shape[1]
    if _is_per_row(position_offset):
        idx = _row_window(position_offset, s, buf.shape[1], buf.device)
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        _bytes(buf)[rows, idx] = _bytes(new.to(buf.dtype))
    else:
        off = int(position_offset)
        _bytes(buf)[:, off:off + s] = _bytes(new.to(buf.dtype))
    return buf


def kv_cache_write(buf, new, position_offset):
    """Write a step's [b, s, h, d] block into the [b, max_len, h, d]
    buffer at the shared ``position_offset`` or, per row, at a [b]
    offset vector; in place."""
    return _write_rows(buf, new, position_offset)


def _quantize_step(new, kv_format: str):
    """A step's [b, s, h, d] block quantized per token per head: (narrow
    values, f32 absmax [b, s, h])."""
    amax = absmax_along(new, -1)
    return pack_absmax(new, amax[..., None], kv_format), amax


def kv_cache_write_quant(buf, scales, new, position_offset,
                         kv_format: str = "int8"):
    """Contiguous twin of ``paged_kv_cache_write_quant``: quantize the
    step's [b, s, h, d] block per token per head and write the values
    into the int8/fp8 [b, max_len, h, d] buffer and the absmax into the
    [b, max_len, h] f32 scales at ``position_offset`` (shared or per
    row); in place. Returns (buf, scales)."""
    q, amax = _quantize_step(new, kv_format)
    _write_rows(buf, q, position_offset)
    _write_rows(scales, amax, position_offset)
    return buf, scales


def _causal_cache_mask(position_offset, s: int, max_len: int, device):
    """Additive fp32 causal mask over ``max_len`` cache positions for
    ``s`` queries starting at ``position_offset``: [1, 1, s, max_len], or
    [b, 1, s, max_len] for per-row offsets."""
    kpos = torch.arange(max_len, device=device)
    ar = torch.arange(s, device=device)
    if _is_per_row(position_offset):
        po = position_offset.to(device).long()
        qpos = po[:, None] + ar                                 # [b, s]
        m = (kpos[None, None, :] <= qpos[:, :, None]) \
            & (kpos[None, None, :] < (po[:, None, None] + s))
        m = m[:, None]
    else:
        off = int(position_offset)
        qpos = off + ar
        m = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < off + s)
        m = m[None, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), -1e30, dtype=torch.float32, device=device)
    return torch.where(m, zero, neg)


def _tree_cache_mask(position_offset, s: int, max_len: int, tree_mask,
                     device):
    """Tree-speculative variant of ``_causal_cache_mask``: the ``s``
    query rows are the flattened draft-tree bundle at cache slots
    ``position_offset + i``, and ``tree_mask`` [b, s, s] (bool, True =
    visible) says which bundle slots are each node's ancestors. A node
    sees every past position (< offset) plus its ancestor-or-self set
    inside the bundle, never a sibling branch. Additive fp32
    [b, 1, s, max_len]."""
    if tree_mask.dim() != 3 or tuple(tree_mask.shape[1:]) != (s, s):
        raise ValueError(
            f"tree_mask must be [batch, {s}, {s}] (one bool row per "
            f"bundle node), got shape {tuple(tree_mask.shape)}")
    po = torch.as_tensor(position_offset, device=device).long()
    if po.dim() == 0:
        po = po.expand(tree_mask.shape[0])
    m = ancestor_visibility(po, tree_mask.to(device=device,
                                             dtype=torch.bool), max_len)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), -1e30, dtype=torch.float32, device=device)
    return torch.where(m[:, None], zero, neg)


def _cache_mask(kv_cache, position_offset, s: int, max_len: int, device):
    """The additive cache mask of this step: the tree-ancestor mask when
    the cache dict carries one (a speculative draft tree), else the
    causal mask."""
    tm = kv_cache.get("tree_mask")
    if tm is not None:
        return _tree_cache_mask(position_offset, s, max_len, tm, device)
    return _causal_cache_mask(position_offset, s, max_len, device)


def kv_cache_bytes_per_token(config, kv_format: str = "bf16",
                             dtype=torch.float32) -> int:
    """Device bytes one cached token costs across all layers: K + V
    values and, for quantized formats, their per-token-per-head f32
    absmax scales."""
    _check_format(kv_format)
    n_kv = config.num_key_value_heads
    head_dim = config.hidden_size // config.num_attention_heads
    if kv_format == "bf16":
        per = n_kv * head_dim * torch.empty((), dtype=dtype).element_size()
    else:
        per = n_kv * (head_dim * format_itemsize(kv_format) + 4)
    return 2 * per * config.num_hidden_layers


def _zeros(shape, dtype, device):
    """Zeros of ``dtype``; narrow floats are made as zero bytes."""
    if torch.empty((), dtype=dtype).element_size() == 1 \
            and dtype.is_floating_point:
        return torch.zeros(shape, dtype=torch.uint8,
                           device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def _make_layers(config, lead, dtype, kv_format, device):
    """Per-layer {"k", "v"} zeros [*lead, kv_heads, head_dim], plus
    {"ks", "vs"} f32 scales [*lead, kv_heads] for a quantized format."""
    _check_format(kv_format)
    n_kv = config.num_key_value_heads
    shape = tuple(lead) + (n_kv,
                           config.hidden_size // config.num_attention_heads)
    if kv_format == "bf16":
        return [{"k": _zeros(shape, dtype, device),
                 "v": _zeros(shape, dtype, device)}
                for _ in range(config.num_hidden_layers)]
    sdt = format_dtype(kv_format)
    sshape = tuple(lead) + (n_kv,)
    return [{"k": _zeros(shape, sdt, device), "v": _zeros(shape, sdt, device),
             "ks": _zeros(sshape, torch.float32, device),
             "vs": _zeros(sshape, torch.float32, device)}
            for _ in range(config.num_hidden_layers)]


def make_kv_caches(config, batch_size: int, max_len: int, dtype,
                   kv_format: str = "bf16", device=None):
    """Per-layer contiguous {"k", "v"} zeros [batch_size, max_len,
    num_key_value_heads, head_dim]; ``kv_format="int8"``/``"fp8"`` stores
    narrow values plus ``ks``/``vs`` f32 scales [batch_size, max_len,
    num_key_value_heads]."""
    return _make_layers(config, (batch_size, max_len), dtype, kv_format,
                        device)


def make_paged_kv_pools(config, num_blocks: int, block_size: int, dtype,
                        kv_format: str = "bf16", device=None):
    """Per-layer paged {"k", "v"} zeros [num_blocks, block_size,
    num_key_value_heads, head_dim]; a quantized format adds ``ks``/``vs``
    f32 scale pools [num_blocks, block_size, num_key_value_heads] riding
    the same blocks. Block 0 is the dump block."""
    return _make_layers(config, (num_blocks, block_size), dtype, kv_format,
                        device)


def _paged_flat_indices(bt, po, vl, bs: int, b: int, s: int, device):
    """Flat [b, s] pool indices: token j of row b lands at
    ``bt[b, (pos_b + j) // bs] * bs + (pos_b + j) % bs`` (the column
    clamped to the table); tokens past ``valid`` route to flat slot 0,
    inside the dump block."""
    if isinstance(po, torch.Tensor):
        pos = po.to(device=device, dtype=torch.long)
        if pos.dim() == 0:
            pos = pos.expand(b)
    else:
        pos = torch.full((b,), int(po), dtype=torch.long, device=device)
    tpos = pos[:, None] + torch.arange(s, device=device)[None, :]
    blk = torch.clamp(tpos // bs, 0, bt.shape[1] - 1)
    phys = torch.gather(bt.to(device).long(), 1, blk)
    idx = phys * bs + tpos % bs
    if vl is not None:
        va = vl.to(device).long() if isinstance(vl, torch.Tensor) \
            else torch.tensor(int(vl), device=device)
        if va.dim() == 0:
            va = va.expand(b)
        idx = torch.where(tpos < (pos + va)[:, None], idx,
                          torch.zeros((), dtype=torch.long, device=device))
    return idx


def paged_kv_cache_write(pool, new, block_table, position_offset,
                         valid_len=None):
    """Scatter a step's [b, s, h, d] K-or-V block into the shared
    [num_blocks, block_size, h, d] pool through the block table, in
    place; ``valid_len`` (scalar or [b]) caps the real tokens, the rest
    go to the dump block. Returns the pool."""
    idx = _paged_flat_indices(block_table, position_offset, valid_len,
                              pool.shape[1], new.shape[0], new.shape[1],
                              pool.device)
    return _scatter_flat(pool, new, idx)


def _scatter_flat(pool, new, idx):
    """Write [b, s, ...] ``new`` into the pool at flat slots ``idx``
    [b, s] (in place); returns the pool."""
    num_blocks, bs = pool.shape[0], pool.shape[1]
    b, s = new.shape[0], new.shape[1]
    flat = _bytes(pool).view((num_blocks * bs,) + tuple(pool.shape[2:]))
    src = _bytes(new.to(pool.dtype))
    flat.index_copy_(0, idx.reshape(-1),
                     src.reshape((b * s,) + tuple(new.shape[2:])))
    return pool


def _scatter_flat_quant(pool, scales, new, idx, kv_format: str):
    """Quantize [b, s, h, d] ``new`` per token per head and write values
    and absmax scales at flat slots ``idx`` (in place)."""
    q, amax = _quantize_step(new, kv_format)
    _scatter_flat(pool, q, idx)
    _scatter_flat(scales, amax, idx)
    return pool, scales


def paged_kv_cache_write_quant(pool, scales, new, block_table,
                               position_offset, valid_len=None,
                               kv_format: str = "int8"):
    """The quantizing scatter: quantize this step's [b, s, h, d] K-or-V
    block PER TOKEN PER HEAD (absmax over d, so a later token never
    forces a written one to be requantized) and scatter values into the
    int8/fp8 pool and scales into the [num_blocks, block_size, h] f32
    scale pool through the block table, in place; pads past
    ``valid_len`` go to the dump block. Returns (pool, scales)."""
    idx = _paged_flat_indices(block_table, position_offset, valid_len,
                              pool.shape[1], new.shape[0], new.shape[1],
                              pool.device)
    return _scatter_flat_quant(pool, scales, new, idx, kv_format)


def gather_paged_kv(pool, block_table):
    """The slot-major [b, nb * block_size, h, d] view of the pool through
    the block tables (the plain-attention read path)."""
    bt = block_table.to(pool.device).long()
    out = _bytes(pool)[bt]
    b, nb, bs = out.shape[0], out.shape[1], out.shape[2]
    return out.reshape((b, nb * bs) + tuple(pool.shape[2:])).view(pool.dtype)


def dequantize_kv_buffer(buf, scales, out_dtype=torch.float32):
    """Dense dequantized view of a quantized contiguous cache (the plain
    read path): [b, max_len, h, d] storage + [b, max_len, h] absmax
    scales -> float [b, max_len, h, d]."""
    return unpack_absmax(buf, scales[..., None], kv_format_of(buf),
                         out_dtype)


def gather_paged_kv_dequant(pool, scales, block_table,
                            out_dtype=torch.float32):
    """Quantized-pool twin of ``gather_paged_kv``: the slot-major view,
    dequantized (on the kernel path the dequant happens in the kernel
    and this copy never exists)."""
    return unpack_absmax(gather_paged_kv(pool, block_table),
                         gather_paged_kv(scales, block_table)[..., None],
                         kv_format_of(pool), out_dtype)


def _update_paged_kv_cache(kv_cache: dict, k, v, position_offset,
                           build_mask: bool, gather: bool):
    bt = kv_cache["bt"]
    idx = kv_cache.get("slots")
    if idx is None:
        idx = _paged_flat_indices(bt, position_offset, kv_cache.get("valid"),
                                  kv_cache["k"].shape[1], k.shape[0],
                                  k.shape[1], k.device)
    quant = "ks" in kv_cache
    if quant:
        fmt = kv_format_of(kv_cache["k"])
        ck, cks = _scatter_flat_quant(kv_cache["k"], kv_cache["ks"], k, idx,
                                      fmt)
        cv, cvs = _scatter_flat_quant(kv_cache["v"], kv_cache["vs"], v, idx,
                                      fmt)
        new_cache = dict(kv_cache, k=ck, v=cv, ks=cks, vs=cvs)
    else:
        ck = _scatter_flat(kv_cache["k"], k, idx)
        cv = _scatter_flat(kv_cache["v"], v, idx)
        new_cache = dict(kv_cache, k=ck, v=cv)
    max_len = int(bt.shape[1]) * int(ck.shape[1])
    mask = _cache_mask(kv_cache, position_offset, k.shape[1], max_len,
                       k.device) if build_mask else None
    if gather:
        if quant:
            return (gather_paged_kv_dequant(ck, cks, bt, k.dtype),
                    gather_paged_kv_dequant(cv, cvs, bt, k.dtype),
                    new_cache, mask)
        return gather_paged_kv(ck, bt), gather_paged_kv(cv, bt), new_cache, mask
    return ck, cv, new_cache, mask


def update_static_kv_cache(kv_cache: dict, k, v, position_offset,
                           build_mask: bool = True, gather: bool = True):
    """Write this step's k/v [b, s, h, d] into the cache (in place) and,
    unless ``build_mask=False``, build the additive causal mask exposing
    positions < offset + s (the tree-ancestor mask when the dict carries
    a draft tree's ``tree_mask``). Returns (k_full, v_full, new_cache,
    mask).

    Paged caches (the dict carries a ``"bt"`` block table and, for
    chunked prefill, ``"valid"``) scatter through the table, or through
    the flat ``"slots"`` [b, s] of ``_paged_flat_indices`` when the
    caller computed them once for every layer; with
    ``gather=True`` the slot-major view is materialized for the plain
    attention, with ``gather=False`` the pools come back as they are
    for the paged kernel.

    Quantized caches (``ks``/``vs`` in the dict) quantize the write; the
    gathered view comes back dequantized into k's dtype, the raw view as
    the narrow buffers (their scales are in ``new_cache``)."""
    if "bt" in kv_cache:
        return _update_paged_kv_cache(kv_cache, k, v, position_offset,
                                      build_mask, gather)
    if "ks" in kv_cache:
        fmt = kv_format_of(kv_cache["k"])
        ck, cks = kv_cache_write_quant(kv_cache["k"], kv_cache["ks"], k,
                                       position_offset, fmt)
        cv, cvs = kv_cache_write_quant(kv_cache["v"], kv_cache["vs"], v,
                                       position_offset, fmt)
        new_cache = dict(kv_cache, k=ck, v=cv, ks=cks, vs=cvs)
        mask = _cache_mask(kv_cache, position_offset, k.shape[1],
                           ck.shape[1], k.device) if build_mask else None
        if gather:
            return (dequantize_kv_buffer(ck, cks, k.dtype),
                    dequantize_kv_buffer(cv, cvs, k.dtype), new_cache, mask)
        return ck, cv, new_cache, mask
    ck = kv_cache_write(kv_cache["k"], k, position_offset)
    cv = kv_cache_write(kv_cache["v"], v, position_offset)
    mask = _cache_mask(kv_cache, position_offset, k.shape[1], ck.shape[1],
                       k.device) if build_mask else None
    return ck, cv, dict(kv_cache, k=ck, v=cv), mask


def _mask_after_eos(gen, eos_id: int):
    """Replace everything after the first EOS with EOS."""
    is_eos = (gen == eos_id).long()
    seen = torch.cumsum(is_eos, dim=1) - is_eos
    return torch.where(seen > 0, torch.full_like(gen, eos_id), gen)


@dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: int = 0


def make_cached_runner(model):
    """The cached forward shared by ``generate`` and the serving engine:
    ``run(token_ids, caches, pos, attn_mask=None)`` -> (logits,
    new_caches) under ``torch.no_grad``. ``pos`` is an int or a per-row
    [B] tensor."""

    def run(token_ids, caches, pos, attn_mask=None):
        with torch.no_grad():
            return model(token_ids, attn_mask=attn_mask, kv_caches=caches,
                         position_offset=pos)

    return run


# ---------------------------------------------------------------------------
# sampling: the JAX package's token selection on its threefry key chain
# ---------------------------------------------------------------------------

# XLA:CPU rewrites a cumulative sum into a scan over blocks of this many
# elements: a sequential prefix inside each block, the same scan over the
# block totals, and each block's exclusive prefix added back
_SCAN_BASE = 16


def _scan_cumsum(x):
    """``jnp.cumsum`` over the last axis with XLA:CPU's order of adds
    (``_SCAN_BASE`` blocks, recursively), every add rounded to ``x``'s
    dtype: bit-equal to the reference in float32 and in bfloat16, on the
    CPU and on the card (torch's own cumsum accumulates a bfloat16 scan
    in float32, and in another order on CUDA)."""
    n = x.shape[-1]
    if n <= _SCAN_BASE:
        out = x.clone()
        for j in range(1, n):
            out[..., j] += out[..., j - 1]
        return out
    m = -(-n // _SCAN_BASE)
    xp = torch.nn.functional.pad(x, (0, m * _SCAN_BASE - n))
    within = _scan_cumsum(xp.reshape(x.shape[:-1] + (m, _SCAN_BASE)))
    tot = _scan_cumsum(within[..., -1].contiguous())
    excl = torch.nn.functional.pad(tot[..., :-1], (1, 0))
    return (within + excl[..., None]).reshape(
        x.shape[:-1] + (m * _SCAN_BASE,))[..., :n]


def _softmax(x):
    """``jax.nn.softmax`` over the last axis in ``x``'s dtype: exp of the
    max-shifted values (taken in float64 and rounded, so it is the same
    on every device), divided by their sum (taken in float32 and rounded
    back for narrow floats, as ``jnp.sum`` does)."""
    e = torch.exp((x - x.amax(dim=-1, keepdim=True)).double()).to(x.dtype)
    return e / e.sum(dim=-1, keepdim=True, dtype=torch.float32).to(x.dtype)


def _scalar(v, dtype, device):
    """A Python number as the reference's weakly typed scalar: float32
    first, then ``dtype`` (a fill on the device, not a host copy)."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=device).to(dtype)


def _nucleus_cutoff(sd, top_p):
    """Smallest value of the descending ``sd`` still inside the nucleus
    (the cumulative probability before it is below ``top_p``), [B, 1]."""
    probs = _softmax(sd)
    cum = _scan_cumsum(probs)
    inside = cum - probs < top_p
    inf = torch.full((), float("inf"), dtype=sd.dtype, device=sd.device)
    return torch.where(inside, sd, inf).amin(dim=-1, keepdim=True)


def _static_filter(logits, cfg: GenerationConfig):
    """The sampling filter of ``_select_token``: temperature, then top-k
    and top-p as -1e30 fills, in the logits' dtype (in bfloat16 the
    temperature and top_p round to it, as the reference's weakly typed
    scalars do)."""
    dt, dev = logits.dtype, logits.device
    neg = _scalar(-1e30, dt, dev)
    logits = logits / _scalar(max(cfg.temperature, 1e-6), dt, dev)
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = torch.where(logits < kth, neg, logits)
    if cfg.top_p < 1.0:
        sd = torch.sort(logits, dim=-1, descending=True).values
        cutoff = _nucleus_cutoff(sd, _scalar(cfg.top_p, dt, dev))
        logits = torch.where(logits < cutoff, neg, logits)
    return logits


def _select_token(logits, cfg: GenerationConfig, key):
    """logits [B, V] -> next token [B] under the static ``cfg``: argmax,
    or a draw over the filtered logits with ONE key for the whole
    [B, V] (its counters run flat over it)."""
    if not cfg.do_sample:
        return logits.argmax(dim=-1)
    return prng.categorical(key, _static_filter(logits, cfg))


def split_keys(keys):
    """Per-row PRNG advance: [B, 2] keys -> (new_keys [B, 2], subkeys
    [B, 2]), each row ``jax.random.split`` of that row's key, so a slot's
    chain inside a batched step is the ``key, sub = split(key)`` chain
    ``generate`` walks for one request."""
    pairs = prng.split(keys)
    return pairs[:, 0], pairs[:, 1]


def split_key_levels(keys, n: int):
    """The per-row chain walked ``n`` levels ahead without committing:
    [B, 2] -> (levels [B, n + 1, 2], subs [B, n, 2]); ``levels[:, j]`` is
    each row's key after j splits and ``subs[:, j]`` the subkey of the
    (j + 1)-th emitted token. A speculative verify selects with these and
    commits the chain at ``levels[:, n_emit]``: one split per emitted
    token, so a slot's key stays a function of (seed, tokens emitted)."""
    levels, subs = [keys], []
    for _ in range(n):
        keys, sub = split_keys(keys)
        levels.append(keys)
        subs.append(sub)
    return torch.stack(levels, dim=1), torch.stack(subs, dim=1)


def select_tokens(logits, keys, do_sample, temperature, top_k, top_p):
    """Per-row selection with per-row parameters: [B, V] logits, [B, 2]
    keys and [B] ``do_sample`` / ``temperature`` / ``top_k`` / ``top_p``
    (float32, as the reference's state holds them) -> [B] tokens. Row by
    row the math is ``_select_token`` on that row alone with its own key,
    so mixed greedy and sampled rows share one call. ``top_k <= 0`` and
    ``top_p >= 1`` disable their filters. The division by a float32
    temperature promotes bfloat16 logits: the filter and the draw run in
    float32.

    The filter sorts each whole row. The reference's top-256 fast path
    builds the same masked sorted array whenever it applies, so one
    path gives its tokens in both of its cases."""
    dev = logits.device
    ds = torch.as_tensor(do_sample, device=dev).bool()
    temp = torch.as_tensor(temperature, device=dev).float()
    tk = torch.as_tensor(top_k, device=dev).long()
    tp = torch.as_tensor(top_p, device=dev).float()
    out = filter_rows(logits, temp, tk, tp, ds)
    sampled = prng.categorical(keys, out)
    return torch.where(ds, sampled, logits.argmax(dim=-1))


def filter_rows(logits, temperature, top_k, top_p, do_sample):
    """The per-row filter of ``select_tokens`` ([B] tensors on the
    logits' device): the logits divided by the temperature, with the
    tokens outside each row's top-k and top-p set filled with -1e30."""
    V = logits.shape[-1]
    dev = logits.device
    tk, tp = top_k, top_p
    lg = logits / torch.clamp(temperature, min=1e-6)[:, None]
    neg = torch.full((), -1e30, dtype=lg.dtype, device=dev)
    sorted_desc = torch.sort(lg, dim=-1, descending=True).values
    kth = sorted_desc.gather(1, torch.clamp(torch.clamp(tk, max=V) - 1,
                                            0, V - 1)[:, None])
    kfilt = (tk > 0)[:, None]
    out = torch.where(kfilt & (lg < kth), neg, lg)
    sd = torch.where(kfilt & (sorted_desc < kth), neg, sorted_desc)
    cutoff = _nucleus_cutoff(sd, tp[:, None].to(lg.dtype))
    return torch.where((tp < 1.0)[:, None] & (out < cutoff), neg, out)


# ---------------------------------------------------------------------------
# speculative decoding: shared by the offline path below and the serving
# engine's chain and tree lanes
# ---------------------------------------------------------------------------


def spec_accept_length(drafts, candidates, spec_len):
    """Accepted-prefix emit count of one speculative verify round.

    ``drafts`` [B, k] are the proposed tokens, ``candidates`` [B, k+1]
    the target's selections at every bundle position (candidate j is the
    token the target emits after bundle position j), ``spec_len`` [B]
    the per-row live bundle width (0 = row idle). Returns ``n_emit`` [B]
    int64: the round emits ``candidates[b, :n_emit[b]]``, every one the
    token plain decode would have chosen (sampled too: draft and target
    select position j with the same subkey)."""
    k = drafts.shape[1]
    match = (drafts == candidates[:, :k]).long()
    n_acc = torch.cumprod(match, dim=1).sum(dim=1)
    sl = torch.as_tensor(spec_len, device=drafts.device).long()
    return torch.minimum(n_acc + 1, sl)


def spec_tree_plan(spec_tree):
    """Static descriptor of a draft token tree with per-level branching
    factors ``spec_tree`` (e.g. ``[4, 2, 2]``): level 0 is the root (the
    row's last token), level t+1 holds ``factors[t]`` children per
    level-t node, and nodes are flattened in BFS order, so every
    ancestor has a lower index than its descendants and a BFS prefix is
    a shallower tree.

    Returns numpy arrays: ``factors`` tuple, ``depth`` D, ``nodes`` w,
    ``offsets`` [D+2] (first BFS index of each level, then w),
    ``parent`` [w] (``parent[0] == 0``), ``depth_vec`` [w], ``anc_idx``
    [w, D+1] (node i's ancestor at depth t, padded with i itself past
    its depth) and ``anc`` [w, w] bool (ancestor-or-self: the tree
    attention mask)."""
    factors = tuple(int(f) for f in spec_tree)
    if not factors or any(f < 1 for f in factors):
        raise ValueError(
            f"spec_tree must be a non-empty sequence of branching "
            f"factors >= 1 per draft level, got {spec_tree!r}")
    depth = len(factors)
    offsets = [0, 1]
    wl = 1
    for f in factors:
        wl *= f
        offsets.append(offsets[-1] + wl)
    w = offsets[-1]
    parent = np.zeros(w, np.int32)
    depth_vec = np.zeros(w, np.int32)
    for t in range(depth):
        for r in range(offsets[t + 2] - offsets[t + 1]):
            i = offsets[t + 1] + r
            parent[i] = offsets[t] + r // factors[t]
            depth_vec[i] = t + 1
    anc = np.eye(w, dtype=bool)
    for i in range(1, w):
        anc[i] |= anc[parent[i]]
    anc_idx = np.zeros((w, depth + 1), np.int32)
    for i in range(w):
        chain = [i]
        while chain[-1] != 0:
            chain.append(int(parent[chain[-1]]))
        chain.reverse()
        for t in range(depth + 1):
            anc_idx[i, t] = chain[t] if t < len(chain) else i
    return {"factors": factors, "depth": depth, "nodes": w,
            "offsets": np.asarray(offsets, np.int32), "parent": parent,
            "depth_vec": depth_vec, "anc_idx": anc_idx, "anc": anc}


def _plan_tensors(plan, device) -> dict:
    """The plan's index arrays as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(plan[k])).to(device)
            for k in ("parent", "depth_vec", "anc_idx", "anc")}


def truncated_draft(model, num_layers: int):
    """Self-speculative draft: a model of the same family keeping only the
    first ``num_layers`` decoder layers, with the embeddings, those
    layers, the final norm and the lm head copied from ``model`` (on its
    device and in its dtype; the vocab matches by construction)."""
    import dataclasses

    cfg = model.config
    n = int(num_layers)
    if not 1 <= n <= cfg.num_hidden_layers:
        raise ValueError(
            f"truncated_draft needs 1 <= num_layers <= "
            f"{cfg.num_hidden_layers}, got {num_layers}")
    p = next(model.parameters())
    draft = type(model)(dataclasses.replace(cfg, num_hidden_layers=n),
                        device=p.device, dtype=p.dtype)
    missing, _ = draft.load_state_dict(model.state_dict(), strict=False)
    if missing:  # a family whose names don't nest: refuse loudly
        raise ValueError(
            f"truncated_draft could not map {len(missing)} draft "
            f"parameters from the source model (first: {missing[0]})")
    return draft.train(model.training)


def _check_draft_vocab(mcfg, dcfg) -> None:
    if dcfg.vocab_size != mcfg.vocab_size:
        raise ValueError(
            f"draft/target vocab mismatch: draft vocab_size "
            f"({dcfg.vocab_size}) != target vocab_size ({mcfg.vocab_size}): "
            f"speculative decoding verifies draft token ids against target "
            f"logits, so both models must share one tokenizer/vocab (e.g. "
            f"build the draft with generation.truncated_draft)")


def tree_children(lvl, factor: int):
    """Greedy children of one draft-tree level: ``lvl`` [B, n, V] logits
    of the level's n nodes -> [B, n * factor] tokens, node-major. Branch
    0 is the explicit argmax (the token plain greedy decode picks, first
    index among ties), branch r > 0 the r-th ranked token; ties among
    r > 0 branches only change which drafts are proposed."""
    top = torch.topk(lvl, factor, dim=-1).indices
    top[..., 0] = lvl.argmax(dim=-1)
    return top.reshape(lvl.shape[0], -1)


def sampled_children(lvl, factor: int, first: int, base, params,
                     greedy):
    """Sampled children of one draft-tree level: ``lvl`` [B, n, V] logits
    of the level's n nodes, ``first`` the BFS index of the next level's
    first node, ``base`` [B, 2] the chain subkey of the level's depth.
    Branch 0 of each node draws with ``base`` (the draw the plain
    sampler makes, hence the token the verify selects when the path
    holds), branch r > 0 with ``fold_in(base, BFS index)``. Rows whose
    ``do_sample`` is off keep their ``greedy`` children. ``params`` is
    (do_sample, temperature, top_k, top_p) per row. Returns
    [B, n * factor]."""
    B, n, V = lvl.shape
    w_next = n * factor
    ds, temp, tk, tp = params
    gidx = first + torch.arange(w_next, device=lvl.device)
    folded = prng.fold_in(base[:, None, :], gidx[None, :])
    use_base = (torch.arange(w_next, device=lvl.device) % factor) == 0
    keys = torch.where(use_base[None, :, None],
                       base[:, None, :].expand(B, w_next, 2), folded)

    def rep(x):
        return x.repeat_interleave(w_next)

    sampled = select_tokens(
        lvl.repeat_interleave(factor, dim=1).reshape(B * w_next, V),
        keys.reshape(B * w_next, 2), rep(ds), rep(temp), rep(tk),
        rep(tp)).reshape(B, w_next)
    return torch.where(ds[:, None], sampled, greedy)


def draft_tree(drun, caches_at, tokens, pos, plan, subs=None, params=None):
    """Grow the draft token tree: D forwards, level t re-feeding the whole
    tree so far (``caches_at(n)``: the draft caches carrying the n-node
    ancestor mask and depths), then one write-only forward at full width
    so a deep accept never leaves the next round attending a hole.
    Children are greedy (``tree_children``) or, given the chain subkeys
    ``subs`` [B, >= D, 2] and the rows' sampling ``params``,
    ``sampled_children`` with level t's subkey. Returns the [B, w] BFS
    token tree (node 0 = ``tokens``)."""
    off = [int(o) for o in plan["offsets"]]
    B, w = tokens.shape[0], int(plan["nodes"])
    tok_tree = torch.zeros((B, w), dtype=torch.long, device=tokens.device)
    tok_tree[:, 0] = tokens
    for t, f in enumerate(plan["factors"]):
        n = off[t + 1]
        logits, _ = drun(tok_tree[:, :n], caches_at(n), pos)
        lvl = logits[:, off[t]:n]
        children = tree_children(lvl, f)
        if subs is not None:
            children = sampled_children(lvl, f, n, subs[:, t], params,
                                        children)
        tok_tree[:, n:off[t + 2]] = children
    drun(tok_tree, caches_at(w), pos)
    return tok_tree


def rows_select(logits, subs, params):
    """Select a bundle: ``logits`` [B, m, V] with per-position subkeys
    ``subs`` [B, m, 2] under the rows' sampling ``params`` (None: greedy
    argmax) -> [B, m]."""
    if params is None:
        return logits.argmax(dim=-1)
    B, m, V = logits.shape
    ds, temp, tk, tp = params

    def rep(x):
        return x.repeat_interleave(m)

    return select_tokens(logits.reshape(B * m, V), subs.reshape(B * m, 2),
                         rep(ds), rep(temp), rep(tk),
                         rep(tp)).reshape(B, m)


def tree_accept(bundle, cand, spec_len, plan, pt):
    """The deepest root-to-leaf path whose every node matches the
    target's selection for its parent: ``bundle`` [B, w] tokens, ``cand``
    [B, w] the target's selection per node, ``spec_len`` [B] each row's live
    BFS-prefix width, ``pt`` the plan's tensors. Returns (n_emit [B],
    path [B, D+1] node indices, the emitted tokens [B, D+1] (the first
    n_emit valid), the last emitted token [B])."""
    B, w = bundle.shape
    parent = pt["parent"].long()
    match = torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=bundle.device),
         bundle[:, 1:] == cand[:, parent[1:]]], dim=1)
    live = torch.arange(w, device=bundle.device)[None, :] \
        < torch.as_tensor(spec_len, device=bundle.device).long()[:, None]
    acc = match & live
    for _ in range(int(plan["depth"])):
        acc = acc & acc[:, parent]
    score = torch.where(acc, pt["depth_vec"].long()[None, :] + 1,
                        torch.zeros((), dtype=torch.long,
                                    device=bundle.device))
    best = score.argmax(dim=1)          # the first deepest path
    n_emit = score.gather(1, best[:, None])[:, 0]
    path = pt["anc_idx"].long()[best]
    return n_emit, path, cand.gather(1, path), \
        cand.gather(1, best[:, None])[:, 0]


def path_commit(pos, path, n_emit):
    """Per-row cache positions (src, dst) [B, D+1] of the accepted path's
    move: slot pos+t <- slot pos+path[t] for 1 <= t < n_emit; every other
    entry routes onto its own source (a same-value write)."""
    tt = torch.arange(path.shape[1], device=path.device)[None, :]
    src = pos.long()[:, None] + path
    commit = (tt < n_emit[:, None]) & (tt >= 1)
    return src, torch.where(commit, pos.long()[:, None] + tt, src)


def kv_path_move(caches, fsrc, fdst):
    """Move cache slots in place: flat slot ``fdst`` <- flat slot ``fsrc``
    (flat over each tensor's first two dims: [B, max_len] rows of a
    contiguous cache, [num_blocks, block_size] of a paged pool) in every
    tensor of every layer, values and scales alike. Every source is read
    before any write lands; duplicate destinations carry equal values."""
    fsrc, fdst = fsrc.reshape(-1), fdst.reshape(-1)
    for c in caches:
        for key in ("k", "v", "ks", "vs"):
            t = c.get(key)
            if t is None:
                continue
            flat = _bytes(t).view((t.shape[0] * t.shape[1],)
                                  + tuple(t.shape[2:]))
            flat[fdst] = flat[fsrc]


def _with_tree(caches, plan, pt, n: int, B: int, **extra):
    """Per-layer cache dicts carrying the n-node tree's ancestor mask and
    depths (and ``extra`` companions such as a block table)."""
    tm = pt["anc"][:n, :n][None].expand(B, n, n)
    return [dict(c, tree_mask=tm, tree_depth=pt["depth_vec"][:n], **extra)
            for c in caches]




def _row_params(cfg: GenerationConfig, B: int, device):
    """The static config as per-row sampling parameters (do_sample,
    temperature, top_k, top_p), or None for greedy decode."""
    if not cfg.do_sample:
        return None
    return (torch.ones(B, dtype=torch.bool, device=device),
            torch.full((B,), cfg.temperature, dtype=torch.float32,
                       device=device),
            torch.full((B,), cfg.top_k, dtype=torch.long, device=device),
            torch.full((B,), cfg.top_p, dtype=torch.float32, device=device))


def _spec_row_keys(seed: int, B: int, device):
    """Per-row chain roots of the speculative path: ``PRNGKey(seed)`` at
    B = 1 (the chain plain ``generate`` walks, so a single row's sampled
    tokens equal it), ``fold_in(root, row)`` at B > 1 (plain generate
    draws all rows from one shared key per position, which rows
    advancing at different rates cannot share)."""
    root = prng.PRNGKey(seed, device)
    if B == 1:
        return root[None]
    return prng.fold_in(root, torch.arange(B, device=device))


def _spec_setup(model, draft_model, ids, cfg, extra: int):
    """Checks and the prefill shared by the offline chain and tree paths:
    both models prefill the prompt into contiguous caches with ``extra``
    positions of room past S + N, and the first token is selected with
    each row's first subkey. Returns (runners, caches, first token, the
    rows' keys after it, the rows' sampling params)."""
    B, S = ids.shape
    N = cfg.max_new_tokens
    _check_draft_vocab(model.config, draft_model.config)
    if S + N > draft_model.config.max_position_embeddings:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({N}) exceeds the DRAFT "
            f"model's max_position_embeddings "
            f"({draft_model.config.max_position_embeddings}); the draft "
            f"decodes the same positions the target does")
    device = ids.device
    cache_len = S + N + extra
    run, drun = make_cached_runner(model), make_cached_runner(draft_model)
    caches = make_kv_caches(model.config, B, cache_len,
                            next(model.parameters()).dtype, device=device)
    dcaches = make_kv_caches(draft_model.config, B, cache_len,
                             next(draft_model.parameters()).dtype,
                             device=device)
    logits, _ = run(ids, caches, 0)
    drun(ids, dcaches, 0)
    params = _row_params(cfg, B, device)
    levels, subs = split_key_levels(_spec_row_keys(cfg.seed, B, device), 1)
    token = rows_select(logits[:, -1:], subs, params)[:, 0]
    return run, drun, caches, dcaches, token, levels[:, 1], params


def _finish_spec(ids, out, cfg):
    N = cfg.max_new_tokens
    gen = torch.tensor([r[:N] for r in out], dtype=torch.long,
                       device=ids.device)
    if cfg.eos_token_id is not None:
        gen = _mask_after_eos(gen, cfg.eos_token_id)
    return torch.cat([ids, gen], dim=1)


def _commit_keys(levels, n_emit):
    """The rows' chains after ``n_emit`` [B] emitted tokens: one split
    per emitted token."""
    return levels.gather(1, n_emit.long()[:, None, None].expand(
        -1, 1, 2))[:, 0]


def _generate_speculative(model, draft_model, ids, cfg: GenerationConfig,
                          spec_k: int):
    """Offline speculative decode (the serving chain lane's oracle): the
    draft proposes ``spec_k`` tokens a round, the target scores the whole
    bundle in ONE cached forward (q_len spec_k + 1) and the longest draft
    prefix matching its own selections is accepted. Draft and target
    select position j with the same chain subkey (common-noise
    coupling), and the chain commits one split per emitted token, so the
    tokens equal plain decode, greedy or sampled. Rejected KV is rolled
    back by position: the next round's writes land on top of it before
    any query can attend it."""
    B, S = ids.shape
    N, k = cfg.max_new_tokens, int(spec_k)
    run, drun, caches, dcaches, token, keys, params = _spec_setup(
        model, draft_model, ids, cfg, k)
    out = [[t] for t in token.tolist()]
    emitted = np.ones(B, np.int64)
    pos = np.full(B, S, np.int64)
    while int(emitted.min()) < N:
        spec_len = torch.from_numpy(np.minimum(k + 1, N - emitted))
        pos_t = torch.from_numpy(pos.astype(np.int32)).to(ids.device)
        levels, subs = (None, None) if params is None else \
            split_key_levels(keys, k + 1)
        tok, drafts = token, []
        for j in range(k):
            logits, _ = drun(tok[:, None], dcaches, pos_t + j)
            tok = rows_select(logits, None if subs is None
                              else subs[:, j:j + 1], params)[:, 0]
            drafts.append(tok)
        # write-only forward for the last draft token: a full accept
        # advances past pos+k, whose draft KV would otherwise be a hole
        drun(tok[:, None], dcaches, pos_t + k)
        drafts = torch.stack(drafts, dim=1)
        logits, _ = run(torch.cat([token[:, None], drafts], dim=1), caches,
                        pos_t)
        cand = rows_select(logits, subs, params)        # [B, k+1]
        n_emit = spec_accept_length(drafts, cand, spec_len.to(ids.device))
        if params is not None:
            keys = _commit_keys(levels, n_emit)
        last = cand.gather(1, (n_emit - 1).clamp(min=0)[:, None])[:, 0]
        token = torch.where(n_emit > 0, last, token)
        n_np, cand_np = n_emit.cpu().numpy(), cand.cpu().numpy()
        for b in range(B):
            out[b].extend(int(t) for t in cand_np[b, :n_np[b]])
        pos += n_np
        emitted += n_np
    return _finish_spec(ids, out, cfg)


def _generate_speculative_tree(model, draft_model, ids,
                               cfg: GenerationConfig, spec_tree):
    """Offline tree-speculative decode (the serving tree lane's oracle):
    the draft grows a token tree of ``spec_tree`` branching factors
    (``draft_tree``; sampled children draw with the chain subkey of their
    depth, branch r > 0 folded), the target scores all w flattened nodes
    in ONE cached forward under the tree's ancestor mask, each node
    selecting with its depth's subkey, and the deepest path matching the
    target's selections is emitted (``tree_accept``); the chain commits
    one split per emitted token. The accepted path's KV is moved onto
    consecutive positions in both models' caches (``kv_path_move``). The
    tokens equal plain decode, greedy or sampled."""
    plan = spec_tree_plan(spec_tree)
    D, w = int(plan["depth"]), int(plan["nodes"])
    off = [int(o) for o in plan["offsets"]]
    B, S = ids.shape
    N = cfg.max_new_tokens
    mcfg, dcfg = model.config, draft_model.config
    limit = min(dcfg.max_position_embeddings, mcfg.max_position_embeddings)
    if S + N + D > limit:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({N}) + tree depth ({D}) exceeds "
            f"max_position_embeddings ({limit}): tree nodes take rotary "
            f"positions up to pos + depth")
    run, drun, caches, dcaches, token, keys, params = _spec_setup(
        model, draft_model, ids, cfg, w)
    pt = _plan_tensors(plan, ids.device)
    T = caches[0]["k"].shape[1]
    rows = torch.arange(B, device=ids.device)[:, None] * T
    out = [[t] for t in token.tolist()]
    emitted = np.ones(B, np.int64)
    pos = np.full(B, S, np.int64)
    while int(emitted.min()) < N:
        # per-row BFS-prefix width: the tree depth clamped to the
        # remaining budget (0 remaining -> width 0 -> the row idles)
        spec_len = torch.tensor(
            [off[min(D, int(r) - 1) + 1] if r > 0 else 0
             for r in N - emitted], device=ids.device)
        pos_t = torch.from_numpy(pos.astype(np.int32)).to(ids.device)
        levels, subs = (None, None) if params is None else \
            split_key_levels(keys, D + 1)
        bundle = draft_tree(drun, lambda n: _with_tree(dcaches, plan, pt, n,
                                                       B),
                            token, pos_t, plan, subs, params)
        logits, _ = run(bundle, _with_tree(caches, plan, pt, w, B), pos_t)
        cand = rows_select(logits, None if subs is None
                           else subs[:, pt["depth_vec"].long()], params)
        n_emit, path, em, last = tree_accept(bundle, cand, spec_len, plan,
                                             pt)
        if params is not None:
            keys = _commit_keys(levels, n_emit)
        src, dst = path_commit(pos_t, path, n_emit)
        kv_path_move(caches + dcaches, rows + src, rows + dst)
        token = torch.where(n_emit > 0, last, token)
        n_np, em_np = n_emit.cpu().numpy(), em.cpu().numpy()
        for b in range(B):
            out[b].extend(int(t) for t in em_np[b, :n_np[b]])
        pos += n_np
        emitted += n_np
    return _finish_spec(ids, out, cfg)


def _normalize_prompts(input_ids, pad_token_id, device):
    """(ids [B, S] int64 on ``device``, pad_lens [B] int64 or None).

    A [B, S] tensor or array holds equal-length prompts; a list of
    per-row token sequences may be ragged, and its rows are LEFT-padded
    with ``pad_token_id`` to the longest (``pad_lens`` counts each row's
    pads). With an explicit ``pad_token_id`` a rectangular input is
    ragged too: each row's leading run of pad ids is padding (at most
    S - 1 of them; a pad id inside the prompt is content)."""
    if isinstance(input_ids, (list, tuple)) and input_ids and \
            isinstance(input_ids[0], (list, tuple, np.ndarray,
                                      torch.Tensor)):
        rows = [np.asarray(r, dtype=np.int64).reshape(-1) for r in input_ids]
        lens = [r.shape[0] for r in rows]
        if any(n == 0 for n in lens):
            raise ValueError("empty prompt in ragged batch")
        S = max(lens)
        if len(set(lens)) > 1 and pad_token_id is None:
            raise ValueError(
                f"ragged prompts (lengths {sorted(set(lens))}) require "
                f"pad_token_id for left-padding")
        ids = np.full((len(rows), S), 0 if pad_token_id is None
                      else pad_token_id, np.int64)
        for b, r in enumerate(rows):
            ids[b, S - r.shape[0]:] = r
        pad_lens = None if pad_token_id is None else \
            torch.tensor([S - n for n in lens], device=device)
        return torch.from_numpy(ids).to(device), pad_lens
    ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
        input_ids, torch.Tensor) else input_ids).to(device=device,
                                                     dtype=torch.long)
    if ids.dim() != 2:
        raise ValueError(f"input_ids must be [B, S], got {tuple(ids.shape)}")
    if pad_token_id is None:
        return ids, None
    is_pad = (ids == pad_token_id).long()
    pad_lens = torch.cumprod(is_pad, dim=1).sum(dim=1)
    return ids, torch.clamp(pad_lens, max=ids.shape[1] - 1)


def _pad_mask(pos: int, s: int, max_len: int, pad_lens):
    """Additive fp32 [B, 1, s, max_len] mask of ``s`` queries at ``pos``:
    causal over the cache and hiding each row's left pads (cache
    positions below its pad count), for the prefill and every decode
    step."""
    kpos = torch.arange(max_len, device=pad_lens.device)
    qpos = pos + torch.arange(s, device=pad_lens.device)
    m = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < pos + s)
    m = m[None] & (kpos[None, None, :] >= pad_lens[:, None, None])
    zero = torch.zeros((), dtype=torch.float32, device=pad_lens.device)
    neg = torch.full((), -1e30, dtype=torch.float32, device=pad_lens.device)
    return torch.where(m[:, None], zero, neg)


def generate(model, input_ids, max_new_tokens: int = 32,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None, seed: int = 0,
             loop_mode: str = "scan", pad_token_id: Optional[int] = None,
             stream: bool = False, draft_model=None, spec_k: int = 4,
             spec_tree=None, kv_format: str = "bf16"):
    """Continuations of the prompts ``input_ids`` [B, S]; returns
    [B, S + N] int64 on the model's device.

    The prompt is prefilled in one cached forward, then one cached
    forward per token. Greedy by default; with ``do_sample`` each token
    is drawn with temperature / top-k / top-p on the key chain of
    ``seed`` (``key, sub = split(key)`` before every token; the B rows
    share one subkey per position, its counters running flat over
    [B, V]), the reference's tokens bit for bit. With ``eos_token_id``
    the loop stops once every row has emitted it, and everything after a
    row's first EOS is EOS (the output keeps its [B, S + N] shape).
    ``loop_mode`` ("scan" or "python") is accepted for the reference's
    signature and has no effect: the port runs one loop either way.

    Ragged prompts: a list of per-row token sequences (or a pre-padded
    [B, S] batch) with ``pad_token_id``: rows are left-padded and a mask
    hides the pads through the prefill and every decode step, so the
    decode kernel declines (counted in ``DISPATCH_FALLBACKS``) and the
    plain attention runs, as in the reference.

    ``stream=True`` returns a generator of [B] int64 token tensors, one
    per position as it lands (rows past their EOS yield EOS), that stops
    once every row is done.

    ``kv_format="int8"`` / ``"fp8"`` stores the KV cache quantized
    (per-token-per-head absmax scales); the decode steps then run the
    quantized flash-decode kernel.

    ``draft_model=`` decodes speculatively: the draft proposes
    ``spec_k`` tokens a round (``spec_k=0`` decodes plainly), or, with
    ``spec_tree=[4, 2, 2]``, a token tree of those branching factors;
    the target scores the bundle in one cached forward. The tokens equal
    the plain path's, greedy at any B and sampled at B = 1 (B > 1 rows
    sample on their own ``fold_in`` chains). Not with a quantized
    ``kv_format``, ``stream`` or ragged prompts."""
    _check_format(kv_format)
    if kv_format != "bf16" and draft_model is not None:
        raise ValueError(
            "kv_format is not supported with draft_model in offline "
            "generate: run speculative decoding on the serving engine "
            "(ServingConfig.kv_format), whose draft/verify lanes operate "
            "on quantized pools")
    cfg = GenerationConfig(max_new_tokens, do_sample, temperature, top_k,
                           top_p, eos_token_id, seed)
    device = next(model.parameters()).device
    ids, pad_lens = _normalize_prompts(input_ids, pad_token_id, device)
    B, S = ids.shape
    config = model.config
    max_len = S + cfg.max_new_tokens
    if max_len > config.max_position_embeddings:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({cfg.max_new_tokens}) exceeds "
            f"max_position_embeddings ({config.max_position_embeddings})")
    if loop_mode not in ("scan", "python"):
        raise ValueError(
            f"loop_mode must be 'scan' or 'python', got {loop_mode!r}")
    if cfg.max_new_tokens <= 0:
        return iter(()) if stream else ids
    if spec_tree is not None and draft_model is None:
        raise ValueError(
            "spec_tree requires draft_model: the tree nodes are drafted by "
            "the small model; pass draft_model= (e.g. "
            "generation.truncated_draft) or drop spec_tree")
    if draft_model is not None and (spec_tree is not None or spec_k >= 1):
        if stream:
            raise ValueError(
                "stream=True is not supported with draft_model: the "
                "speculative loop emits a variable number of tokens per "
                "round; drop draft_model to stream")
        if pad_lens is not None:
            raise ValueError(
                "draft_model is not supported with ragged/left-padded "
                "prompts (pad_token_id): the speculative verify derives "
                "its masking from positions only")
        with torch.no_grad():
            if spec_tree is not None:
                return _generate_speculative_tree(model, draft_model, ids,
                                                  cfg, spec_tree)
            return _generate_speculative(model, draft_model, ids, cfg,
                                         spec_k)
    tokens = _token_iter(model, ids, pad_lens, cfg, kv_format)
    if stream:
        return tokens
    gen = torch.stack(list(tokens), dim=1)
    if gen.shape[1] < cfg.max_new_tokens:       # every row hit EOS early
        pad = torch.full((B, cfg.max_new_tokens - gen.shape[1]),
                         cfg.eos_token_id, dtype=gen.dtype, device=device)
        gen = torch.cat([gen, pad], dim=1)
    return torch.cat([ids, gen], dim=1)


def _token_iter(model, ids, pad_lens, cfg: GenerationConfig, kv_format):
    """The decode loop of ``generate``: yields the [B] token vector of
    each position (EOS-masked), stopping once every row has emitted
    EOS."""
    B, S = ids.shape
    max_len = S + cfg.max_new_tokens
    run = make_cached_runner(model)
    caches = make_kv_caches(model.config, B, max_len,
                            next(model.parameters()).dtype, kv_format,
                            device=ids.device)

    def forward(tok, pos):
        mask = None if pad_lens is None else \
            _pad_mask(pos, tok.shape[1], max_len, pad_lens)
        logits, _ = run(tok, caches, pos, attn_mask=mask)
        return logits[:, -1]

    key = prng.PRNGKey(cfg.seed, ids.device)
    eos = cfg.eos_token_id
    done = None
    for i in range(cfg.max_new_tokens):
        last = forward(ids, 0) if i == 0 else forward(token[:, None],
                                                      S + i - 1)
        sub = None
        if cfg.do_sample:
            key, sub = prng.split(key).unbind(0)
        token = _select_token(last, cfg, sub)
        if eos is not None:
            if done is None:
                done = torch.zeros(B, dtype=torch.bool, device=ids.device)
            token = torch.where(done, torch.full_like(token, eos), token)
            done |= token == eos
        yield token
        if done is not None and bool(done.all()):
            return


def generate_uncached(model, input_ids, max_new_tokens: int = 32,
                      do_sample: bool = False, temperature: float = 1.0,
                      top_k: int = 0, top_p: float = 1.0,
                      eos_token_id: Optional[int] = None, seed: int = 0):
    """Decode by re-running the whole uncached forward per token (the
    fallback for models without KV-cache plumbing; O(n^2)). Same key
    chain and selection as ``generate``, so its tokens equal
    ``generate``'s up to the logits' rounding."""
    cfg = GenerationConfig(max_new_tokens, do_sample, temperature, top_k,
                           top_p, eos_token_id, seed)
    device = next(model.parameters()).device
    ids, _ = _normalize_prompts(input_ids, None, device)
    S = ids.shape[1]
    max_pos = getattr(model.config, "max_position_embeddings", None)
    if max_pos is not None and S + cfg.max_new_tokens > max_pos:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({cfg.max_new_tokens}) exceeds "
            f"max_position_embeddings ({max_pos})")
    key = prng.PRNGKey(cfg.seed, device)
    with torch.no_grad():
        for _ in range(cfg.max_new_tokens):
            logits = model(ids)
            key, sub = prng.split(key).unbind(0)
            nxt = _select_token(logits[:, -1], cfg, sub)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    if cfg.eos_token_id is not None:
        ids = torch.cat([ids[:, :S], _mask_after_eos(ids[:, S:],
                                                     cfg.eos_token_id)],
                        dim=1)
    return ids
