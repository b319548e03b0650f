"""KV caches and greedy generation (counterpart of the serving subset of
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

``generate`` is the greedy path: equal-length prompts, one cached
forward per token in a Python loop, EOS masking. Sampling needs the
JAX package's threefry key chain ported bit for bit and comes with a
later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .quantization.intx import (KV_FORMATS, absmax_along, format_dtype,
                                format_itemsize, format_of_dtype,
                                pack_absmax, unpack_absmax)

__all__ = ["GenerationConfig", "generate", "make_kv_caches",
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


def kv_cache_write(buf, new, position_offset: int):
    """Write a step's [b, s, h, d] block into the [b, max_len, h, d]
    buffer at the shared ``position_offset``; in place."""
    off = int(position_offset)
    buf[:, off:off + new.shape[1]] = new.to(buf.dtype)
    return buf


def _quantize_step(new, kv_format: str):
    """A step's [b, s, h, d] block quantized per token per head: (narrow
    values, f32 absmax [b, s, h])."""
    amax = absmax_along(new, -1)
    return pack_absmax(new, amax[..., None], kv_format), amax


def kv_cache_write_quant(buf, scales, new, position_offset: int,
                         kv_format: str = "int8"):
    """Contiguous twin of ``paged_kv_cache_write_quant``: quantize the
    step's [b, s, h, d] block per token per head and write the values
    into the int8/fp8 [b, max_len, h, d] buffer and the absmax into the
    [b, max_len, h] f32 scales at ``position_offset``; in place. Returns
    (buf, scales)."""
    off = int(position_offset)
    q, amax = _quantize_step(new, kv_format)
    s = new.shape[1]
    _bytes(buf)[:, off:off + s] = _bytes(q)
    scales[:, off:off + s] = amax.to(scales.dtype)
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
    mask = _causal_cache_mask(position_offset, k.shape[1], max_len,
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
    positions < offset + s. Returns (k_full, v_full, new_cache, mask).

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
        mask = _causal_cache_mask(position_offset, k.shape[1], ck.shape[1],
                                  k.device) if build_mask else None
        if gather:
            return (dequantize_kv_buffer(ck, cks, k.dtype),
                    dequantize_kv_buffer(cv, cvs, k.dtype), new_cache, mask)
        return ck, cv, new_cache, mask
    ck = kv_cache_write(kv_cache["k"], k, position_offset)
    cv = kv_cache_write(kv_cache["v"], v, position_offset)
    mask = _causal_cache_mask(position_offset, k.shape[1], ck.shape[1],
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


def _no_sampling(do_sample: bool) -> None:
    if do_sample:
        raise NotImplementedError(
            "do_sample=True: sampled decode needs the JAX package's threefry "
            "key chain (paddle_tpu/generation.py split_keys / "
            "select_tokens) ported bit for bit; it comes with the "
            "sampled-decode slice. Greedy decode is ported.")


def generate(model, input_ids, max_new_tokens: int = 32,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None, seed: int = 0,
             kv_format: str = "bf16"):
    """Greedy continuations of equal-length prompts ``input_ids`` [B, S];
    returns [B, S + N] int64 on the model's device.

    The prompt is prefilled in one cached forward, then one cached
    forward per token. With ``eos_token_id`` the loop stops once every
    row has emitted it, and everything after a row's first EOS is EOS
    (the output keeps its [B, S + N] shape). ``kv_format="int8"`` /
    ``"fp8"`` stores the KV cache quantized (per-token-per-head absmax
    scales); the decode steps then run the quantized flash-decode
    kernel."""
    _no_sampling(do_sample)
    _check_format(kv_format)
    cfg = GenerationConfig(max_new_tokens, do_sample, temperature, top_k,
                           top_p, eos_token_id, seed)
    device = next(model.parameters()).device
    ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
        input_ids, torch.Tensor) else input_ids).to(device=device,
                                                     dtype=torch.long)
    if ids.dim() != 2:
        raise ValueError(f"input_ids must be [B, S], got {tuple(ids.shape)}")
    B, S = ids.shape
    config = model.config
    max_len = S + cfg.max_new_tokens
    if max_len > config.max_position_embeddings:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({cfg.max_new_tokens}) exceeds "
            f"max_position_embeddings ({config.max_position_embeddings})")
    if cfg.max_new_tokens <= 0:
        return ids
    dtype = next(model.parameters()).dtype
    run = make_cached_runner(model)
    caches = make_kv_caches(config, B, max_len, dtype, kv_format,
                            device=device)
    logits, caches = run(ids, caches, 0)
    token = logits[:, -1].argmax(dim=-1)
    out = [token]
    eos = cfg.eos_token_id
    done = token == eos if eos is not None else None
    for i in range(1, cfg.max_new_tokens):
        if done is not None and bool(done.all()):
            break
        logits, caches = run(token[:, None], caches, S + i - 1)
        token = logits[:, 0].argmax(dim=-1)
        out.append(token)
        if done is not None:
            done |= token == eos
    gen = torch.stack(out, dim=1)
    if eos is not None:
        gen = _mask_after_eos(gen, eos)
        if gen.shape[1] < cfg.max_new_tokens:
            pad = torch.full((B, cfg.max_new_tokens - gen.shape[1]), eos,
                             dtype=gen.dtype, device=device)
            gen = torch.cat([gen, pad], dim=1)
    return torch.cat([ids, gen], dim=1)
