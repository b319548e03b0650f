"""Llama in PyTorch (counterpart of ``paddle_tpu/models/llama.py``).

The same module tree and parameter names as the JAX model, so one
numpy state dict loads into both (``models.convert``). Linear weights
are torch's ``[out, in]``; the JAX package stores ``[in, out]``.

Attention takes the JAX model's branches:
- static KV caches (a dict per layer, contiguous or paged): the step's
  k/v are written in place, then the flash-decode kernels run when
  ``decode_dispatch`` / ``paged_decode_dispatch`` accept the call, and
  the plain grouped attention over the masked cache runs where they
  decline (where the JAX package runs XLA). A speculative draft tree
  rides the cache dicts as ``tree_mask`` [b, s, s] (the bundle's
  ancestor mask) and ``tree_depth`` [s] (node i's rotary position is
  offset + depth[i], not offset + i): the paged kernel scores it under
  the mask (K8), a contiguous cache counts it as an external mask and
  takes the plain attention. A quantized cache (int8/fp8
  values with ``ks``/``vs`` scales) is written quantized and read by the
  kernels' dequantizing variants, or dequantized for the plain
  attention. With ``use_flash_attention``, a contiguous-cache prefill at
  offset 0 runs the flash-attention kernel over the prompt instead (over
  the step's own unquantized k/v, while the cache is still written);
- no cache: causal attention over the sequence, through the
  flash-attention kernels (K1-K3) with ``use_flash_attention`` and the
  plain attention without it. GQA k/v are expanded first (``repeat_kv``).

``llama_pretrain_loss`` is the shifted next-token cross entropy of the
training step, with the JAX package's fused streaming-LSE gradient.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..generation import update_static_kv_cache
from ..kernels.decode_attention import (decode_dispatch,
                                        flash_decode_attention,
                                        paged_decode_dispatch,
                                        paged_flash_decode_attention)
from ..kernels.flash_attention import flash_attention

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP", "RMSNorm",
           "apply_rotary_pos_emb", "rope_factors", "position_index",
           "scaled_dot_product_attention", "grouped_query_sdpa",
           "repeat_kv", "llama_pretrain_loss"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_flash_attention: bool = False  # flash-attention kernels K1-K3
    dtype: str = "float32"

    @staticmethod
    def llama2_7b(**overrides):
        cfg = LlamaConfig()
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg

    @staticmethod
    def tiny(**overrides):
        cfg = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, max_position_embeddings=128)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg


def _rope_tables(head_dim: int, max_pos: int, theta: float):
    """fp32 [max_pos, head_dim / 2] cos and sin tables."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32) / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def position_index(position_offset, b: int, s: int, max_pos: int, device):
    """[b, s] (or [s]) rows of a position table (rotary factors, GPT's
    learned positions) for an int, 0-d, [b] or [b, s] offset. Rows past
    the table clamp to its last entry: only pad tokens of a final prefill
    chunk and bundle nodes past a row's live width reach them, and their
    outputs are unused (the JAX package's rope gather clamps there too;
    its learned-position gather fills NaN, which stays in those rows)."""
    if isinstance(position_offset, torch.Tensor) and position_offset.dim() == 2:
        return position_offset.to(device).long().clamp(max=max_pos - 1)
    ar = torch.arange(s, device=device)
    if isinstance(position_offset, torch.Tensor) and position_offset.dim() == 1:
        idx = position_offset.to(device).long()[:, None] + ar[None, :]
    else:
        idx = ar + int(position_offset)
    return idx.clamp(max=max_pos - 1)


def rope_factors(cos_tab, sin_tab, position_offset, b: int, s: int, dtype):
    """The rotation's cos and sin rows for ``s`` tokens at
    ``position_offset`` (an int, a per-row [b] tensor such as the serving
    decode step's slot positions, or an explicit [b, s] grid), shaped
    [b or 1, s, 1, d/2] and cast from the fp32 tables to ``dtype``. The
    model computes them once per forward and every layer reuses them."""
    idx = position_index(position_offset, b, s, cos_tab.shape[0],
                         cos_tab.device)
    c, si = cos_tab[idx], sin_tab[idx]
    if c.dim() == 3:   # per-row [b, s, d/2]
        return c[:, :, None, :].to(dtype), si[:, :, None, :].to(dtype)
    return c[None, :, None, :].to(dtype), si[None, :, None, :].to(dtype)


def _rotate(x, c, si):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * si, x2 * c + x1 * si], dim=-1)


def apply_rotary_pos_emb(q, k, cos_tab, sin_tab, position_offset=0):
    """Rotary embedding on [b, s, h, d] tensors, half-split convention,
    applied in the activation dtype (see ``rope_factors``)."""
    c, si = rope_factors(cos_tab, sin_tab, position_offset, q.shape[0],
                         q.shape[1], q.dtype)
    return _rotate(q, c, si), _rotate(k, c, si)


def scaled_dot_product_attention(q, k, v, attn_mask=None,
                                 is_causal: bool = False):
    """Plain attention in [b, s, h, d] layout, the arithmetic of the JAX
    package's ``nn.functional.scaled_dot_product_attention``: scores in
    the activation dtype, masked with -1e9, softmax in fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    scores = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    if is_causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~causal, -1e9)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, -1e9)
        else:
            scores = scores + attn_mask
    probs = torch.softmax(scores.float(), dim=-1).to(vt.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)


def repeat_kv(x, rep: int):
    """GQA head expansion: [b, s, kv_heads, d] -> [b, s, kv_heads * rep,
    d]; each kv head serves ``rep`` consecutive query heads."""
    return x.repeat_interleave(rep, dim=2) if rep > 1 else x


def _flash_prefill(q, k, v):
    """Causal flash attention over a [b, s, h, d] prompt zero-padded to a
    multiple of 128, as the JAX model pads it for the TPU grid; padded
    queries are sliced off, and no real query sees a padded key under the
    causal mask."""
    s = q.shape[1]
    pad = -s % 128
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    return flash_attention(q, k, v, causal=True)[:, :s]


def grouped_query_sdpa(q, k, v, attn_mask=None):
    """Plain GQA attention without expanding k/v (the JAX package's
    ``grouped_query_sdpa``): q [b, s, H, d], k/v [b, t, KV, d], query
    head j reads kv head j // (H // KV); ``attn_mask`` is additive (or
    bool) and broadcasts as [b, 1, s, t]."""
    b, s, H, d = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"num_heads ({H}) not a multiple of kv_heads ({KV})")
    g = H // KV
    scale = 1.0 / math.sqrt(d)
    qt = q.transpose(1, 2).reshape(b, KV, g, s, d)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    scores = torch.einsum("bkgqd,bktd->bkgqt", qt, kt) * scale
    if attn_mask is not None:
        mask = attn_mask[:, :, None]
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, -1e9)
        else:
            scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(vt.dtype)
    out = torch.einsum("bkgqt,bktd->bkgqd", probs, vt)
    return out.reshape(b, H, s, d).transpose(1, 2)


class RMSNorm(nn.Module):
    """Mean of squares in fp32, rsqrt, cast back to the activation dtype,
    then the weight (the order of ``nn/functional.py`` ``rms_norm``)."""

    def __init__(self, hidden: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden, device=device,
                                              dtype=dtype))

    def forward(self, x):
        xf = x.float()
        ms = xf.pow(2).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(ms + self.eps)).to(x.dtype) * self.weight


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.use_flash_attention = config.use_flash_attention
        self.head_dim = config.hidden_size // config.num_attention_heads
        h, kvd = config.hidden_size, self.num_kv_heads * self.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = nn.Linear(h, self.num_heads * self.head_dim, **kw)
        self.k_proj = nn.Linear(h, kvd, **kw)
        self.v_proj = nn.Linear(h, kvd, **kw)
        self.o_proj = nn.Linear(self.num_heads * self.head_dim, h, **kw)

    def forward(self, hidden_states, rope, attn_mask=None, kv_cache=None,
                position_offset=0):
        """``rope``: this forward's (cos, sin) rows from ``rope_factors``."""
        b, s, _ = hidden_states.shape
        q = self.q_proj(hidden_states).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden_states).view(b, s, self.num_kv_heads,
                                            self.head_dim)
        v = self.v_proj(hidden_states).view(b, s, self.num_kv_heads,
                                            self.head_dim)
        q, k = _rotate(q, *rope), _rotate(k, *rope)

        rep = self.num_heads // self.num_kv_heads
        if kv_cache is None:
            k, v = repeat_kv(k, rep), repeat_kv(v, rep)
            if self.use_flash_attention and attn_mask is None:
                out = flash_attention(q, k, v, causal=True)
            else:
                out = scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None)
            return self.o_proj(out.reshape(b, s, -1))

        paged = "bt" in kv_cache
        # quantized cache: int8/fp8 storage with "ks"/"vs" absmax scales;
        # the kernels dequantize as they load, the plain path at the gather
        quant_cache = "ks" in kv_cache
        # a draft tree's [b, s, s] ancestor mask: the paged kernel takes
        # it (K8); the contiguous kernel has no mask input, so there it
        # counts as an external mask and the plain path builds the tree
        # cache mask (update_static_kv_cache)
        tree_mask = kv_cache.get("tree_mask")
        # flash prefill: at offset 0, causal attention over the prompt
        # alone equals the masked attention over the cache; paged caches
        # never take it (a chunk must read earlier blocks via the table)
        flash_prefill = (not paged and self.use_flash_attention
                         and attn_mask is None
                         and isinstance(position_offset, int)
                         and position_offset == 0 and s > 1)
        use_kernel = False
        if not flash_prefill:
            dispatch = paged_decode_dispatch if paged else decode_dispatch
            use_kernel = dispatch("llama", q_len=s,
                                  has_mask=attn_mask is not None or (
                                      tree_mask is not None and not paged),
                                  dtype=q.dtype, quantized=quant_cache)
        k_full, v_full, new_cache, mask = update_static_kv_cache(
            kv_cache, k, v, position_offset,
            build_mask=(attn_mask is None and not use_kernel
                        and not flash_prefill),
            gather=not use_kernel)
        if flash_prefill:
            # the step's own k/v, unquantized, as the JAX model keeps them
            out = _flash_prefill(q, repeat_kv(k, rep), repeat_kv(v, rep))
        elif use_kernel:
            ks, vs = new_cache.get("ks"), new_cache.get("vs")
            if paged:
                out = paged_flash_decode_attention(
                    q, new_cache["k"], new_cache["v"], new_cache["bt"],
                    position_offset, k_scale=ks, v_scale=vs,
                    ancestor_mask=tree_mask)
            else:
                out = flash_decode_attention(q, k_full, v_full,
                                             position_offset, k_scale=ks,
                                             v_scale=vs)
        else:
            if attn_mask is None:
                attn_mask = mask
            out = grouped_query_sdpa(q, k_full, v_full, attn_mask=attn_mask)
        return self.o_proj(out.reshape(b, s, -1)), new_cache


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        h, f = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(h, f, **kw)
        self.up_proj = nn.Linear(h, f, **kw)
        self.down_proj = nn.Linear(f, h, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.self_attn = LlamaAttention(config, device, dtype)
        self.mlp = LlamaMLP(config, device, dtype)
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device, dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                device, dtype)

    def forward(self, hidden_states, rope, attn_mask=None, kv_cache=None,
                position_offset=0):
        residual = hidden_states
        h = self.input_layernorm(hidden_states)
        new_cache = None
        if kv_cache is not None:
            h, new_cache = self.self_attn(h, rope, attn_mask, kv_cache,
                                          position_offset)
        else:
            h = self.self_attn(h, rope, attn_mask)
        h = residual + h
        out = h + self.mlp(self.post_attention_layernorm(h))
        if kv_cache is not None:
            return out, new_cache
        return out


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size,
                                         device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device,
                            dtype)
        head_dim = config.hidden_size // config.num_attention_heads
        cos, sin = _rope_tables(head_dim, config.max_position_embeddings,
                                config.rope_theta)
        # fp32 buffers, saved in the state dict under the JAX model's names
        self.register_buffer("rope_cos", cos.to(device))
        self.register_buffer("rope_sin", sin.to(device))

    def forward(self, input_ids, attn_mask=None, kv_caches=None,
                position_offset=0):
        h = self.embed_tokens(input_ids)
        rope_pos = position_offset
        depth = kv_caches[0].get("tree_depth") if kv_caches else None
        if depth is not None:
            # a draft tree: node i sits in cache slot offset + i, at
            # rotary position offset + depth[i] (siblings share one)
            b = h.shape[0]
            po = torch.as_tensor(position_offset, device=h.device).long()
            if po.dim() == 0:
                po = po.expand(b)
            rope_pos = po[:, None] + depth.to(h.device).long()[None, :]
        rope = rope_factors(self.rope_cos, self.rope_sin, rope_pos,
                            h.shape[0], h.shape[1], h.dtype)
        if kv_caches is not None:
            new_caches = []
            for layer, cache in zip(self.layers, kv_caches, strict=True):
                h, nc = layer(h, rope, attn_mask, cache, position_offset)
                new_caches.append(nc)
            return self.norm(h), new_caches
        for layer in self.layers:
            h = layer(h, rope, attn_mask)
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """``device=None`` resolves to ``cuda`` (raises without a GPU);
    ``dtype=None`` takes ``config.dtype``."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype if dtype is not None else _DTYPES[config.dtype]
        self.config = config
        self.llama = LlamaModel(config, device, dtype)
        if config.tie_word_embeddings:
            self.lm_head = None
        else:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias=False, device=device, dtype=dtype)

    def forward(self, input_ids, attn_mask=None, kv_caches=None,
                position_offset=0):
        if kv_caches is not None:
            h, new_caches = self.llama(input_ids, attn_mask, kv_caches,
                                       position_offset)
        else:
            h = self.llama(input_ids, attn_mask)
        if self.lm_head is None:
            logits = torch.matmul(h, self.llama.embed_tokens.weight.t())
        else:
            logits = self.lm_head(h)
        if kv_caches is not None:
            return logits, new_caches
        return logits

    def generate(self, input_ids, max_new_tokens: int = 32, **kwargs):
        from ..generation import generate

        return generate(self, input_ids, max_new_tokens=max_new_tokens,
                        **kwargs)


# ---------------------------------------------------------------------------
# pretraining loss
# ---------------------------------------------------------------------------

# logits rows per chunk of the fused loss: bounds its fp32 temporaries to
# ~256 MB however large b * s * vocab is
_CE_CHUNK_ELEMS = 1 << 26


def _row_chunks(n_rows: int, vocab: int):
    step = max(1, _CE_CHUNK_ELEMS // vocab)
    return [slice(i, min(i + step, n_rows)) for i in range(0, n_rows, step)]


def _lse_stream(lg):
    """fp32 row LSE of [n, vocab] logits without an fp32 copy of them:
    ``max`` in the logits dtype, ``exp((lg - m) as fp32)`` summed chunk by
    chunk."""
    out = torch.empty(lg.shape[0], dtype=torch.float32, device=lg.device)
    for c in _row_chunks(*lg.shape):
        x = lg[c]
        m = x.amax(dim=-1)
        z = torch.exp((x - m[:, None]).float()).sum(dim=-1)
        out[c] = m.float() + torch.log(z)
    return out


class _FusedShiftCE(torch.autograd.Function):
    """Mean cross entropy of [n, vocab] logits against already shifted
    labels (``-100`` ignored). The gradient ``(softmax - onehot) * mask *
    g / n`` is computed in the logits dtype; the logits are the only large
    residual (the counterpart of ``_fused_shift_ce``)."""

    @staticmethod
    def forward(ctx, lg, lab):
        v = lg.shape[-1]
        lse = _lse_stream(lg)
        idx = lab.clamp(0, v - 1)
        picked = lg.gather(1, idx[:, None])[:, 0]
        mask = lab != -100
        n = mask.sum().clamp_min(1)
        ctx.save_for_backward(lg, idx, mask, lse, n)
        return ((lse - picked.float()) * mask).sum() / n

    @staticmethod
    def backward(ctx, g):
        lg, idx, mask, lse, n = ctx.saved_tensors
        dt = lg.dtype
        scale = (g / n).to(dt)
        dlg = torch.empty_like(lg)
        for c in _row_chunks(*lg.shape):
            p = torch.exp(lg[c] - lse[c, None].to(dt))
            rows = torch.arange(p.shape[0], device=p.device)
            p[rows, idx[c]] -= 1        # softmax - onehot, in the logits dtype
            p *= mask[c, None].to(dt)
            p *= scale
            dlg[c] = p
        return dlg, None


def llama_pretrain_loss(logits, labels):
    """Shifted next-token cross entropy: position t predicts labels[t + 1]
    (labels may equal the input ids; ``-100`` is ignored; [b, s, 1] labels
    are accepted). The last position has no target. Returns the fp32 mean
    over the counted positions."""
    b, s, v = logits.shape
    lab = torch.as_tensor(labels, device=logits.device).long()
    if lab.dim() == 3 and lab.shape[-1] == 1:
        lab = lab[..., 0]
    lab_s = torch.cat([lab[:, 1:], torch.full((b, 1), -100, dtype=lab.dtype,
                                              device=lab.device)], dim=1)
    return _FusedShiftCE.apply(logits.reshape(b * s, v), lab_s.reshape(-1))
