"""GPT in PyTorch (counterpart of ``paddle_tpu/models/gpt.py``): learned
positions, pre-LN blocks, a tanh-GELU MLP, biased linears, no GQA.

The same module tree and parameter names as the JAX model (``gpt.wte``,
``gpt.wpe``, ``gpt.h.N.{ln_1, attn.{q,k,v,out}_proj, ln_2, fc_in,
fc_out}``, ``gpt.ln_f``, ``lm_head``), so one numpy state dict loads into
both (``models.convert``).

Attention takes the JAX model's branches, as ``llama.py`` does:
- static KV caches (a dict per layer, contiguous or paged): the step's
  k/v are written in place, then the flash-decode kernels run when
  ``decode_dispatch`` / ``paged_decode_dispatch`` accept the call (label
  ``"gpt"``), and the plain attention over the masked cache runs where
  they decline. A draft tree's ``tree_mask`` goes to the paged kernel
  (K8) and counts as an external mask on a contiguous cache; its
  ``tree_depth`` sets node i's learned position to offset + depth[i]. A
  quantized cache is written quantized and read by the kernels'
  dequantizing variants, or dequantized for the plain attention;
- no cache: causal plain attention over the sequence.

Learned positions gather ``wpe`` with the index clamped to the table
(``llama.position_index``): the JAX model's gather fills NaN past it,
where only pad tokens and dead bundle nodes land.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..generation import update_static_kv_cache
from ..kernels.decode_attention import (decode_dispatch,
                                        flash_decode_attention,
                                        paged_decode_dispatch,
                                        paged_flash_decode_attention)
from ..nn import functional as PF
from ..nn.layers_conv_norm import LayerNorm
from .llama import _DTYPES, position_index, scaled_dot_product_attention

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "GPTBlock",
           "GPTAttention"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    dropout: float = 0.0
    dtype: str = "float32"

    @property
    def num_key_value_heads(self):
        # no GQA in the GPT family; the KV caches are sized off this
        return self.num_attention_heads

    @staticmethod
    def gpt3_1p3b(**overrides):
        cfg = GPTConfig(hidden_size=2048, num_hidden_layers=24,
                        num_attention_heads=16, intermediate_size=8192,
                        max_position_embeddings=2048)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg

    @staticmethod
    def tiny(**overrides):
        cfg = GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=128)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg


class GPTAttention(nn.Module):
    """The q/k/v/out projections (biased) of one block; the attention
    itself runs in ``GPTBlock.forward``, as in the JAX model."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        kw = dict(device=device, dtype=dtype)
        self.q_proj = nn.Linear(h, h, **kw)
        self.k_proj = nn.Linear(h, h, **kw)
        self.v_proj = nn.Linear(h, h, **kw)
        self.out_proj = nn.Linear(h, h, **kw)


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(h, eps, **kw)
        self.attn = GPTAttention(config, device, dtype)
        self.ln_2 = LayerNorm(h, eps, **kw)
        self.fc_in = nn.Linear(h, config.intermediate_size, **kw)
        self.fc_out = nn.Linear(config.intermediate_size, h, **kw)

    def forward(self, x, attn_mask=None, kv_cache=None, position_offset=0):
        h = self.ln_1(x)
        b, s, _ = h.shape
        nh, hd = self.attn.num_heads, self.attn.head_dim
        q = self.attn.q_proj(h).view(b, s, nh, hd)
        k = self.attn.k_proj(h).view(b, s, nh, hd)
        v = self.attn.v_proj(h).view(b, s, nh, hd)
        new_cache = None
        if kv_cache is None:
            a = scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             is_causal=attn_mask is None)
        else:
            paged = "bt" in kv_cache
            tree_mask = kv_cache.get("tree_mask")
            dispatch = paged_decode_dispatch if paged else decode_dispatch
            use_kernel = dispatch(
                "gpt", q_len=s,
                has_mask=attn_mask is not None or (tree_mask is not None
                                                   and not paged),
                dtype=q.dtype, quantized="ks" in kv_cache)
            k_full, v_full, new_cache, mask = update_static_kv_cache(
                kv_cache, k, v, position_offset,
                build_mask=attn_mask is None and not use_kernel,
                gather=not use_kernel)
            if use_kernel:
                ks, vs = new_cache.get("ks"), new_cache.get("vs")
                if paged:
                    a = paged_flash_decode_attention(
                        q, new_cache["k"], new_cache["v"], new_cache["bt"],
                        position_offset, k_scale=ks, v_scale=vs,
                        ancestor_mask=tree_mask)
                else:
                    a = flash_decode_attention(q, k_full, v_full,
                                               position_offset, k_scale=ks,
                                               v_scale=vs)
            else:
                a = scaled_dot_product_attention(
                    q, k_full, v_full,
                    attn_mask=mask if attn_mask is None else attn_mask)
        x = x + self.attn.out_proj(a.reshape(b, s, nh * hd))
        x = x + self.fc_out(PF.gelu(self.fc_in(self.ln_2(x)),
                                    approximate=True))
        if kv_cache is not None:
            return x, new_cache
        return x


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.wte = nn.Embedding(config.vocab_size, h, **kw)
        self.wpe = nn.Embedding(config.max_position_embeddings, h, **kw)
        self.h = nn.ModuleList([GPTBlock(config, device, dtype)
                                for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(h, config.layer_norm_eps, **kw)

    def forward(self, input_ids, attn_mask=None, kv_caches=None,
                position_offset=0):
        b, s = input_ids.shape
        pos = position_offset
        depth = kv_caches[0].get("tree_depth") if kv_caches else None
        if depth is not None:
            # a draft tree: node i sits in cache slot offset + i, at
            # learned position offset + depth[i] (siblings share one)
            po = torch.as_tensor(position_offset,
                                 device=input_ids.device).long()
            if po.dim() == 0:
                po = po.expand(b)
            pos = po[:, None] + depth.to(input_ids.device).long()[None, :]
        idx = position_index(pos, b, s, self.config.max_position_embeddings,
                             input_ids.device)
        x = self.wte(input_ids) + self.wpe(idx)
        if kv_caches is not None:
            new_caches = []
            for block, cache in zip(self.h, kv_caches, strict=True):
                x, nc = block(x, attn_mask, cache, position_offset)
                new_caches.append(nc)
            return self.ln_f(x), new_caches
        for block in self.h:
            x = block(x, attn_mask)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """``device=None`` resolves to ``cuda`` (raises without a GPU);
    ``dtype=None`` takes ``config.dtype``."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype if dtype is not None else _DTYPES[config.dtype]
        self.config = config
        self.gpt = GPTModel(config, device, dtype)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=False, device=device, dtype=dtype)

    def forward(self, input_ids, attn_mask=None, kv_caches=None,
                position_offset=0):
        if kv_caches is not None:
            h, new_caches = self.gpt(input_ids, attn_mask, kv_caches,
                                     position_offset)
            return self.lm_head(h), new_caches
        return self.lm_head(self.gpt(input_ids, attn_mask))

    def generate(self, input_ids, max_new_tokens: int = 32, **kwargs):
        from ..generation import generate

        return generate(self, input_ids, max_new_tokens=max_new_tokens,
                        **kwargs)

    @classmethod
    def from_huggingface(cls, hf_model, device=None):
        """A GPTForCausalLM from a ``transformers`` GPT2LMHeadModel. HF
        GPT-2 stores its Conv1D weights [in, out]; this model's Linears
        are [out, in], so each is transposed. The fused ``c_attn`` [h, 3h]
        splits into q/k/v; the head, tied to ``wte`` there, is copied
        into this model's untied ``lm_head``. Refuses the configurations
        the JAX package refuses: a GELU other than the tanh form, and
        attention scaling or cross-attention this model does not
        compute."""
        h = hf_model.config
        if getattr(h, "activation_function", "gelu_new") not in (
                "gelu_new", "gelu_pytorch_tanh"):
            raise NotImplementedError(
                f"activation_function={h.activation_function!r}: this model "
                "uses the tanh-approximate GELU only")
        # attention-math knobs carry no weights, so the shape checks
        # can't catch them: refuse rather than silently mis-load
        if getattr(h, "scale_attn_by_inverse_layer_idx", False) \
                or not getattr(h, "scale_attn_weights", True) \
                or getattr(h, "add_cross_attention", False):
            raise NotImplementedError(
                "non-default attention scaling / cross-attention configs are "
                "not reproduced by this model's fixed 1/sqrt(head_dim) SDPA")
        config = GPTConfig(
            vocab_size=h.vocab_size, hidden_size=h.n_embd,
            num_hidden_layers=h.n_layer, num_attention_heads=h.n_head,
            intermediate_size=h.n_inner or 4 * h.n_embd,
            max_position_embeddings=h.n_positions,
            layer_norm_eps=h.layer_norm_epsilon)
        model = cls(config, device=device)
        sd = {k: v.detach() for k, v in hf_model.state_dict().items()}
        out = {"gpt.wte.weight": sd["transformer.wte.weight"],
               "gpt.wpe.weight": sd["transformer.wpe.weight"],
               "gpt.ln_f.weight": sd["transformer.ln_f.weight"],
               "gpt.ln_f.bias": sd["transformer.ln_f.bias"],
               # present tied or untied; reading it (not wte) keeps an
               # untied checkpoint right
               "lm_head.weight": sd["lm_head.weight"]}
        hs = config.hidden_size
        for i in range(config.num_hidden_layers):
            src, dst = f"transformer.h.{i}.", f"gpt.h.{i}."
            for ln in ("ln_1", "ln_2"):
                for p in ("weight", "bias"):
                    out[f"{dst}{ln}.{p}"] = sd[f"{src}{ln}.{p}"]
            ca_w = sd[src + "attn.c_attn.weight"]      # [h, 3h]
            ca_b = sd[src + "attn.c_attn.bias"]        # [3h]
            for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
                out[f"{dst}attn.{name}.weight"] = \
                    ca_w[:, j * hs:(j + 1) * hs].t()
                out[f"{dst}attn.{name}.bias"] = ca_b[j * hs:(j + 1) * hs]
            for mine, theirs in (("attn.out_proj", "attn.c_proj"),
                                 ("fc_in", "mlp.c_fc"),
                                 ("fc_out", "mlp.c_proj")):
                out[f"{dst}{mine}.weight"] = sd[f"{src}{theirs}.weight"].t()
                out[f"{dst}{mine}.bias"] = sd[f"{src}{theirs}.bias"]
        model.load_state_dict(out, strict=True)
        return model
