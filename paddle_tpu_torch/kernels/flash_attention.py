"""Flash attention, forward and backward (counterpart of
``paddle_tpu/pallas_kernels/flash_attention.py``).

Three hand-written CUDA kernels (``csrc/flash_attention.cu``), one per
TPU kernel of the JAX package:

- ``flash_fwd`` (K1, ``_flash_fwd``): online-softmax attention with the
  causal tile skip and the segment-id mask; writes ``out`` and the
  per-row log-sum-exp;
- ``flash_bwd_dkdv`` (K2, ``_flash_bwd`` dK/dV pass): items of 128 keys,
  streaming the query tiles from the diagonal;
- ``flash_bwd_dq`` (K3, ``_flash_bwd`` dQ pass): items of 128 queries,
  streaming the key tiles up to the diagonal.

One ``torch.autograd.Function`` holds them: the forward is K1 and saves
``q, k, v, out, lse``; the backward computes ``delta = rowsum(dO * O)``
in fp32 as a plain torch op (the JAX package computes it outside any
kernel), folds the LSE cotangent in as ``delta - dlse``, then runs K2
and K3. Neither backward kernel uses atomics, so gradients are
deterministic.

Layout: [b, s, h, d] at every public function, read through strides;
``lse`` is [b, h, s] fp32. Query head j reads key head j, so GQA callers
expand k/v first (``repeat_kv``), as the JAX model does.

For tensors on the CPU the function runs the plain versions
``flash_attention_fwd_ref`` / ``flash_attention_bwd_ref``, which compute
the kernel bodies' formulas over whole rows. For CUDA tensors it
launches the kernels or raises; there is no fallback. ``LAUNCHES``
counts each kernel's launches and ``BODY_LAUNCHES`` each launch by kernel
and body (``fwd_body``, ``bwd_body``): ``wgmma`` in bf16 (one persistent
block per SM, a producer warp keeping TMA copies in flight, the products
on wgmma; every pass) and ``simt`` in fp32 (plain FMA from shared-memory
tiles, the card-against-CPU parity path).
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch

from ._build import load_library

__all__ = ["flash_attention", "flash_attn_varlen", "flash_attention_lse",
           "flash_attention_fwd_ref", "flash_attention_bwd_ref", "fwd_body",
           "bwd_body",
           "LAUNCHES", "BODY_LAUNCHES", "reset_counters", "HEAD_DIMS",
           "NEG_INF"]

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
BODY_LAUNCHES: Counter = Counter()   # "<kernel>/<body>"


def reset_counters() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    BODY_LAUNCHES.clear()


def fwd_body(dtype) -> str:
    """The body of ``csrc/flash_attention.cu`` a K1 launch takes."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def bwd_body(dtype) -> str:
    """The body of ``csrc/flash_attention.cu`` a K2 or K3 launch takes:
    ``flash_bwd_dkdv_wg`` / ``flash_bwd_dq_wg`` in bf16 at every head_dim,
    the fp32 SIMT bodies otherwise."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


# ---------------------------------------------------------------------------
# plain versions (whole rows, the kernel bodies' formulas)
# ---------------------------------------------------------------------------


def _visible(s: int, seg, causal: bool, device):
    """Bool [b or 1, 1, s, s] mask of the (query, key) pairs that attend,
    or None when every pair does."""
    mask = None
    if causal:
        ar = torch.arange(s, device=device)
        mask = (ar[:, None] >= ar[None, :])[None, None]
    if seg is not None:
        same = (seg[:, :, None] == seg[:, None, :])[:, None]
        mask = same if mask is None else (mask & same)
    return mask


def _scores(q, k, seg, causal: bool, scale: float):
    """fp32 [b, h, s, s] scores of the input-dtype products, masked with
    the finite NEG_INF as in the kernels."""
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    mask = _visible(q.shape[1], seg, causal, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    return s


def flash_attention_fwd_ref(q, k, v, seg, causal: bool, scale: float):
    """Plain version of K1: ``(out [b, s, h, d] in q's dtype, lse [b, h,
    s] fp32)``. ``p`` is rounded to v's dtype before the product with v,
    and the row sum ``l`` is taken over the unrounded ``p``."""
    s = _scores(q, k, seg, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float().transpose(1, 2))
    out = (acc / l_safe).to(q.dtype).transpose(1, 2)
    lse = (m + torch.log(l_safe))[..., 0]
    return out, lse


def flash_attention_bwd_ref(q, k, v, seg, out, lse, do, causal: bool,
                            scale: float, dlse=None):
    """Plain version of K2 and K3: ``(dq, dk, dv)`` in the inputs' dtype.
    ``p = exp(s - lse)``, ``ds = p * (dp - delta) * scale`` with ``delta
    = rowsum(dO * O) - dlse``; ``p`` and ``ds`` are rounded to the input
    dtype before their second products."""
    dt = q.dtype
    s = _scores(q, k, seg, causal, scale)
    p = torch.exp(s - lse[..., None])
    delta = _delta(out, do, dlse)
    dof = do.float().transpose(1, 2)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(1, 2).transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float().transpose(1, 2))
    dq = torch.matmul(ds, k.float().transpose(1, 2))
    return tuple(x.transpose(1, 2).to(dt) for x in (dq, dk, dv))


def _delta(out, do, dlse):
    """fp32 [b, h, s] ``rowsum(dO * O)``, minus the LSE cotangent."""
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _strided(t):
    """``t`` as the kernels read it: [b, s, h, d] with a unit inner stride
    and 16-byte aligned rows; copied only where it is not already so."""
    align = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 \
            or any(st % align for st in t.stride()[:3]):
        t = t.contiguous()
    return t


def _strides(*ts):
    vals = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check(q, k, v, seg):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q/k/v must share one [b, s, h, d] "
                         f"shape, got {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)} (expand GQA k/v with repeat_kv)")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {q.shape[-1]} not built "
                         f"({HEAD_DIMS})")
    ts = (q, k, v) + ((seg,) if seg is not None else ())
    if any(t.device != q.device for t in ts):
        raise ValueError(f"flash_attention: all inputs must be on {q.device}")


def _common(q, causal: bool, scale: float):
    b, s, h, d = q.shape
    return (int(q.dtype == torch.bfloat16), b, s, h, d, int(causal),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)


def _launch_fwd(q, k, v, seg, causal: bool, scale: float):
    _check(q, k, v, seg)
    q, k, v = (_strided(t) for t in (q, k, v))
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = load_library("flash_attention.cu")
    rc = lib.paddle_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        seg.data_ptr() if seg is not None else None, out.data_ptr(),
        lse.data_ptr(), _strides(q, k, v), *_common(q, causal, scale))
    if rc != 0:
        raise RuntimeError(f"flash_fwd: kernel launch failed (cudaError {rc})")
    LAUNCHES["flash_fwd"] += 1
    BODY_LAUNCHES[f"flash_fwd/{fwd_body(q.dtype)}"] += 1
    return out, lse


def _launch_bwd_kernel(name: str, q, k, v, seg, do, lse, delta,
                       causal: bool, scale: float):
    """One backward kernel on [b, s, h, d] inputs already in the kernels'
    layout (``_strided``); returns (dk, dv) for K2 or dq for K3."""
    outs = [torch.empty(q.shape, dtype=q.dtype, device=q.device)
            for _ in range(2 if name == "flash_bwd_dkdv" else 1)]
    lib = load_library("flash_attention.cu")
    entry = getattr(lib, "paddle_" + name)
    rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse.data_ptr(), delta.data_ptr(),
               seg.data_ptr() if seg is not None else None,
               *(o.data_ptr() for o in outs), _strides(q, k, v, do),
               *_common(q, causal, scale))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    BODY_LAUNCHES[f"{name}/{bwd_body(q.dtype)}"] += 1
    return tuple(outs) if len(outs) == 2 else outs[0]


def _launch_bwd(q, k, v, seg, out, lse, do, causal: bool, scale: float,
                dlse=None):
    q, k, v, do = (_strided(t) for t in (q, k, v, do.to(q.dtype)))
    delta = _delta(out, do, dlse)
    dk, dv = _launch_bwd_kernel("flash_bwd_dkdv", q, k, v, seg, do, lse,
                                delta, causal, scale)
    dq = _launch_bwd_kernel("flash_bwd_dq", q, k, v, seg, do, lse, delta,
                            causal, scale)
    return dq, dk, dv


def _forward(q, k, v, seg, causal, scale):
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, seg, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch_fwd(q, k, v, seg, causal, scale)


def _backward(q, k, v, seg, out, lse, do, causal, scale, dlse):
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, seg, out, lse, do, causal,
                                       scale, dlse)
    return _launch_bwd(q, k, v, seg, out, lse, do, causal, scale, dlse)


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) -> (out, lse); both outputs differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal, scale):
        with torch.no_grad():
            out, lse = _forward(q, k, v, seg, causal, scale)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, seg, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        dq, dk, dv = _backward(q, k, v, seg, out, lse, do, ctx.causal,
                               ctx.scale, dlse)
        return dq, dk, dv, None, None, None


def _segments(segment_ids, q):
    if segment_ids is None:
        return None
    seg = torch.as_tensor(segment_ids, device=q.device).to(torch.int32)
    if seg.shape != q.shape[:2]:
        raise ValueError(f"segment_ids must be [b, s] = {tuple(q.shape[:2])}, "
                         f"got {tuple(seg.shape)}")
    return seg.contiguous()


def _scale(q, sm_scale):
    return float(sm_scale) if sm_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])


def flash_attention_lse(q, k, v, causal: bool = True, sm_scale=None,
                        segment_ids=None):
    """Flash attention that also returns the log-sum-exp rows (the
    counterpart of ``_flash_lse``, for block-parallel merges such as ring
    attention): ``(out [b, s, h, d], lse [b, h, s] fp32)``. ``lse`` is
    differentiable; its cotangent folds into the backward as
    ``delta - dlse``."""
    return _FlashAttention.apply(q, k, v, _segments(segment_ids, q), causal,
                                 _scale(q, sm_scale))


def flash_attention(q, k, v, causal: bool = True, sm_scale=None,
                    block_q: int = 1024, block_k: int = 1024,
                    segment_ids=None):
    """Flash attention on [b, s, h, d] tensors; returns the same layout.

    ``segment_ids``: optional [b, s] int32, packed-sequence (varlen)
    masking: attention only within equal ids, combined with ``causal``.
    ``block_q`` / ``block_k`` keep the JAX signature; the CUDA kernels
    tile by their own register and shared-memory budget (128-row tiles
    in bf16, 32 in fp32) and mask a ragged last tile themselves, so any
    length works."""
    del block_q, block_k
    out, _ = flash_attention_lse(q, k, v, causal, sm_scale, segment_ids)
    return out


def flash_attn_varlen(q, k, v, cu_seqlens, causal: bool = True,
                      sm_scale=None):
    """Varlen flash attention over packed sequences: q/k/v [total, h, d],
    ``cu_seqlens`` [n_seq + 1] cumulative lengths. Token i belongs to
    segment j iff cu[j] <= i < cu[j + 1]. (The JAX package pads the
    stream to 128 tokens for the TPU's lanes; the CUDA kernels need no
    padding.)"""
    cu = torch.as_tensor(cu_seqlens, device=q.device).to(torch.int32)
    pos = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
    seg = torch.searchsorted(cu[1:].contiguous(), pos, right=True)
    out = flash_attention(q[None], k[None], v[None], causal=causal,
                          sm_scale=sm_scale,
                          segment_ids=seg.to(torch.int32)[None])
    return out[0]
