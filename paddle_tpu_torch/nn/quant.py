"""Weight-only quantization for serving (counterpart of
``paddle_tpu/nn/quant.py``).

Contract, as the JAX package's:
- ``weight_quantize(w [in, out]) -> (q [out, in] int8/fp8, scale [out]
  f32)``, per output channel, symmetric: ``scale = absmax / bound`` is
  the DEQUANT multiplier, ``q = round(w / max(scale, 1e-10))``;
- ``weight_only_linear(x, q, bias, scale)`` computes
  ``x @ dequant(q).T + bias`` in x's dtype, through the hand-written
  ``kernels.quant_matmul`` (K9) wherever ``quant_matmul_dispatch``
  accepts the call, and through the plain product of the weight scaled
  in x's dtype where it declines (where the JAX package runs XLA);
- ``WeightOnlyLinear`` holds ``qweight`` [out, in], ``scale`` [out] f32
  and an optional ``bias`` as buffers, under the JAX layer's names, so
  state dicts line up.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.quant_matmul import quant_matmul, quant_matmul_dispatch
from ..quantization.intx import (div_exact, format_bound, format_dtype,
                                 format_of_dtype, pack_absmax)

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "WeightOnlyLinear", "quantize_for_inference"]

_ALGO_FMT = {"weight_only_int8": "int8", "weight_only_fp8": "fp8"}


def weight_quantize(x, algo: str = "weight_only_int8", arch=None,
                    group_size: int = -1):
    """Quantize a [in, out] float weight; returns (int8-or-fp8 [out, in],
    f32 scale [out], the dequant multiplier absmax / bound). ``arch`` is
    accepted for API compatibility and ignored; only per-channel
    (``group_size=-1``) scales are implemented."""
    if algo not in _ALGO_FMT:
        raise NotImplementedError(
            f"algo={algo!r}: only 'weight_only_int8' / 'weight_only_fp8' "
            "are implemented")
    if group_size != -1:
        raise NotImplementedError("only per-channel (group_size=-1) scales")
    fmt = _ALGO_FMT[algo]
    sdt = format_dtype(fmt)
    bound = format_bound(fmt)
    with torch.no_grad():
        wt = x.detach().float().t()                   # [out, in]
        scale = div_exact(wt.abs().amax(dim=1), bound)
        safe = torch.clamp(scale, min=1e-10)
        if fmt == "int8":
            q = torch.clamp(torch.round(wt / safe[:, None]), -bound, bound) \
                .to(torch.int8)
        else:
            q = torch.clamp(wt / safe[:, None], -bound, bound).to(sdt)
    return q.contiguous(), scale


def weight_dequantize(x, scale, algo: str = "weight_only_int8",
                      out_dtype=torch.float16, group_size: int = -1):
    """int8/fp8 [out, in] + scale [out] -> float [in, out]."""
    if algo not in _ALGO_FMT:
        raise NotImplementedError(
            "only 'weight_only_int8' / 'weight_only_fp8'")
    if group_size != -1:
        raise NotImplementedError("only per-channel (group_size=-1) scales")
    if isinstance(out_dtype, str):
        out_dtype = getattr(torch, out_dtype)
    return (x.float() * scale.float()[:, None]).t().to(out_dtype)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype: str = "int8", arch=None,
                       group_size: int = -1):
    """``x [.., in] @ dequant(weight [out, in]).T + bias`` in x's dtype."""
    if weight_dtype not in ("int8", "fp8"):
        raise NotImplementedError("only weight_dtype='int8' or 'fp8'")
    if weight_scale is None:
        raise ValueError("weight_scale is required for int8/fp8 weights")
    if group_size != -1:
        raise NotImplementedError("only per-channel (group_size=-1) scales")
    if quant_matmul_dispatch(dtype=x.dtype, fmt=weight_dtype):
        out = quant_matmul(x, weight, weight_scale)
    else:
        w = weight.to(x.dtype) * weight_scale[:, None].to(x.dtype)
        out = torch.matmul(x, w.t())
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


class WeightOnlyLinear(nn.Module):
    """Inference twin of ``nn.Linear`` with an int8/fp8 weight and a
    per-channel scale (buffers, not parameters: a serving artifact)."""

    def __init__(self, qweight, scale, bias=None):
        super().__init__()
        self.register_buffer("qweight", qweight.detach())
        self.register_buffer("scale", scale.detach().float())
        if bias is not None:
            self.register_buffer("bias", bias.detach())
        else:
            self.bias = None

    @classmethod
    def from_linear(cls, linear, fmt: str = "int8", scale=None):
        """``fmt`` picks the storage ("int8" or "fp8" e4m3); ``scale``
        optionally supplies per-out-channel ABSMAX values (as
        ``quantization.PerChannelAbsmaxObserver`` gives them) instead of
        reading them off the live weight."""
        with torch.no_grad():
            if scale is None:
                q, dq_scale = weight_quantize(linear.weight.t(),
                                              algo=f"weight_only_{fmt}")
            else:
                absmax = torch.as_tensor(scale).to(
                    device=linear.weight.device, dtype=torch.float32) \
                    .reshape(-1)
                q = pack_absmax(linear.weight, absmax[:, None], fmt)
                dq_scale = div_exact(absmax, format_bound(fmt))
        return cls(q, dq_scale, linear.bias)

    @property
    def fmt(self) -> str:
        return format_of_dtype(self.qweight.dtype)

    def forward(self, x):
        return weight_only_linear(x, self.qweight, self.bias, self.scale,
                                  weight_dtype=self.fmt)


def quantize_for_inference(model, include=None, fmt: str = "int8"):
    """Replace every ``nn.Linear`` in ``model`` (in place) with a
    ``WeightOnlyLinear`` built from its weights by ``weight_quantize``.
    ``include``: optional ``fn(qualified_name, layer) -> bool`` filter.
    Returns the model in eval mode."""

    def _walk(layer, prefix):
        for name, sub in list(layer.named_children()):
            qual = f"{prefix}.{name}" if prefix else name
            if isinstance(sub, nn.Linear):
                if include is None or include(qual, sub):
                    setattr(layer, name,
                            WeightOnlyLinear.from_linear(sub, fmt=fmt))
            else:
                _walk(sub, qual)

    _walk(model, "")
    model.eval()
    return model
