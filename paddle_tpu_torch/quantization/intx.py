"""Real int8/fp8 pack/unpack: the storage half of the absmax scheme
(counterpart of ``paddle_tpu/quantization/intx.py``).

Values are stored narrow (int8, or float8 e4m3) beside an absmax scale,
under the JAX package's convention and op order:

    q      = clip(round(x / max(scale, 1e-9) * bound), -bound, bound)
    x_hat  = q * max(scale, 1e-9) / bound

Rounding is half-to-even (``torch.round``, as ``jnp.round``); fp8
replaces round + clip by the e4m3 cast, whose rounding is the format,
with bound 448 (the largest finite e4m3). Every division is a true,
correctly rounded one on every device (``div_exact``), so a card gives
the CPU's and the JAX package's bits. The quantized KV caches
(``generation``) and the weight-only linears (``nn.quant``,
``quantization.ptq_serving``) build on these.
"""

from __future__ import annotations

import torch

__all__ = ["KV_FORMATS", "INT8_BOUND", "FP8_BOUND", "fp8_dtype",
           "fp8_available", "format_bound", "format_dtype",
           "format_itemsize", "format_of_dtype", "pack_absmax",
           "unpack_absmax", "absmax_along", "div_exact"]

# storage formats of the quantized serving paths; "bf16" means "not
# quantized: store the compute dtype" and is the default
KV_FORMATS = ("bf16", "int8", "fp8")

INT8_BOUND = 127.0
FP8_BOUND = 448.0  # float8_e4m3 max finite magnitude


def fp8_dtype():
    """``torch.float8_e4m3fn``, or None on a torch build without it."""
    return getattr(torch, "float8_e4m3fn", None)


def fp8_available() -> bool:
    return fp8_dtype() is not None


def format_bound(fmt: str) -> float:
    if fmt == "int8":
        return INT8_BOUND
    if fmt == "fp8":
        return FP8_BOUND
    raise ValueError(f"no quantization bound for format {fmt!r} "
                     f"(quantized formats: int8, fp8)")


def format_dtype(fmt: str):
    """Storage dtype of a quantized format."""
    if fmt == "int8":
        return torch.int8
    if fmt == "fp8":
        dt = fp8_dtype()
        if dt is None:
            raise ValueError(
                "kv/weight format 'fp8' needs torch.float8_e4m3fn, which "
                "this torch build does not have; use 'int8' (same scale "
                "convention)")
        return dt
    raise ValueError(f"no storage dtype for format {fmt!r}")


def format_itemsize(fmt: str) -> int:
    """Bytes per stored element (int8 and fp8 are both 1)."""
    return torch.empty((), dtype=format_dtype(fmt)).element_size()


def format_of_dtype(dtype) -> str:
    """"int8" / "fp8" for a storage dtype, "bf16" for anything else."""
    if dtype == torch.int8:
        return "int8"
    if dtype is not None and dtype == fp8_dtype():
        return "fp8"
    return "bf16"


def div_exact(x, d: float):
    """``x / d`` correctly rounded on every device. PyTorch's CUDA kernels
    divide by a Python-scalar divisor as a multiply by its reciprocal,
    which can land one float32 step away; a 0-dim tensor divisor on x's
    device keeps the true division."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def absmax_along(x, dim):
    """Absmax reduction in fp32: the scale the observers use."""
    return x.float().abs().amax(dim=dim)


def pack_absmax(x, scale, fmt: str = "int8"):
    """Quantize ``x`` to the format's storage dtype given the absmax
    ``scale`` (broadcastable against x)."""
    bound = format_bound(fmt)
    s = torch.clamp(torch.as_tensor(scale, dtype=torch.float32,
                                    device=x.device), min=1e-9)
    scaled = x.float() / s * bound
    if fmt == "int8":
        return torch.clamp(torch.round(scaled), -bound, bound) \
            .to(torch.int8)
    return torch.clamp(scaled, -bound, bound).to(format_dtype(fmt))


def unpack_absmax(q, scale, fmt: str = "int8", dtype=torch.float32):
    """Dequantize storage values back to ``dtype`` given the absmax
    ``scale`` they were packed with: ``q * s / bound`` in that order."""
    bound = format_bound(fmt)
    s = torch.clamp(torch.as_tensor(scale, dtype=torch.float32,
                                    device=q.device), min=1e-9)
    return div_exact(q.float() * s, bound).to(dtype)
