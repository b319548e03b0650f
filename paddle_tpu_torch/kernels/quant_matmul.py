"""Weight-only quantized matmul with the dequant fused into the weight
load (counterpart of ``paddle_tpu/pallas_kernels/quant_matmul.py``).

``quant_matmul(x [..., K], qweight [N, K] int8/fp8, scale [N] f32)``
computes ``x @ qweight.to(x.dtype).T`` with fp32 accumulation, multiplies
the fp32 sum by the per-output-channel ``scale`` and casts the result to
x's dtype: the TPU kernel's math, whose per-channel scale moves from the
weight to the accumulator. Widening int8 or e4m3 to bf16 is exact, so
kernel and plain version differ only by summation order.

The wrapper takes its plain version (``quant_matmul_ref``) only for
tensors on the CPU. For CUDA tensors it launches the hand-written kernel
of ``csrc/quant_matmul.cu`` or raises; launches are counted in
``LAUNCHES``. ``quant_matmul_dispatch`` keeps the JAX package's gates
(dtype, grad mode) with hits counted by format and fallbacks by reason.
"""

from __future__ import annotations

from collections import Counter

import torch

from ..quantization.intx import format_of_dtype
from ._build import load_library

__all__ = ["quant_matmul", "quant_matmul_ref", "quant_matmul_dispatch",
           "LAUNCHES", "DISPATCH_HITS", "DISPATCH_FALLBACKS",
           "reset_counters"]

LAUNCHES = {"quant_matmul": 0}
DISPATCH_HITS: Counter = Counter()
DISPATCH_FALLBACKS: Counter = Counter()


def reset_counters() -> None:
    """Zero the launch count and the dispatch hit/fallback counters."""
    LAUNCHES["quant_matmul"] = 0
    DISPATCH_HITS.clear()
    DISPATCH_FALLBACKS.clear()


def quant_matmul_dispatch(*, dtype, fmt: str) -> bool:
    """True -> run ``quant_matmul``; False -> the plain weight-only
    linear (``nn.quant.weight_only_linear``), with the reason counted."""
    reason = None
    if dtype not in (torch.float32, torch.bfloat16):
        reason = "dtype"
    elif torch.is_grad_enabled():
        # forward-only kernel: quantized weights are a serving artifact
        reason = "grad_mode"
    if reason is None:
        DISPATCH_HITS[fmt] += 1
        return True
    DISPATCH_FALLBACKS[reason] += 1
    return False


def quant_matmul_ref(x, qweight, scale):
    """Plain PyTorch version of ``quant_matmul`` (the kernel's math):
    fp32 product of x and the widened weight, times the scale, cast."""
    w = qweight.to(x.dtype).float()
    out = torch.matmul(x.float(), w.t()) * scale.float()
    return out.to(x.dtype)


def _check(x2, qweight, scale):
    M, K = x2.shape
    N = qweight.shape[0]
    if qweight.dim() != 2 or qweight.shape[1] != K:
        raise ValueError(f"quant_matmul: qweight must be [N, K={K}], got "
                         f"{tuple(qweight.shape)}")
    if tuple(scale.shape) != (N,) or scale.dtype != torch.float32:
        raise ValueError(f"quant_matmul: scale must be float32 [N={N}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_matmul: x must be float32 or bfloat16, got "
                        f"{x2.dtype}")
    if format_of_dtype(qweight.dtype) == "bf16":
        raise TypeError(f"quant_matmul: qweight must be int8 or "
                        f"float8_e4m3fn, got {qweight.dtype}")
    if K % 16:
        raise ValueError(f"quant_matmul: K ({K}) must be a multiple of 16")
    if any(t.device != x2.device for t in (qweight, scale)):
        raise ValueError(f"quant_matmul: all inputs must be on {x2.device}")
    if not all(t.is_contiguous() for t in (x2, qweight, scale)):
        raise ValueError("quant_matmul: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (x2, qweight)):
        raise ValueError("quant_matmul: x and qweight must be 16-byte "
                         "aligned")


def quant_matmul(x, qweight, scale):
    """``x [..., K] @ dequant(qweight [N, K]).T`` -> [..., N] in x's
    dtype; ``scale`` [N] f32 is the per-output-channel dequant multiplier
    (``nn.quant.weight_quantize``'s convention)."""
    if x.device.type == "cpu":
        return quant_matmul_ref(x, qweight, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    lead = tuple(x.shape[:-1])
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    _check(x2, qweight, scale)
    M, N = x2.shape[0], qweight.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M:
        lib = load_library("quant_matmul.cu")
        rc = lib.paddle_quant_matmul(
            x2.data_ptr(), qweight.data_ptr(), scale.data_ptr(),
            out.data_ptr(), int(x.dtype == torch.bfloat16),
            int(format_of_dtype(qweight.dtype) == "fp8"), M, N, K,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"quant_matmul: kernel launch failed "
                               f"(cudaError {rc})")
        LAUNCHES["quant_matmul"] += 1
    return out.reshape(lead + (N,))
