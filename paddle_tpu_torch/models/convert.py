"""Carry weights from the JAX package's models (Llama, ResNet) into the
port.

The JAX model's ``{k: np.asarray(v._data) for k, v in
model.state_dict().items()}`` uses the same key names as the port,
buffers (BatchNorm's ``_mean``/``_variance``) included. Its ``nn.Linear``
stores ``[in, out]``; torch stores ``[out, in]``, so the weight of every
``torch.nn.Linear`` of the port's model (a Llama's ``*_proj`` and
``lm_head``, a ResNet's ``fc``) is transposed on the way in (the reverse
of the JAX package's ``convert_hf_llama_state_dict``); conv weights are
OIHW in both and cross unchanged. ``export_paddle_tpu_state`` goes the
other way.

A model converted for weight-only serving carries ``*.qweight`` [out,
in] (int8 or fp8 e4m3) and ``*.scale`` [out] f32 in both packages: they
load with their layout kept, and fp8 crosses as its bytes (numpy's e4m3
comes from ml_dtypes, a dtype of kind ``V``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_paddle_tpu_state", "export_paddle_tpu_state"]


def _linear_weights(model: torch.nn.Module) -> set:
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, torch.nn.Linear)}


def load_paddle_tpu_state(model: torch.nn.Module, state: dict):
    """Copy ``state`` (name -> numpy array) into ``model`` in place.
    Raises ``ValueError`` on a missing or leftover key or on a shape
    that does not match; returns the model."""
    own = model.state_dict()
    linear = _linear_weights(model)
    missing = sorted(set(own) - set(state))
    leftover = sorted(set(state) - set(own))
    if missing or leftover:
        raise ValueError(f"state dict mismatch: missing {missing}, "
                         f"leftover {leftover}")
    with torch.no_grad():
        for name, dst in own.items():
            arr = np.asarray(state[name])
            if dst.element_size() == 1 and dst.is_floating_point():
                # fp8: the stored bits, unchanged
                if arr.dtype.itemsize != 1:
                    raise ValueError(f"{name}: expected 1-byte fp8 values, "
                                     f"got {arr.dtype}")
                if tuple(arr.shape) != tuple(dst.shape):
                    raise ValueError(f"{name}: shape {tuple(arr.shape)} "
                                     f"does not match {tuple(dst.shape)}")
                dst.view(torch.uint8).copy_(
                    torch.from_numpy(np.array(arr.view(np.uint8))))
                continue
            if arr.dtype.kind not in "fiub":   # e.g. ml_dtypes bfloat16
                arr = arr.astype(np.float32)
            if name in linear and arr.ndim == 2:
                arr = arr.T
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {tuple(arr.shape)} does not "
                                 f"match {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(arr)))
    return model


def export_paddle_tpu_state(model: torch.nn.Module) -> dict:
    """The model's state as the JAX package names and lays it out: name ->
    numpy array, linear weights transposed back to ``[in, out]``. bf16
    tensors come out as float32 (exact); numpy has no bf16."""
    out = {}
    linear = _linear_weights(model)
    for name, t in model.state_dict().items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.numpy()
        if name in linear and arr.ndim == 2:
            arr = arr.T
        out[name] = np.ascontiguousarray(arr)
    return out
