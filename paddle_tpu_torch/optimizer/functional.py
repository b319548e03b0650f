"""Functional optimizer updates for the whole-step trainer (counterpart
of ``paddle_tpu/optimizer/functional.py``).

``init(params) -> state`` and ``update(grads, state, params, lr) ->
(new_params, new_state)`` over dicts of tensors keyed by parameter
name, as the JAX package's pure pairs are over pytrees. Inputs are left
untouched; new tensors come back. The updates run as ``torch._foreach_*``
calls, one multi-tensor launch per operation rather than one per
parameter, with the JAX package's arithmetic in the same order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["FunctionalOptimizer", "adamw", "momentum", "clip_by_global_norm",
           "from_eager"]


class FunctionalOptimizer(NamedTuple):
    init: Callable    # params -> state
    update: Callable  # (grads, state, params, lr) -> (new_params, new_state)


def _f32(x) -> float:
    """A Python float holding the fp32 value of ``x``: scalar factors are
    formed in fp32, as the JAX package forms them from its fp32 lr and
    step count."""
    return float(np.float32(x))


def adamw(beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8,
          weight_decay: float = 0.01,
          decay_mask_fn: Optional[Callable] = None) -> FunctionalOptimizer:
    """AdamW with fp32 moments (bf16 params supported). ``decay_mask_fn``:
    parameter-name predicate; names it rejects get no weight decay.

    Per parameter, in this order: ``p32 = p * (1 - lr * wd)``; ``m = b1 *
    m + (1 - b1) * g``; ``v = b2 * v + (1 - b2) * g^2``; ``p32 - lr *
    mhat / (sqrt(vhat) + eps)`` with the bias-corrected moments; cast back
    to the parameter's dtype."""

    def init(params):
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return {"m": zeros, "v": {k: torch.zeros_like(z)
                                  for k, z in zeros.items()},
                "t": 0.0}

    def update(grads, state, params, lr):
        t = np.float32(state["t"]) + np.float32(1.0)
        lr32 = np.float32(lr)
        bc1 = _f32(np.float32(1.0) - np.float32(beta1) ** t)
        bc2 = _f32(np.float32(1.0) - np.float32(beta2) ** t)
        names = [k for k in params if grads.get(k) is not None]
        new_p = dict(params)
        new_m, new_v = dict(state["m"]), dict(state["v"])
        # one group per weight decay: the decay factor is one scalar each
        groups: dict = {}
        for k in names:
            wd = weight_decay
            if decay_mask_fn is not None and not decay_mask_fn(k):
                wd = 0.0
            groups.setdefault(wd, []).append(k)
        for wd, ks in groups.items():
            p32 = [params[k].float() for k in ks]
            g32 = [grads[k].float() for k in ks]
            p32 = torch._foreach_mul(p32, _f32(np.float32(1.0)
                                               - lr32 * np.float32(wd)))
            m = torch._foreach_mul([state["m"][k] for k in ks], beta1)
            torch._foreach_add_(m, torch._foreach_mul(g32, 1 - beta1))
            v = torch._foreach_mul([state["v"][k] for k in ks], beta2)
            torch._foreach_add_(v, torch._foreach_mul(
                torch._foreach_mul(g32, g32), 1 - beta2))
            mhat = torch._foreach_div(m, bc1)
            vhat = torch._foreach_div(v, bc2)
            denom = torch._foreach_add(torch._foreach_sqrt(vhat), epsilon)
            step = torch._foreach_div(torch._foreach_mul(mhat, float(lr32)),
                                      denom)
            out = torch._foreach_sub(p32, step)
            for k, o, mk, vk in zip(ks, out, m, v):
                new_p[k] = o.to(params[k].dtype)
                new_m[k], new_v[k] = mk, vk
        return new_p, {"m": new_m, "v": new_v, "t": float(t)}

    return FunctionalOptimizer(init, update)


def momentum(mu: float = 0.9, weight_decay: float = 0.0,
             use_nesterov: bool = False) -> FunctionalOptimizer:
    """SGD with momentum, fp32 velocity. Per parameter: ``g32 = g +
    wd * p`` (L2 decay on the gradient, in fp32); ``v = mu * v + g32``;
    ``p - lr * (g32 + mu * v if nesterov else v)`` in fp32, cast back to
    the parameter's dtype."""

    def init(params):
        return {"velocity": {k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in params.items()}}

    def update(grads, state, params, lr):
        lr32 = _f32(lr)
        names = [k for k in params if grads.get(k) is not None]
        new_p, new_v = dict(params), dict(state["velocity"])
        if not names:
            return new_p, {"velocity": new_v}
        g32 = [grads[k].float() for k in names]
        p32 = [params[k].float() for k in names]
        if weight_decay:
            g32 = torch._foreach_add(g32, torch._foreach_mul(
                p32, float(weight_decay)))
        v = torch._foreach_add(torch._foreach_mul(
            [state["velocity"][k] for k in names], mu), g32)
        step = torch._foreach_add(g32, torch._foreach_mul(v, mu)) \
            if use_nesterov else v
        out = torch._foreach_sub(p32, torch._foreach_mul(step, lr32))
        for k, o, vk in zip(names, out, v):
            new_p[k] = o.to(params[k].dtype)
            new_v[k] = vk
        return new_p, {"velocity": new_v}

    return FunctionalOptimizer(init, update)


def clip_by_global_norm(grads, clip_norm: float):
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``
    (the norm in fp32, summed in sorted-name order as the JAX package's
    dict pytree flattens); returns (clipped grads, global norm)."""
    names = sorted(k for k, g in grads.items() if g is not None)
    total = sum(torch.sum(torch.square(grads[k].float())) for k in names)
    gnorm = torch.sqrt(total)
    scale = clip_norm / torch.clamp(gnorm, min=clip_norm)
    out = {k: (None if g is None else (g.float() * scale).to(g.dtype))
           for k, g in grads.items()}
    return out, gnorm


def from_eager(opt) -> FunctionalOptimizer:
    """The functional twin of an optimizer object (``AdamW``,
    ``Momentum``)."""
    from .optimizer import AdamW, Momentum

    if isinstance(opt, AdamW):
        return adamw(opt._beta1, opt._beta2, opt._epsilon, opt._wd,
                     decay_mask_fn=opt._apply_decay_param_fun)
    if isinstance(opt, Momentum):
        return momentum(opt._momentum, opt._weight_decay, opt._use_nesterov)
    raise NotImplementedError(
        f"no functional twin for {type(opt).__name__}: the port has AdamW "
        "and Momentum; the other optimizers come with a later slice")
