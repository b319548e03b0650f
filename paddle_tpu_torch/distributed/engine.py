"""The training step (counterpart of ``paddle_tpu/distributed/engine.py``).

``ShardedTrainStep`` owns the parameters and buffers between steps, as
the JAX engine owns its sharded arrays: each ``step`` runs the model
forward on them (``torch.func.functional_call``), the loss, the backward,
an optional global-norm clip and the functional optimizer (AdamW or
momentum), and keeps the new parameters. The model is synced on demand
(``sync_weights_to_model`` / ``sync_weights_from_model``).

Buffers stay as the step found them, as in the JAX engine: its step
function returns the loss, parameters and optimizer state only, so the
running statistics a train-mode BatchNorm updates inside the traced
forward are dropped. Here each forward runs on copies of the buffers,
whose updates are dropped alike. This slice runs on one device: a mesh of
more than one device, a data-parallel axis, remat and optimizer-state
sharding raise ``NotImplementedError`` until the distributed slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import functional_call

from ..optimizer import functional as fopt

__all__ = ["ShardedTrainStep"]

_LATER = "comes with the distributed training slice of the port"


def _devices_in(mesh) -> int:
    if mesh is None:
        return 1
    ids = getattr(mesh, "process_ids", None)
    if ids is None:
        raise TypeError(f"mesh must be None or carry process_ids, got "
                        f"{type(mesh).__name__}")
    return len(ids)


class ShardedTrainStep:
    """One optimizer step per ``step(inputs, labels)`` for ``model`` on its
    own device. ``loss_fn(outputs, *labels) -> scalar tensor``."""

    def __init__(self, model, loss_fn: Callable, optimizer, mesh=None,
                 dp_axis: Optional[str] = None,
                 grad_clip_norm: Optional[float] = None,
                 shard_optimizer_states: bool = False, remat=False):
        if _devices_in(mesh) > 1:
            raise NotImplementedError(f"a mesh of more than one device {_LATER}")
        if dp_axis is not None:
            raise NotImplementedError(f"data parallelism (dp_axis) {_LATER}")
        if remat:
            raise NotImplementedError(f"remat {_LATER}")
        if shard_optimizer_states:
            raise NotImplementedError(f"shard_optimizer_states (ZeRO) {_LATER}")
        self.model = model
        self.loss_fn = loss_fn
        self._eager_opt = optimizer
        self._fopt = fopt.from_eager(optimizer)
        clip = getattr(optimizer, "_grad_clip", None)
        self.grad_clip_norm = grad_clip_norm if grad_clip_norm is not None \
            else getattr(clip, "clip_norm", None)
        self.sync_weights_from_model()
        self.opt_state = self._fopt.init(self.params)

    def _device(self):
        return next(iter(self.params.values())).device

    def _to_device(self, xs):
        xs = xs if isinstance(xs, (list, tuple)) else (xs,)
        return tuple(torch.as_tensor(x, device=self._device()) for x in xs)

    def step(self, inputs, labels) -> torch.Tensor:
        """One optimizer step; returns the loss (a detached fp32 scalar)."""
        inputs, labels = self._to_device(inputs), self._to_device(labels)
        names = list(self.params)
        leaves = [self.params[k].requires_grad_(True) for k in names]
        bufs = {k: b.clone() for k, b in self.buffers.items()}
        outs = functional_call(self.model, {**self.params, **bufs}, inputs)
        outs = outs if isinstance(outs, (list, tuple)) else (outs,)
        loss = self.loss_fn(*outs, *labels)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        del outs
        with torch.no_grad():
            if self.grad_clip_norm is not None:
                grads, _ = fopt.clip_by_global_norm(grads,
                                                    self.grad_clip_norm)
            params = {k: p.detach() for k, p in self.params.items()}
            self.params, self.opt_state = self._fopt.update(
                grads, self.opt_state, params, self._eager_opt.get_lr())
        self._eager_opt._step_count += 1
        return loss.detach()

    def sync_weights_to_model(self) -> None:
        """Copy the engine's parameters and buffers into the model's (for
        eval or export)."""
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(self.params[k])
            for k, b in self.model.named_buffers():
                b.copy_(self.buffers[k])

    def sync_weights_from_model(self) -> None:
        """Take the model's current weights and buffers as the engine's
        (after loading a state dict); the optimizer moments are kept."""
        self.params = {k: p.detach().clone()
                       for k, p in self.model.named_parameters()}
        self.buffers = {k: b.detach().clone()
                        for k, b in self.model.named_buffers()}
