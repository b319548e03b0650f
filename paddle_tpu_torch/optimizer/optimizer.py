"""Optimizer objects (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

``AdamW`` and ``Momentum`` carry the hyperparameters, the learning rate
and the step count; the whole-step trainer
(``distributed.engine.ShardedTrainStep``) runs their functional twins. The eager, tape-driven ``step()`` of the JAX
package, the other optimizers and the LR schedulers come with a later
slice.
"""

from __future__ import annotations

__all__ = ["AdamW", "Momentum"]


def _float_lr(learning_rate) -> float:
    if not isinstance(learning_rate, (int, float)):
        raise NotImplementedError(
            "learning-rate schedulers (optimizer/lr.py) come with a "
            "later slice; pass a float")
    return float(learning_rate)


def _decay_coeff(weight_decay) -> float:
    """Paddle's ``weight_decay``: None, a float, or a regularizer object
    with a ``coeff`` (L2Decay)."""
    if weight_decay is None:
        return 0.0
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay)
    return float(getattr(weight_decay, "_coeff",
                         getattr(weight_decay, "coeff", 0.0)))


class AdamW:
    """Decoupled weight decay; ``apply_decay_param_fun(name)`` selects the
    parameters that decay (all of them when None). ``grad_clip`` is an
    object with a ``clip_norm`` (a global-norm clip), read by the
    trainer. ``parameters`` and ``name`` are accepted as the JAX package
    accepts them; the trainer owns the parameters."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None, name=None):
        del parameters, name
        self._learning_rate = _float_lr(learning_rate)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._wd = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._grad_clip = grad_clip
        self._step_count = 0

    def get_lr(self) -> float:
        return self._learning_rate

    def step(self):
        raise NotImplementedError(
            "the eager tape-driven step comes with a later slice; train "
            "with paddle_tpu_torch.distributed.engine.ShardedTrainStep")


class Momentum:
    """SGD with momentum: an fp32 velocity, L2 weight decay added to the
    gradient, optionally Nesterov. ``weight_decay`` is None, a float or
    an object with a ``coeff``; ``parameters``, ``grad_clip`` and
    ``name`` as for ``AdamW``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        del parameters, name
        self._learning_rate = _float_lr(learning_rate)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._weight_decay = _decay_coeff(weight_decay)
        self._grad_clip = grad_clip
        self._step_count = 0

    def get_lr(self) -> float:
        return self._learning_rate

    def step(self):
        raise NotImplementedError(
            "the eager tape-driven step comes with a later slice; train "
            "with paddle_tpu_torch.distributed.engine.ShardedTrainStep")
