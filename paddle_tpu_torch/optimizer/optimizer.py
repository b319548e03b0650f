"""Optimizer objects (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

``AdamW`` carries the hyperparameters, the learning rate and the step
count; the whole-step trainer (``distributed.engine.ShardedTrainStep``)
runs its functional twin. The eager, tape-driven ``step()`` of the JAX
package, the other optimizers and the LR schedulers come with a later
slice.
"""

from __future__ import annotations

__all__ = ["AdamW"]


class AdamW:
    """Decoupled weight decay; ``apply_decay_param_fun(name)`` selects the
    parameters that decay (all of them when None). ``grad_clip`` is an
    object with a ``clip_norm`` (a global-norm clip), read by the
    trainer. ``parameters`` and ``name`` are accepted as the JAX package
    accepts them; the trainer owns the parameters."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers (optimizer/lr.py) come with a "
                "later slice; pass a float")
        del parameters, name
        self._learning_rate = float(learning_rate)
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
