"""ResNet training parity with the JAX package (fp32, CPU), on the stack
of ``resnet_stack.py`` fused in both packages
(``PADDLE_TPU_FUSED_CONV=1``):

- in training the chain runs as in the JAX package: a unit fed by a fused
  unit of its block takes the prologue kernel;
- three ``ShardedTrainStep`` Momentum steps route the units as the JAX
  step's trace does, with losses to rtol 1e-5, every weight to atol
  1e-5, and the BatchNorm buffers left at their initial values, as the
  JAX step leaves them;
- an eager train-mode forward updates the running statistics as the JAX
  package's does: Paddle's momentum, the biased variance, fused units
  from the kernels' batch statistics (atol 1e-6, rtol 1e-5).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed.engine import ShardedTrainStep as JStep
from paddle_tpu.distributed.mesh import ProcessMesh

import resnet_stack
from paddle_tpu_torch.distributed import ShardedTrainStep
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import layers_conv_norm as lcn
from paddle_tpu_torch.optimizer import Momentum
from resnet_stack import delta, jax_dispatch

LR = 0.05

@pytest.fixture
def stacks(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_CONV", "1")
    return resnet_stack.stacks()


def test_stack_chains_like_jax(stacks, monkeypatch):
    """In training, a unit fed by a fused unit runs with its prologue:
    conv2 and conv3 of the stride-1 block; every conv1 and the conv3 after
    the stride-2 conv2 take plain conv_stats."""
    from paddle_tpu_torch.kernels import fused_conv as tfc

    _, tm, x, _ = stacks
    calls = {"conv_stats": 0, "conv_stats_pre": 0}
    for name in calls:
        def counted(*a, _f=getattr(tfc, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(tfc, name, counted)
    tm.train()
    tm(torch.from_numpy(x))
    assert calls == {"conv_stats": 3, "conv_stats_pre": 2}


def test_stack_train_steps_match_jax(stacks):
    """Three Momentum steps; the JAX step's trace routes the units as the
    port's steps do."""
    jm, tm, x, y = stacks
    jm.train()
    tm.train()
    jopt = paddle.optimizer.Momentum(learning_rate=LR, momentum=0.9,
                                     weight_decay=1e-4,
                                     parameters=jm.parameters())
    jstep = JStep(jm, lambda lo, la: JF.cross_entropy(lo, la).mean(), jopt,
                  ProcessMesh(np.arange(1), ["dp"]), dp_axis=None)
    tstep = ShardedTrainStep(
        tm, lambda lo, la: TF.cross_entropy(lo, la).mean(),
        Momentum(learning_rate=LR, momentum=0.9, weight_decay=1e-4))
    xj, yj = paddle.to_tensor(x), paddle.to_tensor(y)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    before = jax_dispatch()
    want = [float(jstep.step(xj, yj)) for _ in range(3)]
    traced = delta(jax_dispatch(), before)   # once per trace
    lcn.reset_dispatch_counter()
    got = [tstep.step(xt, yt).item() for _ in range(3)]
    assert traced == {("hit", "train"): 5, ("fallback", "ineligible"): 2}
    assert dict(lcn.FUSED_CONV_DISPATCH) == {k: 3 * v
                                             for k, v in traced.items()}
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k, p in tstep.params.items():
        w = np.asarray(jstep.params[k])
        if k == "fc.weight":
            w = w.T
        np.testing.assert_allclose(p.numpy(), w, atol=1e-5, rtol=0,
                                   err_msg=k)
    # BatchNorm buffers: the JAX step never returns the running-stat
    # update of its traced forward, so they keep their initial values;
    # the port's step leaves them alike, in the step and in the model
    jstep.sync_weights_to_model()
    tstep.sync_weights_to_model()
    for k, b in tstep.buffers.items():
        np.testing.assert_array_equal(b.numpy(), np.asarray(jstep.buffers[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(b.numpy(),
                                      0.0 if k.endswith("_mean") else 1.0)
    for k, b in tm.named_buffers():
        np.testing.assert_array_equal(b.numpy(), tstep.buffers[k].numpy())


def test_eager_train_forward_updates_buffers_like_jax(stacks):
    """Outside the step, a train-mode forward updates the running
    statistics with Paddle's momentum and the biased variance in both
    packages (fused units from the kernels' batch statistics)."""
    jm, tm, x, _ = stacks
    jm.train()
    tm.train()
    jm(paddle.to_tensor(x))
    tm(torch.from_numpy(x))
    want = {k: np.asarray(v._data) for k, v in jm.named_buffers()}
    for k, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[k], atol=1e-6, rtol=1e-5,
                                   err_msg=k)
