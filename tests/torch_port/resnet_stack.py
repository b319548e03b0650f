"""A small ResNet stack built in both packages on the same weights, for
the ResNet parity tests: two ``BottleneckBlock``s (stride 1, then stride
2 with a conv downsample) and a pooled fc head, channels-last, with the
JAX package's fusion-dispatch counter read out.

The port's seeded initializers make the weights; the JAX model is built
under ``jax_zero_init`` and then takes the port's state. Drawing the JAX
package's random initial weights compiles one XLA program per parameter
shape, which costs more than the tests themselves on the CPU (about 13 s
for ResNet-50, 5 s for this stack)."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.initializer as jinit
from paddle_tpu.observability.metrics import get_registry
from paddle_tpu.vision.models import resnet as jresnet

from paddle_tpu_torch.models import export_paddle_tpu_state
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import layers_conv_norm as lcn
from paddle_tpu_torch.nn import layout as tlayout
from paddle_tpu_torch.vision.models import resnet as tresnet


@contextlib.contextmanager
def jax_zero_init():
    """Every random initializer of the JAX package returns zeros (from
    numpy, so nothing compiles) while the JAX model is built; the caller
    then loads real weights into it."""
    def zeros(self, shape, dtype):
        return jnp.asarray(np.zeros(shape, np.dtype(dtype)))

    with pytest.MonkeyPatch.context() as mp:
        for cls in (jinit.Normal, jinit.TruncatedNormal, jinit.Uniform,
                    jinit.XavierNormal, jinit.XavierUniform,
                    jinit.KaimingNormal, jinit.KaimingUniform):
            mp.setattr(cls, "__call__", zeros)
        yield


def load_into_jax(jm, tm):
    """The port model's whole state (buffers included) into the JAX one."""
    missing, unexpected = jm.set_state_dict(export_paddle_tpu_state(tm))
    assert not missing and not unexpected, (missing, unexpected)
    return jm


def jax_dispatch():
    fam = get_registry().get("paddle_tpu_fused_conv_dispatch_total")
    if fam is None:
        return {}
    return {(s["labels"]["result"], s["labels"]["reason"]): s["value"]
            for s in fam.collect()}


def delta(after, before):
    return {k: int(v - before.get(k, 0)) for k, v in after.items()
            if v - before.get(k, 0)}


class JStack(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.b1 = jresnet.BottleneckBlock(16, 4)
        down = jnn.Sequential(
            jnn.Conv2D(16, 32, 1, stride=2, bias_attr=False),
            jnn.BatchNorm2D(32))
        self.b2 = jresnet.BottleneckBlock(16, 8, stride=2, downsample=down)
        self.pool = jnn.AdaptiveAvgPool2D((1, 1))
        self.fc = jnn.Linear(32, 10)

    def forward(self, x):
        x = self.pool(self.b2(self.b1(x)))
        return self.fc(paddle.flatten(x, 1))


class TStack(torch.nn.Module):
    def __init__(self):
        super().__init__()
        kw = dict(device="cpu")
        self.b1 = tresnet.BottleneckBlock(16, 4, **kw)
        down = torch.nn.Sequential(
            lcn.Conv2D(16, 32, 1, stride=2, bias_attr=False, **kw),
            lcn.BatchNorm2D(32, **kw))
        self.b2 = tresnet.BottleneckBlock(16, 8, stride=2, downsample=down,
                                          **kw)
        self.pool = lcn.AdaptiveAvgPool2D((1, 1))
        self.fc = torch.nn.Linear(32, 10, **kw)

    def forward(self, x):
        x = self.pool(self.b2(self.b1(x)))
        return self.fc(TF.flatten(x, 1))


def stacks():
    """(jax_stack, port_stack, x, y): seeded weights, NCHW input batch."""
    torch.manual_seed(3)
    tm = TStack()
    with jax_zero_init():
        jm = JStack()
    load_into_jax(jm, tm)
    paddle.nn.to_channels_last(jm)
    tlayout.to_channels_last(tm)
    rng = np.random.RandomState(0)
    x = rng.randn(4, 16, 8, 8).astype(np.float32)
    y = rng.randint(0, 10, (4,)).astype(np.int64)
    return jm, tm, x, y
