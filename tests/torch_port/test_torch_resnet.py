"""ResNet parity with the JAX package (fp32, CPU).

- ``resnet50(num_classes=10)``, channels-last with the space-to-depth
  stem, in eval at 2 x 3 x 32 x 32: the JAX side compiled
  (``paddle.jit.to_static``) with ``PADDLE_TPU_FUSED_CONV=0`` (its fused
  kernel cannot run layer4's 3x3 convs on 1x1 images; its own suite
  holds the fused path equal to the XLA one), the port through the fused
  route (the kernels' plain versions); 46 fused units. The port's seeded
  initializers make the weights; the JAX model takes them
  (``resnet_stack.jax_zero_init``).
  Fresh running statistics (0 and 1) leave the residual stream
  unnormalized in eval, so the logits reach a few hundred; the tolerance
  is 1e-5 of the largest logit (fp32 sums in another order differ by a
  few 1e-6 of it).
- The state dict from the JAX ResNet to a fresh port model and back: the
  same keys (BatchNorm buffers included), conv weights unchanged,
  ``fc.weight`` transposed.

The train path (a stack of blocks through ``ShardedTrainStep``) is in
``test_torch_resnet_train.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.layout import space_to_depth_stem as j_stem
from paddle_tpu.vision.models import resnet as jresnet

from paddle_tpu_torch.models import (export_paddle_tpu_state,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.nn import layers_conv_norm as lcn
from paddle_tpu_torch.nn import layout as tlayout
from paddle_tpu_torch.vision.models import resnet as tresnet
from resnet_stack import jax_zero_init, load_into_jax
from torch_parity import jax_state


@pytest.fixture(scope="module")
def resnet50_pair():
    """(jax_model, port_model, the JAX model's state before any layout
    change) on the port's seeded weights."""
    torch.manual_seed(0)
    tm = tresnet.resnet50(num_classes=10, device="cpu")
    with jax_zero_init():
        jm = jresnet.resnet50(num_classes=10)
    load_into_jax(jm, tm)
    return jm, tm, jax_state(jm)


def test_resnet50_eval_logits_match_jax(resnet50_pair, monkeypatch):
    jm, tm, _ = resnet50_pair
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    paddle.nn.to_channels_last(jm)
    j_stem(jm)
    jm.eval()
    monkeypatch.setenv("PADDLE_TPU_FUSED_CONV", "0")
    want = np.asarray(paddle.jit.to_static(jm)(paddle.to_tensor(x))._data)
    monkeypatch.delenv("PADDLE_TPU_FUSED_CONV")

    tlayout.to_channels_last(tm)
    tlayout.space_to_depth_stem(tm)
    tm.eval()
    lcn.reset_dispatch_counter()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert dict(lcn.FUSED_CONV_DISPATCH) == {("hit", "eval"): 46,
                                             ("fallback", "ineligible"): 6}
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


def test_state_dict_round_trip(resnet50_pair):
    _, _, want = resnet50_pair
    tm = tresnet.resnet50(num_classes=10, device="cpu")
    load_paddle_tpu_state(tm, want)
    got = export_paddle_tpu_state(tm)
    assert sorted(got) == sorted(want)
    assert "bn1._mean" in got and "layer4.2.bn3._variance" in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    own = tm.state_dict()
    np.testing.assert_array_equal(own["fc.weight"].numpy(), want["fc.weight"].T)
    np.testing.assert_array_equal(own["layer1.0.conv2.weight"].numpy(),
                                  want["layer1.0.conv2.weight"])
