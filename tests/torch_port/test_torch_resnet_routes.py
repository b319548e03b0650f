"""ResNet routing parity with the JAX package (fp32, CPU), on the stack
of ``resnet_stack.py`` fused in both packages
(``PADDLE_TPU_FUSED_CONV=1``):

- in eval the same units take the fused route in both (fusion-dispatch
  counts), with the same output (atol 1e-5, rtol 1e-5). The JAX side
  runs compiled (``paddle.jit.to_static``): its dispatch counter counts
  once per trace, and one trace is one forward. The train-mode routes
  are in ``test_torch_resnet_train.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import resnet_stack
from paddle_tpu_torch.nn import layers_conv_norm as lcn
from resnet_stack import delta, jax_dispatch

@pytest.fixture
def stacks(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_CONV", "1")
    return resnet_stack.stacks()


def test_stack_eval_routes_and_output_match_jax(stacks):
    """In eval the same units take the fused route in both packages (every
    conv1 and conv3, the stride-1 conv2; not the stride-2 conv2 nor the
    stride-2 downsample), with the same output."""
    jm, tm, x, _ = stacks
    jm.eval()
    tm.eval()
    before = jax_dispatch()
    want = np.asarray(paddle.jit.to_static(jm)(paddle.to_tensor(x))._data)
    lcn.reset_dispatch_counter()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    jd = delta(jax_dispatch(), before)
    assert jd == {("hit", "eval"): 5, ("fallback", "ineligible"): 2}
    assert dict(lcn.FUSED_CONV_DISPATCH) == jd
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
