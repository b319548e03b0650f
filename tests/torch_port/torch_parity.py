"""Shared helpers of the port's parity tests: one tiny Llama built by the
JAX package from ``paddle.seed(0)``, exported as numpy, and loaded into
the PyTorch port on the CPU."""

import numpy as np
import pytest
import torch

NO_GPU = ("no GPU in this environment; chip_smoke.py holds the kernel against "
          "its plain version")


def require_cuda():
    """Skip the calling test where no GPU is present (decided inside
    the test, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip(NO_GPU)


def jax_state(model) -> dict:
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def tiny_pair(**overrides):
    """(jax_model, port_model, jax_config) on the same weights, fp32."""
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as JConfig
    from paddle_tpu.models import LlamaForCausalLM as JLlama

    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_paddle_tpu_state)

    paddle.seed(0)
    jcfg = JConfig.tiny(**overrides)
    jm = JLlama(jcfg)
    tcfg = LlamaConfig.tiny(**overrides)
    tm = LlamaForCausalLM(tcfg, device="cpu")
    load_paddle_tpu_state(tm, jax_state(jm))
    return jm, tm, jcfg
