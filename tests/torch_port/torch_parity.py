"""Shared helpers of the port's parity tests: one tiny Llama (or GPT)
built by the JAX package from ``paddle.seed``, exported as numpy, and
loaded into the PyTorch port on the CPU."""

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


def gpt_pair(seed=1, **overrides):
    """(jax_model, port_model, jax_config): a ``GPTConfig.tiny`` GPT built
    by the JAX package from ``paddle.seed(seed)`` and its weights in the
    port, fp32 on the CPU."""
    import paddle_tpu as paddle
    from paddle_tpu.models import GPTConfig as JConfig
    from paddle_tpu.models import GPTForCausalLM as JGPT

    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_paddle_tpu_state)

    paddle.seed(seed)
    jcfg = JConfig.tiny(**overrides)
    jm = JGPT(jcfg)
    tm = GPTForCausalLM(GPTConfig.tiny(**overrides), device="cpu")
    load_paddle_tpu_state(tm, jax_state(jm))
    return jm, tm, jcfg


CHAIN_SEED = 20250805   # tests/test_spec_decode.py's SEED
TREE_SEED = 20250807    # tests/test_spec_tree.py's SEED


def gpt_spec_pair():
    """(jax target, jax draft, port target, port draft, config): the JAX
    package's speculative GPT fixture (``paddle.seed(5)``,
    ``max_position_embeddings=256``), the draft its first layer by
    ``truncated_draft`` in each package."""
    from paddle_tpu import generation as jgen

    from paddle_tpu_torch import generation as tgen

    jm, tm, cfg = gpt_pair(seed=5, max_position_embeddings=256)
    return (jm, jgen.truncated_draft(jm, 1), tm, tgen.truncated_draft(tm, 1),
            cfg)


def prompt32(rng, cfg, n):
    """The JAX package's test prompt: ``n`` int32 tokens in [1, vocab)."""
    return rng.randint(1, cfg.vocab_size, n).astype("int32")


def serve_cases(eng, prompts, cases):
    """Submit each prompt with its case's request parameters (``cases``:
    (prompt length, params) pairs), run the engine until idle; returns
    (the token lists, the requests)."""
    reqs = [eng.submit(p, **kw) for p, (_, kw) in zip(prompts, cases)]
    eng.run_until_idle(max_steps=2000)
    assert all(r.status == "completed" for r in reqs)
    return [list(r.output_tokens) for r in reqs], reqs


def generate_case(model, prompt, params):
    """The port's B = 1 ``generate`` of ``prompt`` with a request's
    parameters (its ``spec_k`` belongs to the engine)."""
    kw = {k: v for k, v in params.items() if k != "spec_k"}
    return model.generate(prompt[None], **kw)[0, len(prompt):].tolist()
