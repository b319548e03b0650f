"""GPT int8/fp8 serving parity with the JAX package (tiny fp32 GPT with
``max_position_embeddings=256``, CPU). GPT's linears carry a bias, which
Llama's never did.

- ``convert_for_serving`` on GPT: every Linear (and the head) replaced,
  qweight and scale bit for bit the JAX package's, each bias kept
  unchanged; the converted JAX state loads into a converted port model;
- ``weight_only_linear`` adds the bias after the product in x's dtype
  (fp32 and bf16), as the JAX package does: the port's biased output is
  its unbiased one plus the bias bit for bit, and within 1e-5 (fp32) or
  0.0625 plus a bf16 step of the value (bf16) of both JAX lanes;
- int8 and fp8 weights over int8 and fp8 KV: ``generate`` and the paged
  engine give the JAX package's int8 / fp8 tokens (never held to the
  unquantized model's), through ``gpt_quant`` / ``gpt_paged_quant`` and
  K9's route, with no fallback;
- the JAX package's int8-KV GPT case (``test_int8_greedy_token_parity_gpt``:
  unquantized weights, int8 KV): the JAX package's tokens.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
from paddle_tpu import serving as jserving
from paddle_tpu.nn import quant as jquant
from paddle_tpu.quantization import convert_for_serving as j_convert

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.kernels import quant_matmul as tqm
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.nn import quant as tquant
from paddle_tpu_torch.quantization import convert_for_serving as t_convert
from torch_parity import gpt_pair, jax_state, prompt32

FORMATS = ["int8", "fp8"]
SEED = 4321     # tests/test_quantization_serving.py's SEED


def cfg_port(jcfg):
    return GPTConfig.tiny(max_position_embeddings=jcfg.max_position_embeddings)


def _bytes(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _tbytes(t):
    return t.view(torch.uint8).numpy() if t.element_size() == 1 \
        else t.numpy()


@pytest.fixture(scope="module", params=FORMATS)
def converted(request):
    """(fmt, jax model, port model, config, biases before conversion):
    the same tiny GPT converted by each package's ``convert_for_serving``."""
    fmt = request.param
    jm, tm, cfg = gpt_pair(max_position_embeddings=256)
    biases = {k: v.clone() for k, v in tm.state_dict().items()
              if k.endswith(".bias") and ".ln_" not in k}
    j_convert(jm, fmt=fmt)
    t_convert(tm, fmt=fmt)
    return fmt, jm, tm, cfg, biases


def test_convert_keeps_biases_and_matches_jax(converted):
    fmt, jm, tm, cfg, biases = converted
    js, ts = jax_state(jm), tm.state_dict()
    assert set(js) == set(ts)
    names = [k for k in ts if k.endswith(".qweight")]
    assert len(names) == 6 * cfg.num_hidden_layers + 1
    assert len(biases) == 6 * cfg.num_hidden_layers
    for name in names:
        base = name[:-len("qweight")]
        mod = tm.get_submodule(base[:-1])
        assert isinstance(mod, tquant.WeightOnlyLinear), base
        np.testing.assert_array_equal(_tbytes(ts[name]), _bytes(js[name]))
        np.testing.assert_array_equal(ts[base + "scale"].numpy(),
                                      js[base + "scale"])
        if base + "bias" in biases:
            torch.testing.assert_close(mod.bias, biases[base + "bias"],
                                       atol=0, rtol=0)
            np.testing.assert_array_equal(ts[base + "bias"].numpy(),
                                          js[base + "bias"])
        else:
            assert mod.bias is None and base == "lm_head."
    fresh = t_convert(GPTForCausalLM(cfg_port(cfg), device="cpu"), fmt=fmt)
    load_paddle_tpu_state(fresh, js)
    for name, t in fresh.state_dict().items():
        np.testing.assert_array_equal(_tbytes(t), _bytes(js[name]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_only_linear_bias_matches_jax(dtype, monkeypatch):
    """Both of the JAX package's lanes (its kernel, its XLA product) add
    the bias after the product, in x's dtype."""
    rng = np.random.RandomState(5)
    w = rng.randn(64, 48).astype(np.float32)
    x = rng.randn(2, 3, 64).astype(np.float32)
    bias = rng.randn(48).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, js = jquant.weight_quantize(paddle.to_tensor(w))
    tq, ts = tquant.weight_quantize(torch.from_numpy(w))
    tx = torch.from_numpy(x).to(tdt)
    tb = torch.from_numpy(bias).to(tdt)
    with torch.no_grad():
        got = tquant.weight_only_linear(tx, tq, tb, ts).float().numpy()
        plain = tquant.weight_only_linear(tx, tq, None, ts)
    np.testing.assert_array_equal(
        got, (plain + tb).float().numpy())
    for lane in ("1", "0"):
        monkeypatch.setenv("PADDLE_TPU_QUANT_WEIGHTS", lane)
        with paddle.no_grad():
            want = jquant.weight_only_linear(
                paddle.Tensor(jnp.asarray(x).astype(jdt)), jq,
                paddle.Tensor(jnp.asarray(bias).astype(jdt)), js)
        want = np.asarray(want._data.astype(jnp.float32))
        # bf16: the products round apart by a step of the value now and
        # then (outputs up to ~20; one step at 16 is 0.125)
        tol = dict(atol=1e-5, rtol=0) if dtype == "float32" \
            else dict(atol=0.0625, rtol=2 ** -7)
        np.testing.assert_allclose(got, want, **tol)


def test_generate_and_engine_match_jax(converted):
    fmt, jm, tm, cfg, _ = converted
    rng = np.random.RandomState(SEED + 5)
    ids = np.stack([prompt32(rng, cfg, 7), prompt32(rng, cfg, 7)])
    tda.reset_counters()
    tqm.reset_counters()
    want = np.asarray(jgen.generate(jm, ids, max_new_tokens=8,
                                    kv_format=fmt)._data)
    got = tm.generate(ids, max_new_tokens=8, kv_format=fmt).numpy()
    np.testing.assert_array_equal(got, want)
    assert tda.DISPATCH_HITS["gpt_quant"] == cfg.num_hidden_layers * 8
    prompts = [prompt32(rng, cfg, n) for n in (20, 45, 9)]
    kw = dict(max_slots=2, max_len=96, block_size=16, prefill_chunk=32,
              kv_format=fmt)
    outs = {}
    for name, eng in (("jax", jserving.ServingEngine(jm, **kw)),
                      ("torch", tserving.ServingEngine(tm, device="cpu",
                                                       **kw))):
        reqs = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, (8, 6, 9))]
        eng.run_until_idle(max_steps=500)
        assert all(r.status == "completed" for r in reqs), name
        outs[name] = [list(r.output_tokens) for r in reqs]
    assert outs["torch"] == outs["jax"]
    assert set(tda.DISPATCH_HITS) == {"gpt_quant", "gpt_paged_quant"}
    assert not tda.DISPATCH_FALLBACKS.keys() - {"quant_q_len"}
    assert set(tqm.DISPATCH_HITS) == {fmt} and not tqm.DISPATCH_FALLBACKS
    for p, n, toks in zip(prompts, (8, 6, 9), outs["torch"]):
        assert tm.generate(p[None], max_new_tokens=n,
                           kv_format=fmt)[0, len(p):].tolist() == toks


def test_int8_kv_generate_matches_jax():
    """``test_int8_greedy_token_parity_gpt``: unquantized weights over an
    int8 cache (``paddle.seed(1)``); the port's tokens are the JAX
    package's int8-cache tokens."""
    jm, tm, cfg = gpt_pair(max_position_embeddings=256)
    ids = prompt32(np.random.RandomState(SEED + 5), cfg, 7)[None]
    want = np.asarray(jgen.generate(jm, ids, max_new_tokens=8,
                                    kv_format="int8")._data)
    np.testing.assert_array_equal(
        tm.generate(ids, max_new_tokens=8, kv_format="int8").numpy(), want)
