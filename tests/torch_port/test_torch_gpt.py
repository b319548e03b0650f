"""GPT parity with the JAX package (tiny fp32 configs, CPU): the port's
``GPTForCausalLM`` on the JAX model's weights.

- ``layer_norm`` and ``gelu`` against the JAX functions: fp32 within 1e-6
  (plus 1e-6 of the value: outputs up to ~10 differ in their last place,
  from the order of the f32 sums and from XLA's rsqrt and tanh), bf16
  bit for bit (measured on this CPU: the port rounds where XLA rounds);
- no-cache logits at ``GPTConfig.tiny()`` and at a head_dim-64 config
  (atol 1e-5), and the state-dict round trip through
  ``load_paddle_tpu_state`` / ``export_paddle_tpu_state``;
- greedy ``generate`` at B = 1 and 2 and the repeated full forward of
  the JAX package's own GPT test: the JAX package's tokens;
- the paged engine with per-row learned positions: the JAX engine's
  tokens and the port's ``generate``;
- the engine's last prefill chunk past ``max_position_embeddings``
  (``max_len`` equal to the table): the JAX engine's tokens, no error,
  finite logits in every row (the JAX gather fills NaN in the pad rows);
- the decode dispatch counts ``gpt`` and ``gpt_paged`` hits, never a
  ``llama`` label; ``device=None`` means the GPU.

Sampling, ragged prompts, ``stream`` and ``generate_uncached`` are in
``test_torch_gpt_sampling.py``, the speculative lanes in
``test_torch_gpt_spec.py``, int8/fp8 serving in ``test_torch_gpt_quant.py``
and ``from_huggingface`` in ``test_torch_gpt_hf.py``: each file stays
under half a minute on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
from paddle_tpu import serving as jserving
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     export_paddle_tpu_state)
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as TF
from torch_parity import gpt_pair, jax_state

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def pair():
    return gpt_pair(max_position_embeddings=256)


def _jax_in(a, jdt):
    return paddle.Tensor(jnp.asarray(a).astype(jdt))


def _np(t):
    return np.asarray(t._data.astype(jnp.float32))


def _close(got, want, dname):
    if dname == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_layer_norm_matches_jax(dname, seed):
    jdt, tdt = DTYPES[dname]
    rng = np.random.RandomState(seed)
    x = (rng.randn(8, 33, 256) * 3 + 1).astype(np.float32)
    w, b = rng.randn(256).astype(np.float32), rng.randn(256).astype(np.float32)
    want = _np(JF.layer_norm(_jax_in(x, jdt), 256, _jax_in(w, jdt),
                             _jax_in(b, jdt)))
    tx, tw, tb = (torch.from_numpy(a).to(tdt) for a in (x, w, b))
    _close(TF.layer_norm(tx, 256, tw, tb).float().numpy(), want, dname)
    ln = LayerNorm(256, 1e-5, dtype=tdt)
    assert set(ln.state_dict()) == {"weight", "bias"}
    with torch.no_grad():
        ln.weight.copy_(tw)
        ln.bias.copy_(tb)
        _close(ln(tx).float().numpy(), want, dname)
    if dname == "bfloat16":
        # torch's own LayerNorm rounds once, at the end: another function
        ref = torch.nn.functional.layer_norm(tx, (256,), tw, tb)
        assert not np.array_equal(ref.float().numpy(), want)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("seed", [2, 3])
def test_gelu_matches_jax(dname, seed):
    jdt, tdt = DTYPES[dname]
    x = (np.random.RandomState(seed).randn(64, 257) * 3).astype(np.float32)
    want = _np(JF.gelu(_jax_in(x, jdt), approximate=True))
    got = TF.gelu(torch.from_numpy(x).to(tdt), approximate=True)
    assert got.dtype == tdt
    _close(got.float().numpy(), want, dname)
    with pytest.raises(NotImplementedError):
        TF.gelu(torch.from_numpy(x), approximate=False)


@pytest.mark.parametrize("overrides", [{}, dict(hidden_size=128,
                                                num_attention_heads=2)],
                         ids=["tiny", "head_dim64"])
def test_uncached_logits_and_state_round_trip(overrides):
    jm, tm, cfg = gpt_pair(**overrides)
    js, ts = jax_state(jm), tm.state_dict()
    assert set(js) == set(ts)
    assert {k for k in ts if k.endswith(".bias")} >= {
        "gpt.h.0.attn.q_proj.bias", "gpt.h.0.fc_in.bias", "gpt.ln_f.bias"}
    assert "lm_head.bias" not in ts
    back = export_paddle_tpu_state(tm)
    for name, arr in js.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
        assert back[name].shape == arr.shape, name
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 24))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)))._data)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,S", [(1, 7), (2, 11)])
def test_greedy_generate_matches_jax(pair, B, S):
    jm, tm, cfg = pair
    ids = np.random.RandomState(S).randint(1, cfg.vocab_size, (B, S))
    want = np.asarray(jgen.generate(jm, ids.astype(np.int32),
                                    max_new_tokens=10)._data)
    tda.reset_counters()
    got = tm.generate(ids, max_new_tokens=10).numpy()
    np.testing.assert_array_equal(got, want)
    # the decode steps (and a prefill of at most MAX_DECODE_Q_LEN tokens)
    # took the contiguous kernel's route under "gpt"
    forwards = 9 + (S <= tda.MAX_DECODE_Q_LEN)
    assert tda.DISPATCH_HITS["gpt"] == cfg.num_hidden_layers * forwards
    assert not any(k.startswith("llama") for k in tda.DISPATCH_HITS)


def test_generate_uncached_greedy_reference():
    """The JAX package's ``test_gpt_generate_greedy`` config: cached
    ``generate`` equals the repeated full forward, in both packages."""
    import paddle_tpu as paddle
    from paddle_tpu.models import GPTConfig as JConfig
    from paddle_tpu.models import GPTForCausalLM as JGPT

    from paddle_tpu_torch.models import load_paddle_tpu_state

    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=32)
    paddle.seed(1)
    jm = JGPT(JConfig(**kw))
    tm = load_paddle_tpu_state(GPTForCausalLM(GPTConfig(**kw), device="cpu"),
                               jax_state(jm))
    ids = np.random.RandomState(2).randint(0, 64, (2, 5))
    want = np.asarray(jm.generate(paddle.to_tensor(ids.astype("int32")),
                                  max_new_tokens=4)._data)
    got = tm.generate(ids, max_new_tokens=4).numpy()
    np.testing.assert_array_equal(got, want)
    cur = torch.from_numpy(ids)
    with torch.no_grad():
        for _ in range(4):
            nxt = tm(cur)[:, -1].argmax(-1)
            cur = torch.cat([cur, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(cur.numpy(), got)
    np.testing.assert_array_equal(
        tgen.generate_uncached(tm, ids, max_new_tokens=4).numpy(), got)


def test_engine_per_row_learned_positions_match_jax():
    """The JAX package's ``test_gpt_engine_parity``: two prompts (4 and 11
    tokens) decoding side by side at their own positions. Port engine ==
    JAX engine == port ``generate``."""
    jm, tm, cfg = gpt_pair()
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab_size, n).astype("int32")
               for n in (4, 11)]
    kw = dict(max_slots=2, max_len=48)
    outs = {}
    tda.reset_counters()
    for name, eng in (("jax", jserving.ServingEngine(jm, **kw)),
                      ("torch", tserving.ServingEngine(tm, device="cpu",
                                                       **kw))):
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.run_until_idle(max_steps=200)
        assert all(r.status == "completed" for r in reqs), name
        outs[name] = [list(r.output_tokens) for r in reqs]
    assert outs["torch"] == outs["jax"]
    # every chunk and decode step of the port's engine took the paged
    # kernel's route, under "gpt_paged"
    assert set(tda.DISPATCH_HITS) == {"gpt_paged"}
    assert not tda.DISPATCH_FALLBACKS
    for p, got in zip(prompts, outs["torch"]):
        assert tm.generate(p[None], max_new_tokens=5)[0, len(p):].tolist() \
            == got


def test_last_chunk_past_the_position_table():
    """``max_len == max_position_embeddings`` (64) and a 56-token prompt
    in chunks of 48: the second chunk's pad tokens sit at positions 64 to
    95, past the learned table. The port clamps the gather: no error,
    every logit finite; the JAX engine (NaN in those pad rows) and both
    packages' ``generate`` give the same tokens."""
    jm, tm, cfg = gpt_pair(max_position_embeddings=64)
    prompt = np.random.RandomState(3).randint(1, cfg.vocab_size, 56)
    kw = dict(max_slots=1, max_len=64, block_size=16, prefill_chunk=48,
              num_blocks=10)
    logits = []
    hook = tm.lm_head.register_forward_hook(
        lambda mod, inp, out: logits.append(out))
    outs = {}
    try:
        for name, eng in (("jax", jserving.ServingEngine(jm, **kw)),
                          ("torch", tserving.ServingEngine(tm, device="cpu",
                                                           **kw))):
            req = eng.submit(prompt.astype(np.int32), max_new_tokens=6)
            eng.run_until_idle(max_steps=200)
            assert req.status == "completed", name
            outs[name] = list(req.output_tokens)
    finally:
        hook.remove()
    assert len(logits) == 2 + 5 and logits[1].shape[1] == 48
    assert all(torch.isfinite(lg).all() for lg in logits)
    want = np.asarray(jgen.generate(jm, prompt[None].astype(np.int32),
                                    max_new_tokens=6)._data)[0, 56:].tolist()
    ref = tm.generate(prompt[None], max_new_tokens=6)[0, 56:].tolist()
    assert outs["torch"] == outs["jax"] == ref == want \
        == [255, 81, 217, 229, 3, 23]
    # the forward itself at positions 48..95: finite, and its live rows
    # (48..55) equal those of the same call inside the table
    caches = tgen.make_kv_caches(tm.config, 1, 96, torch.float32)
    run = tgen.make_cached_runner(tm)
    run(torch.from_numpy(prompt[None, :48]), caches, 0)
    ids = np.concatenate([prompt[48:], np.zeros(40, np.int64)])[None]
    lg, _ = run(torch.from_numpy(ids), caches, 48)
    assert torch.isfinite(lg).all()
    wide = tgen.make_kv_caches(tm.config, 1, 96, torch.float32)
    run(torch.from_numpy(prompt[None, :48]), wide, 0)
    live, _ = run(torch.from_numpy(prompt[None, 48:]), wide, 48)
    torch.testing.assert_close(lg[:, :8], live, atol=1e-5, rtol=0)


def test_default_device_is_cuda():
    """``device=None`` means the GPU: built there where one is present,
    an error where none is."""
    if torch.cuda.is_available():
        m = GPTForCausalLM(GPTConfig.tiny())
        assert next(m.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            GPTForCausalLM(GPTConfig.tiny())
    m = GPTForCausalLM(GPTConfig.tiny(dtype="bfloat16"), device="cpu")
    assert next(m.parameters()).dtype == torch.bfloat16
