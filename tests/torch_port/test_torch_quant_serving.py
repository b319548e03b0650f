"""Quantized serving parity with the JAX package (tiny config, fp32,
CPU).

- The quantizing KV writes (paged scatter and contiguous) store the JAX
  package's values and scales BIT FOR BIT (the dump block, where pad
  tokens race, is left out);
- ``kv_cache_bytes_per_token`` and the engine's ``kv_block_stats``
  accounting equal the JAX package's;
- the slice: the tiny Llama converted by ``convert_for_serving`` (int8
  and fp8) and served with ``kv_format`` of the same format gives the
  same greedy tokens through both packages' engines (multi-chunk
  prompts, a shared prefix with a COW fork, a forced preemption), equal
  to the port's own ``generate(kv_format=...)``. The JAX engine runs its
  XLA lanes here (the Pallas gates are off on the CPU); the port runs
  the plain versions of K7 and K9, which the kernel-level files hold
  against the JAX kernels in interpret mode;
- a COW fork copies the scale pools with the values; formats outside
  ``KV_FORMATS`` are refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import generation as jgen
from paddle_tpu import serving as jserving
from paddle_tpu.quantization import convert_for_serving as j_convert

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.kernels import quant_matmul as tqm
from paddle_tpu_torch.quantization import convert_for_serving as t_convert
from paddle_tpu_torch.serving import metrics as tsm
from torch_parity import tiny_pair

FORMATS = ["int8", "fp8"]
_TDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _np(t):
    """Bytes of a narrow torch tensor, the array of any other."""
    return t.view(torch.uint8).numpy() if t.element_size() == 1 \
        else t.numpy()


def _jnp(a):
    a = np.asarray(a._data if hasattr(a, "_data") else a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _zeros(shape, fmt):
    return torch.zeros(shape, dtype=torch.uint8).view(_TDT[fmt])


@pytest.mark.parametrize("fmt", FORMATS)
def test_paged_write_quant_matches_jax(fmt):
    rng = np.random.RandomState(31)
    N, bs, h, d = 9, 4, 2, 8
    new = rng.randn(2, 6, h, d).astype(np.float32)
    new[0, 2] = 0.0                             # an all-zero token
    bt = np.array([[3, 5, 1, 0], [8, 2, 6, 7]], np.int32)
    pos = np.array([2, 9], np.int32)
    valid = np.array([6, 4], np.int32)          # row 1: two pad tokens
    jpool = jnp.zeros((N, bs, h, d), _JDT[fmt])
    jsc = jnp.zeros((N, bs, h), jnp.float32)
    wp, ws = jgen.paged_kv_cache_write_quant(jpool, jsc, new, bt, pos, valid,
                                             fmt)
    tp, ts = tgen.paged_kv_cache_write_quant(
        _zeros((N, bs, h, d), fmt), torch.zeros(N, bs, h),
        torch.from_numpy(new), torch.from_numpy(bt), torch.from_numpy(pos),
        torch.from_numpy(valid), fmt)
    assert tgen.kv_format_of(tp) == fmt
    np.testing.assert_array_equal(_np(tp)[1:], _jnp(wp)[1:])
    np.testing.assert_array_equal(ts.numpy()[1:], _jnp(ws)[1:])
    # the plain read path: the dequantized slot-major view
    jv = jgen.gather_paged_kv_dequant(wp, ws, bt[:, :3])
    tv = tgen.gather_paged_kv_dequant(tp, ts, torch.from_numpy(bt[:, :3]))
    np.testing.assert_array_equal(tv.numpy(), _jnp(jv))


@pytest.mark.parametrize("fmt", FORMATS)
def test_contiguous_write_quant_matches_jax(fmt):
    rng = np.random.RandomState(32)
    B, L, h, d = 2, 16, 2, 8
    new = rng.randn(B, 5, h, d).astype(np.float32)
    jbuf = jnp.zeros((B, L, h, d), _JDT[fmt])
    wb, ws = jgen.kv_cache_write_quant(jbuf, jnp.zeros((B, L, h)), new, 7,
                                       fmt)
    tb, ts = tgen.kv_cache_write_quant(_zeros((B, L, h, d), fmt),
                                       torch.zeros(B, L, h),
                                       torch.from_numpy(new), 7, fmt)
    np.testing.assert_array_equal(_np(tb), _jnp(wb))
    np.testing.assert_array_equal(ts.numpy(), _jnp(ws))
    np.testing.assert_array_equal(
        tgen.dequantize_kv_buffer(tb, ts).numpy(),
        _jnp(jgen.dequantize_kv_buffer(wb, ws)))


def test_bytes_per_token_and_formats_match_jax():
    from paddle_tpu.models import LlamaConfig as JConfig

    from paddle_tpu_torch.models import LlamaConfig

    for kw in ({}, {"num_key_value_heads": 4}):
        jc, tc = JConfig.llama2_7b(**kw), LlamaConfig.llama2_7b(**kw)
        for fmt in ("bf16", "int8", "fp8"):
            for jdt, tdt in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, torch.bfloat16)):
                assert tgen.kv_cache_bytes_per_token(tc, fmt, tdt) == \
                    jgen.kv_cache_bytes_per_token(jc, fmt, jdt)
    # Llama-2-7B: 270,336 bytes a token in int8 against 524,288 in bf16
    tc = LlamaConfig.llama2_7b()
    assert tgen.kv_cache_bytes_per_token(tc, "int8") == 270336
    assert tgen.kv_cache_bytes_per_token(tc, "bf16", torch.bfloat16) == 524288
    with pytest.raises(ValueError, match="kv_format"):
        tserving.ServingConfig(kv_format="int4")
    with pytest.raises(ValueError, match="kv_format"):
        jserving.ServingConfig(kv_format="int4")
    with pytest.raises(ValueError, match="kv_format"):
        tgen.make_paged_kv_pools(tc, 2, 16, torch.float32, "int4")
    tiny = LlamaConfig.tiny()
    from paddle_tpu_torch.models import LlamaForCausalLM

    with pytest.raises(ValueError, match="kv_format"):
        tgen.generate(LlamaForCausalLM(tiny, device="cpu"), [[1, 2]],
                      max_new_tokens=2, kv_format="int4")


def test_cow_fork_copies_scales():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    eng = tserving.ServingEngine(tm, device="cpu", max_slots=2, max_len=64,
                                 block_size=8, kv_format="int8")
    rng = np.random.RandomState(33)
    for c in eng._pools:
        assert set(c) == {"k", "v", "ks", "vs"}
        assert c["k"].dtype == torch.int8 and c["ks"].dtype == torch.float32
        c["k"].copy_(torch.from_numpy(rng.randint(-127, 128, c["k"].shape)))
        c["ks"].copy_(torch.from_numpy(rng.rand(*c["ks"].shape)))
    eng._cow(3, 5)
    for c in eng._pools:
        for name in ("k", "v", "ks", "vs"):
            torch.testing.assert_close(c[name][5], c[name][3], atol=0,
                                       rtol=0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantized_engines_and_generate_agree_token_for_token(fmt):
    jm, tm, cfg = tiny_pair(max_position_embeddings=256)
    j_convert(jm, fmt=fmt)
    t_convert(tm, fmt=fmt)
    rng = np.random.RandomState(34)
    shared = rng.randint(1, cfg.vocab_size, 40)
    prompts = [rng.randint(1, cfg.vocab_size, 20),                  # 1 chunk
               np.concatenate([shared, rng.randint(1, 256, 30)]),   # 3 chunks
               rng.randint(1, cfg.vocab_size, 100),                 # 4 chunks
               np.concatenate([shared, rng.randint(1, 256, 5)]),    # shares 40
               rng.randint(1, cfg.vocab_size, 50)]                  # 2 chunks
    new = [8, 12, 10, 12, 9]
    kw = dict(max_slots=3, max_len=256, block_size=16, prefill_chunk=32,
              num_blocks=14, kv_format=fmt)
    tda.reset_counters()
    tqm.reset_counters()
    outs, engines = {}, {}
    for name, eng in (("jax", jserving.ServingEngine(jm, **kw)),
                      ("torch", tserving.ServingEngine(tm, device="cpu",
                                                       **kw))):
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
        eng.run_until_idle(max_steps=2000)
        assert all(r.status == "completed" for r in reqs), name
        assert eng._preempt_count >= 1, name
        assert eng.pool.stats()["cow_forks"] >= 1, name
        outs[name] = [list(r.output_tokens) for r in reqs]
        engines[name] = eng
    assert outs["torch"] == outs["jax"]
    # every attention call took the quantized paged kernel's path and
    # every linear the quantized matmul's
    assert set(tda.DISPATCH_HITS) == {"llama_paged_quant"}
    assert not tda.DISPATCH_FALLBACKS
    assert set(tqm.DISPATCH_HITS) == {fmt} and not tqm.DISPATCH_FALLBACKS
    # the quant accounting of the block stats
    js = engines["jax"].kv_block_stats()
    ts = engines["torch"].stats()
    assert ts["kv_format"] == fmt
    for key in ("kv_format", "bytes_per_token", "effective_capacity_tokens",
                "capacity_vs_bf16", "internal_fragmentation_tokens"):
        assert ts["kv_blocks"][key] == js[key], key
    assert tsm.kv_bytes_per_token.labels(fmt).value() == js["bytes_per_token"]
    for p, n, got in zip(prompts, new, outs["torch"]):
        ref = tm.generate(p[None], max_new_tokens=n,
                          kv_format=fmt)[0, len(p):].tolist()
        assert got == ref
    assert tda.DISPATCH_HITS["llama_quant"] > 0
