"""Generation parity with the JAX package (tiny config, fp32, CPU): the
paged scatter lands the same values in the same pool slots, cached
logits agree at atol 1e-4, and greedy ``generate`` gives the same
tokens exactly."""

import numpy as np
import pytest
import torch

from paddle_tpu import generation as jgen

from paddle_tpu_torch import generation as tgen
from torch_parity import tiny_pair


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(max_position_embeddings=256)


def test_paged_write_matches_jax_and_routes_pads_to_dump():
    rng = np.random.RandomState(11)
    N, bs, h, d = 9, 4, 2, 3
    pool = rng.randn(N, bs, h, d).astype(np.float32)
    new = rng.randn(2, 6, h, d).astype(np.float32)
    bt = np.array([[3, 5, 1, 0], [8, 2, 6, 7]], np.int32)
    pos = np.array([2, 9], np.int32)
    valid = np.array([6, 4], np.int32)   # row 1: two pad tokens
    want = np.asarray(jgen.paged_kv_cache_write(pool, new, bt, pos,
                                                valid)._data)
    got = tgen.paged_kv_cache_write(torch.from_numpy(pool.copy()),
                                    torch.from_numpy(new),
                                    torch.from_numpy(bt),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got[1:], want[1:])
    np.testing.assert_array_equal(got[0, 1:], pool[0, 1:])
    pads = new[1, 4:].reshape(2, -1)
    assert any(np.array_equal(got[0, 0].reshape(-1), p) for p in pads)


def test_cached_logits_match(pair):
    jm, tm, cfg = pair
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 12))
    B, S, max_len = 2, 12, 20
    params = {k: v._data for k, v in jm.named_parameters_dict().items()}
    buffers = {k: v._data for k, v in jm.named_buffers_dict().items()}
    jrun = jgen.make_cached_runner(jm)
    jc = jgen.make_kv_caches(cfg, B, max_len, np.float32)
    jl, jc = jrun({**params, **buffers}, ids.astype(np.int32), jc, 0)
    trun = tgen.make_cached_runner(tm)
    tc = tgen.make_kv_caches(tm.config, B, max_len, torch.float32)
    tl, tc = trun(torch.from_numpy(ids), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    tok = np.asarray(jl)[:, -1].argmax(-1)
    jl2, _ = jrun({**params, **buffers}, tok[:, None].astype(np.int32), jc, S)
    tl2, _ = trun(torch.from_numpy(tok[:, None]), tc, S)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("S,eos", [(6, None), (11, None), (5, "first")])
def test_greedy_generate_matches_jax(pair, S, eos):
    jm, tm, cfg = pair
    ids = np.random.RandomState(S).randint(1, cfg.vocab_size, (2, S))
    N = 10
    plain = np.asarray(jgen.generate(jm, ids.astype(np.int32),
                                     max_new_tokens=N)._data)
    eos_id = int(plain[0, S + 2]) if eos else None
    want = np.asarray(jgen.generate(jm, ids.astype(np.int32),
                                    max_new_tokens=N,
                                    eos_token_id=eos_id)._data)
    got = tm.generate(ids, max_new_tokens=N, eos_token_id=eos_id).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampling_is_refused(pair):
    _, tm, _ = pair
    with pytest.raises(NotImplementedError, match="threefry"):
        tm.generate(np.ones((1, 3), np.int64), do_sample=True)


@pytest.mark.parametrize("S", [11, 128])
def test_greedy_generate_with_flash_attention_matches_jax(S):
    """With ``use_flash_attention`` the offset-0 prefill runs the flash
    kernel (padded to 128, as the JAX model pads it); tokens equal the
    JAX package's exactly."""
    jm, tm, cfg = tiny_pair(max_position_embeddings=256,
                            use_flash_attention=True)
    ids = np.random.RandomState(S + 1).randint(1, cfg.vocab_size, (2, S))
    want = np.asarray(jgen.generate(jm, ids.astype(np.int32),
                                    max_new_tokens=8)._data)
    got = tm.generate(ids, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
