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


# ---------------------------------------------------------------------------
# sampled decode, ragged prompts, stream and the uncached loop
# ---------------------------------------------------------------------------

SAMPLED = [dict(do_sample=True, temperature=0.8, top_k=8, seed=5),
           dict(do_sample=True, top_p=0.9, seed=9),
           dict(do_sample=True, temperature=1.2, top_k=12, top_p=0.95,
                seed=3)]


@pytest.mark.parametrize("B,params,eos", [(1, 0, False), (1, 1, True),
                                          (2, 2, False), (2, 0, True)])
def test_sampled_generate_matches_jax(pair, B, params, eos):
    """B rows share one subkey per position (counters flat over
    [B, V]); with an EOS taken from the sampled run the loop stops once
    every row has emitted it."""
    jm, tm, cfg = pair
    ids = np.random.RandomState(40 + B).randint(1, cfg.vocab_size, (B, 7))
    kw = dict(max_new_tokens=10, **SAMPLED[params])
    first = np.asarray(jgen.generate(jm, ids.astype(np.int32), **kw)._data)
    if eos:
        kw["eos_token_id"] = int(first[0, 7 + 3])
    want = np.asarray(jgen.generate(jm, ids.astype(np.int32), **kw)._data)
    got = tm.generate(ids, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert not eos or (got[:, 7:] == kw["eos_token_id"]).any(axis=1).all() \
        or B > 1


@pytest.mark.parametrize("sampled", [False, True])
def test_ragged_prompts_match_jax_and_decline_the_kernel(pair, sampled):
    """A ragged list and the same rows pre-padded into a rectangle, with
    ``pad_token_id``: left pads hidden by the mask through prefill and
    decode; the decode kernel declines for the mask and says so."""
    from paddle_tpu_torch.kernels import decode_attention as tda

    jm, tm, cfg = pair
    rng = np.random.RandomState(7)
    rows = [rng.randint(1, cfg.vocab_size, n).tolist() for n in (5, 9, 3)]
    kw = dict(max_new_tokens=6, pad_token_id=0,
              **(SAMPLED[1] if sampled else {}))
    want = np.asarray(jgen.generate(jm, rows, **kw)._data)
    tda.reset_counters()
    got = tgen.generate(tm, rows, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert tda.DISPATCH_FALLBACKS and not tda.DISPATCH_HITS
    rect = np.zeros((3, 9), np.int64)
    for b, r in enumerate(rows):
        rect[b, 9 - len(r):] = r
    np.testing.assert_array_equal(tgen.generate(tm, rect, **kw).numpy(),
                                  want)


def test_stream_yields_the_tokens_of_generate_and_jax(pair):
    jm, tm, cfg = pair
    ids = np.random.RandomState(8).randint(1, cfg.vocab_size, (2, 6))
    kw = dict(max_new_tokens=8, **SAMPLED[2])
    full = tgen.generate(tm, ids, **kw)
    kw["eos_token_id"] = int(full[0, 6 + 2])
    want = np.stack(list(jgen.generate(jm, ids.astype(np.int32), stream=True,
                                       **kw)), axis=1)
    got = torch.stack(list(tgen.generate(tm, ids, stream=True, **kw)), dim=1)
    np.testing.assert_array_equal(got.numpy(), want)
    whole = tgen.generate(tm, ids, loop_mode="python", **kw)[:, 6:]
    np.testing.assert_array_equal(whole[:, :got.shape[1]].numpy(), want)
    with pytest.raises(ValueError, match="loop_mode"):
        tgen.generate(tm, ids, loop_mode="unrolled")


def test_generate_uncached_matches_jax(pair):
    jm, tm, cfg = pair
    ids = np.random.RandomState(9).randint(1, cfg.vocab_size, (2, 5))
    for kw in (dict(max_new_tokens=3), dict(max_new_tokens=3, **SAMPLED[0])):
        want = np.asarray(jgen.generate_uncached(
            jm, ids.astype(np.int32), **kw)._data)
        np.testing.assert_array_equal(
            tgen.generate_uncached(tm, ids, **kw).numpy(), want)


@pytest.mark.parametrize("lane", [dict(spec_k=3), dict(spec_tree=(2, 2))])
def test_sampled_speculative_generate(pair, lane):
    """Draft and target select with the same chain subkeys: at B = 1 the
    tokens equal plain sampled ``generate``; at B = 2 each row walks its
    own ``fold_in`` chain, as in the JAX package."""
    jm, tm, cfg = pair
    jd, td = jgen.truncated_draft(jm, 1), tgen.truncated_draft(tm, 1)
    ids = np.random.RandomState(10).randint(1, cfg.vocab_size, (2, 8))
    kw = dict(max_new_tokens=9, **SAMPLED[2], **lane)
    one = tgen.generate(tm, ids[:1], draft_model=td, **kw)
    plain = tgen.generate(tm, ids[:1], max_new_tokens=9, **SAMPLED[2])
    np.testing.assert_array_equal(one.numpy(), plain.numpy())
    want = np.asarray(jgen.generate(jm, ids.astype(np.int32), draft_model=jd,
                                    **kw)._data)
    got = tgen.generate(tm, ids, draft_model=td, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
