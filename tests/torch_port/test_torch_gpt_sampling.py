"""GPT sampling parity with the JAX package (tiny fp32 GPT, CPU):
sampled ``generate`` at B = 1 and 2, ragged left-padded prompts (greedy
and sampled), ``stream`` and ``generate_uncached``, and the paged engine
serving mixed greedy and sampled requests: the JAX package's tokens
exactly, and each engine request equal to a B = 1 ``generate`` with its
seed."""

import numpy as np
import pytest
import torch

from paddle_tpu import generation as jgen
from paddle_tpu import serving as jserving

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import serving as tserving
from torch_parity import gpt_pair

# the port's Llama serving parity cases, on GPT
MIXED = [dict(max_new_tokens=6),
         dict(max_new_tokens=8, do_sample=True, temperature=0.8, top_k=8,
              seed=5),
         dict(max_new_tokens=5, do_sample=True, top_p=0.9, seed=9),
         dict(max_new_tokens=7),
         dict(max_new_tokens=10, do_sample=True, temperature=1.2, top_k=12,
              top_p=0.95, seed=3)]


@pytest.fixture(scope="module")
def pair():
    return gpt_pair(max_position_embeddings=256)


@pytest.mark.parametrize("B,params", [(1, 1), (2, 4)])
def test_sampled_generate_matches_jax(pair, B, params):
    jm, tm, cfg = pair
    ids = np.random.RandomState(40 + B).randint(1, cfg.vocab_size, (B, 7))
    kw = MIXED[params]
    want = np.asarray(jgen.generate(jm, ids.astype(np.int32), **kw)._data)
    got = tm.generate(ids, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, tm.generate(
        ids, max_new_tokens=kw["max_new_tokens"]).numpy())   # it sampled


def test_ragged_stream_and_uncached_match_jax(pair):
    """Ragged rows left-padded with ``pad_token_id`` (learned positions
    count the pads, as in the JAX model), ``stream`` and
    ``generate_uncached``, greedy and sampled."""
    jm, tm, cfg = pair
    rng = np.random.RandomState(7)
    rows = [rng.randint(1, cfg.vocab_size, n).tolist() for n in (5, 9, 3)]
    sampled = dict(do_sample=True, temperature=0.8, top_k=8, seed=5)
    for kw in ({}, sampled):
        kw = dict(kw, max_new_tokens=6, pad_token_id=0)
        want = np.asarray(jgen.generate(jm, rows, **kw)._data)
        np.testing.assert_array_equal(tgen.generate(tm, rows, **kw).numpy(),
                                      want)
    ids = rng.randint(1, cfg.vocab_size, (2, 6))
    kw = dict(max_new_tokens=8, do_sample=True, top_p=0.9, seed=9)
    want = np.stack(list(jgen.generate(jm, ids.astype(np.int32), stream=True,
                                       **kw)), axis=1)
    got = torch.stack(list(tgen.generate(tm, ids, stream=True, **kw)), dim=1)
    np.testing.assert_array_equal(got.numpy(), want)
    for kw in (dict(max_new_tokens=3), dict(max_new_tokens=3, **sampled)):
        want = np.asarray(jgen.generate_uncached(
            jm, ids.astype(np.int32), **kw)._data)
        np.testing.assert_array_equal(
            tgen.generate_uncached(tm, ids, **kw).numpy(), want)


def test_mixed_greedy_and_sampled_requests_match_generate_and_jax(pair):
    jm, tm, cfg = pair
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, n) for n in (5, 9, 3, 17, 30)]
    kw = dict(max_slots=3, max_len=64, max_queue_depth=16)
    nb = tserving.ServingConfig(**kw).default_num_blocks()
    outs = {}
    for name, eng in (("jax", jserving.ServingEngine(jm, num_blocks=nb,
                                                     **kw)),
                      ("torch", tserving.ServingEngine(tm, device="cpu",
                                                       **kw))):
        reqs = [eng.submit(p, **s) for p, s in zip(prompts, MIXED)]
        eng.run_until_idle(max_steps=500)
        assert all(r.status == "completed" for r in reqs), name
        outs[name] = [list(r.output_tokens) for r in reqs]
    assert outs["torch"] == outs["jax"]
    for p, s, got in zip(prompts, MIXED, outs["torch"]):
        want = tm.generate(p[None], **s)[0, len(p):].tolist()
        assert got == want, s
