"""GPT speculative decoding parity with the JAX package, offline (tiny
fp32 GPT with ``max_position_embeddings=256`` and its 1-layer truncated
draft, CPU): the JAX package's own GPT cases of the chain and tree
lanes. The engine's lanes are in ``test_torch_gpt_spec_engine.py``.

- a tree bundle's learned positions: node i at offset + depth[i], the
  cached forward's logits within 1e-5 of the JAX model's;
- offline ``generate`` with ``spec_k`` and ``spec_tree``, greedy and
  sampled: the JAX package's tokens and plain ``generate``'s.
"""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import generation as jgen

from paddle_tpu_torch import generation as tgen
from torch_parity import CHAIN_SEED, TREE_SEED, gpt_spec_pair, prompt32


@pytest.fixture(scope="module")
def pair():
    return gpt_spec_pair()


def _both(jm, tm, ids, **kw):
    """(JAX tokens, port tokens) of ``generate``; ``kw`` holds the
    draft of each package under ``draft``."""
    jd, td = kw.pop("draft", (None, None))
    jkw = dict(kw, draft_model=jd) if jd is not None else kw
    tkw = dict(kw, draft_model=td) if td is not None else kw
    return (np.asarray(jgen.generate(jm, ids, **jkw)._data),
            tgen.generate(tm, ids, **tkw).numpy())


def test_tree_bundle_learned_positions_match_jax(pair):
    """A [2, 2] bundle (7 nodes at depths 0, 1, 1, 2, 2, 2, 2) over a
    6-token prefix: node i reads ``wpe[6 + depth[i]]`` and attends its
    ancestors; logits agree with the JAX model's."""
    jm, _, tm, _, cfg = pair
    plan = tgen.spec_tree_plan((2, 2))
    rng = np.random.RandomState(TREE_SEED)
    prefix = prompt32(rng, cfg, 6)[None]
    bundle = prompt32(rng, cfg, 7)[None]
    anc, depth = plan["anc"][None], plan["depth_vec"]
    pb = {k: v._data for k, v in jm.named_parameters_dict().items()}
    # one compiled program a call shape, not an eager op at a time
    jrun = jax.jit(jgen.make_cached_runner(jm), static_argnums=3)
    jc = jgen.make_kv_caches(cfg, 1, 16, np.float32)
    _, jc = jrun(pb, prefix, jc, 0)
    jl, _ = jrun(pb, bundle, [dict(c, tree_mask=anc, tree_depth=depth)
                              for c in jc], 6)
    trun = tgen.make_cached_runner(tm)
    tc = tgen.make_kv_caches(tm.config, 1, 16, torch.float32)
    _, tc = trun(torch.from_numpy(prefix), tc, 0)
    tree = dict(tree_mask=torch.from_numpy(anc),
                tree_depth=torch.from_numpy(depth))
    tl, _ = trun(torch.from_numpy(bundle), [dict(c, **tree) for c in tc], 6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    # the positions are the depths': a chain bundle would differ
    chain, _ = trun(torch.from_numpy(bundle), [
        dict(c, tree_mask=tree["tree_mask"],
             tree_depth=torch.arange(7)) for c in tc], 6)
    assert not torch.allclose(chain, tl, atol=1e-3)


def test_generate_chain_and_tree_greedy_match_jax(pair):
    """``test_spec_decode.py``'s and ``test_spec_tree.py``'s
    ``test_greedy_parity_gpt``: spec_k 3 over 13 tokens, tree [3, 2] over
    10."""
    jm, jd, tm, td, cfg = pair
    for seed, n, lane in ((CHAIN_SEED + 1, 13, dict(spec_k=3)),
                          (TREE_SEED + 1, 10, dict(spec_tree=[3, 2]))):
        ids = prompt32(np.random.RandomState(seed), cfg, 6)[None]
        want, got = _both(jm, tm, ids, max_new_tokens=n, draft=(jd, td),
                          **lane)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, tgen.generate(tm, ids, max_new_tokens=n).numpy())


def test_generate_tree_sampled_matches_jax(pair):
    """``test_spec_tree.py``'s sampled case for GPT: tree [4, 2], a top-k
    and a top-p-only sampler; the B = 1 tokens equal plain sampled
    ``generate``'s."""
    jm, jd, tm, td, cfg = pair
    ids = prompt32(np.random.RandomState(TREE_SEED + 2), cfg, 8)[None]
    for kw in (dict(do_sample=True, temperature=0.8, top_k=7, seed=11),
               dict(do_sample=True, top_p=0.9, seed=12)):
        want, got = _both(jm, tm, ids, max_new_tokens=12, draft=(jd, td),
                          spec_tree=[4, 2], **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, tgen.generate(tm, ids, max_new_tokens=12, **kw).numpy())
