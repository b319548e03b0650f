"""GPT speculative serving parity with the JAX package (tiny fp32 GPT
with ``max_position_embeddings=256`` and its 1-layer truncated draft,
CPU): the paged engine's chain and tree lanes over the JAX package's own
GPT cases, a greedy and a sampled request each: the JAX engine's tokens
and per-request drafted / accepted counts, plain ``generate``'s tokens;
every attention call took the paged kernels' route (K6 for chunks and
the chain, K8 for the tree's bundles) under the ``gpt_paged`` label."""

import numpy as np
import pytest

from paddle_tpu import serving as jserving

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.kernels import decode_attention as tda
from torch_parity import CHAIN_SEED, TREE_SEED, gpt_spec_pair, prompt32


@pytest.fixture(scope="module")
def pair():
    return gpt_spec_pair()


@pytest.mark.parametrize("lane", ["chain", "tree"])
def test_engine_lanes_match_jax(pair, lane):
    """``test_greedy_parity_gpt`` (chain, spec_k 4) and
    ``test_greedy_and_sampled_parity_gpt`` (tree [3, 2]): a greedy and a
    top-k sampled request through both packages' engines."""
    jm, jd, tm, td, cfg = pair
    if lane == "chain":
        rng, spec = np.random.RandomState(CHAIN_SEED + 7), dict(spec_k=4)
        news = (14, 10)
    else:
        rng, spec = np.random.RandomState(TREE_SEED + 5), \
            dict(spec_tree=[3, 2])
        news = (12, 9)
    cases = [(prompt32(rng, cfg, 6), dict(max_new_tokens=news[0])),
             (prompt32(rng, cfg, 11), dict(max_new_tokens=news[1],
                                          do_sample=True, top_k=5, seed=8))]
    kw = dict(max_slots=2, max_len=96, **spec)
    outs = {}
    tda.reset_counters()
    for name, eng in (("jax", jserving.ServingEngine(jm, draft_model=jd,
                                                     **kw)),
                      ("torch", tserving.ServingEngine(
                          tm, device="cpu", draft_model=td, **kw))):
        reqs = [eng.submit(p, **c) for p, c in cases]
        eng.run_until_idle(max_steps=500)
        assert all(r.status == "completed" for r in reqs), name
        outs[name] = ([list(r.output_tokens) for r in reqs],
                      [(r.spec_drafted, r.spec_accepted) for r in reqs])
    assert outs["torch"] == outs["jax"]
    assert sum(d for d, _ in outs["torch"][1]) > 0
    hits = dict(tda.DISPATCH_HITS)
    assert set(hits) == {"gpt_paged"} and not tda.DISPATCH_FALLBACKS, hits
    for (p, c), got in zip(cases, outs["torch"][0]):
        assert tgen.generate(tm, p[None], **c)[0, len(p):].tolist() == got
