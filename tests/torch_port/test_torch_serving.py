"""Serving parity with the JAX package (tiny config, fp32, CPU): the
block pool and prefix cache hand out the same block ids under one
scripted sequence, and the two engines serve the same greedy requests
(multi-chunk prompts, a shared prefix, a forced preemption) token for
token, equal to the port's own ``generate``."""

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.serving import block_pool as jbp

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving import block_pool as tbp
from torch_parity import tiny_pair


def _script(bp):
    """alloc / share / fork / free / evict, returning every block id and
    count the allocator and the cache report."""
    pool = bp.BlockPool(num_blocks=8, block_size=4)
    cache = bp.PrefixCache(pool)
    log = []
    a = pool.alloc(3)
    log.append(a)
    toks = np.arange(1, 11, dtype=np.int32)
    log.append(cache.insert(toks, 10, a))
    covered, shared = cache.match(toks, 9)
    log.append((covered, shared))
    fork = pool.alloc(1)
    pool.decref(shared[-1])
    log.append(fork)
    for b in a:
        pool.decref(b)
    log.append(cache.match(np.array([1, 2, 3, 4, 9], np.int32), 4))
    log.append(pool.alloc(2))
    log.append(cache.evict(5))
    with pytest.raises(bp.PoolExhaustedError):
        pool.alloc(7)
    log.append(pool.alloc(3))
    st = pool.stats()
    log.append({k: st[k] for k in ("in_use", "free", "shared",
                                   "alloc_total", "free_total",
                                   "high_watermark")})
    log.append(cache.stats())
    return log


def test_block_pool_and_prefix_cache_match_jax():
    assert _script(tbp) == _script(jbp)


def test_engines_and_generate_agree_token_for_token():
    jm, tm, cfg = tiny_pair(max_position_embeddings=256)
    rng = np.random.RandomState(21)
    shared = rng.randint(1, cfg.vocab_size, 40)
    prompts = [rng.randint(1, cfg.vocab_size, 20),                  # 1 chunk
               np.concatenate([shared, rng.randint(1, 256, 30)]),   # 3 chunks
               rng.randint(1, cfg.vocab_size, 100),                 # 4 chunks
               np.concatenate([shared, rng.randint(1, 256, 5)]),    # shares 40
               rng.randint(1, cfg.vocab_size, 50)]                  # 2 chunks
    new = [8, 12, 10, 12, 9]
    kw = dict(max_slots=3, max_len=256, block_size=16, prefill_chunk=32,
              num_blocks=14)
    outs = {}
    for name, eng in (("jax", jserving.ServingEngine(jm, **kw)),
                      ("torch", tserving.ServingEngine(tm, device="cpu",
                                                       **kw))):
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
        eng.run_until_idle(max_steps=2000)
        assert all(r.status == "completed" for r in reqs), name
        assert eng._preempt_count >= 1, name
        outs[name] = [list(r.output_tokens) for r in reqs]
        assert eng.pool.stats()["cow_forks"] >= 1, name
    assert outs["torch"] == outs["jax"]
    for p, n, got in zip(prompts, new, outs["torch"]):
        ref = tm.generate(p[None], max_new_tokens=n)[0, len(p):].tolist()
        assert got == ref
