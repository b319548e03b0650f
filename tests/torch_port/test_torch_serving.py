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


# A final prefill chunk whose padded end passes max_len (56 tokens in
# chunks of 48 against max_len 64): the chunk's rows must sit at their
# true positions. max_position_embeddings covers max_len + prefill_chunk,
# so the JAX engine's own rope is exact there and serves as the oracle.
_EDGE_KW = dict(max_slots=1, max_len=64, block_size=16, prefill_chunk=48,
                num_blocks=10)


def test_last_chunk_past_max_len_keeps_its_positions():
    jm, tm, cfg = tiny_pair(max_position_embeddings=256)
    prompt = np.random.RandomState(3).randint(1, cfg.vocab_size, 56)
    outs = {}
    for name, eng in (("jax", jserving.ServingEngine(jm, **_EDGE_KW)),
                      ("torch", tserving.ServingEngine(tm, device="cpu",
                                                       **_EDGE_KW))):
        req = eng.submit(prompt, max_new_tokens=6)
        eng.run_until_idle(max_steps=200)
        assert req.status == "completed", name
        outs[name] = list(req.output_tokens)
    ref = tm.generate(prompt[None], max_new_tokens=6)[0, 56:].tolist()
    assert outs["torch"] == outs["jax"] == ref == [230, 174, 44, 152, 8, 214]


def test_prefix_hit_moves_the_last_chunk_off_the_grid():
    """The second prompt (42 tokens) fits one on-grid chunk, but it
    shares two full blocks with the first: the prefix-cache hit starts
    its only chunk at 32, whose padded end (80) passes max_len. Port
    engine, JAX engine and generate agree."""
    jm, tm, cfg = tiny_pair(max_position_embeddings=256)
    rng = np.random.RandomState(4)
    first = rng.randint(1, cfg.vocab_size, 40)
    second = np.concatenate([first[:32], rng.randint(1, cfg.vocab_size, 10)])
    kw = dict(_EDGE_KW, num_blocks=12)
    outs = {}
    for name, eng in (("jax", jserving.ServingEngine(jm, **kw)),
                      ("torch", tserving.ServingEngine(tm, device="cpu",
                                                       **kw))):
        reqs = []
        for p in (first, second):
            reqs.append(eng.submit(p, max_new_tokens=4))
            eng.run_until_idle(max_steps=200)
        assert all(r.status == "completed" for r in reqs), name
        hits = eng.stats()["prefix_cache"]
        outs[name] = ([list(r.output_tokens) for r in reqs], hits)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1]["hits"] == 2
    for p, got in zip((first, second), outs["torch"][0]):
        assert got == tm.generate(p[None], max_new_tokens=4)[0, len(p):] \
            .tolist()


def test_prompt_ending_in_the_last_block_completes_at_the_default_pool():
    """C3: a 56-token prompt ends inside the slot's last block (max_len
    64, blocks of 16). The prefix cache registers that partial block, so
    the first decode write forks it: the default pool must hold the
    fork's block, or the request is preempted and re-admitted onto the
    same cached blocks forever. The JAX engine's default has no room for
    the fork, so it is given the port's pool size explicitly."""
    jm, tm, cfg = tiny_pair(max_position_embeddings=128)
    prompt = np.random.RandomState(5).randint(1, cfg.vocab_size, 56)
    kw = dict(max_slots=1, max_len=64, block_size=16, prefill_chunk=16,
              prefix_caching=True)
    eng = tserving.ServingEngine(tm, device="cpu", **kw)
    assert eng._nblocks == tserving.ServingConfig(**kw).default_num_blocks() \
        == 6
    req = eng.submit(prompt, max_new_tokens=6)
    eng.run_until_idle(max_steps=50)
    assert req.status == "completed"
    assert eng._preempt_count == 0
    assert eng.pool.stats()["cow_forks"] == 1
    jeng = jserving.ServingEngine(jm, num_blocks=6, **kw)
    jreq = jeng.submit(prompt, max_new_tokens=6)
    jeng.run_until_idle(max_steps=50)
    assert jreq.status == "completed"
    ref = tm.generate(prompt[None], max_new_tokens=6)[0, 56:].tolist()
    assert list(req.output_tokens) == list(jreq.output_tokens) == ref


@pytest.mark.parametrize("num_blocks", [5, 6])
def test_explicit_pool_without_room_for_the_fork_refuses(num_blocks):
    """C5: an explicit pool of 5 blocks (4 usable) spans the 56-token
    prompt and its 6 new tokens, but not the fork of the prompt's cached
    partial tail. ``submit`` refuses it (before, the request preempted
    itself onto the same cached blocks every step). One more block and
    it completes with the JAX engine's tokens (the JAX engine livelocks
    at 5)."""
    jm, tm, cfg = tiny_pair(max_position_embeddings=128)
    prompt = np.random.RandomState(5).randint(1, cfg.vocab_size, 56)
    kw = dict(max_slots=1, max_len=64, block_size=16, prefill_chunk=16,
              num_blocks=num_blocks)
    eng = tserving.ServingEngine(tm, device="cpu", **kw)
    if num_blocks == 5:
        with pytest.raises(ValueError, match="fork"):
            eng.submit(prompt, max_new_tokens=6)
        assert eng.run_until_idle(max_steps=50) == 0
        return
    req = eng.submit(prompt, max_new_tokens=6)
    steps = eng.run_until_idle(max_steps=50)
    assert req.status == "completed" and steps < 50
    assert eng._preempt_count == 0
    jeng = jserving.ServingEngine(jm, **kw)
    jreq = jeng.submit(prompt, max_new_tokens=6)
    jeng.run_until_idle(max_steps=50)
    assert jreq.status == "completed"
    assert list(req.output_tokens) == list(jreq.output_tokens)


# mixed greedy and sampled requests (the JAX package's own serving
# parity case): one engine, each request equal to a B = 1 generate with
# its seed
MIXED = [dict(max_new_tokens=6),
         dict(max_new_tokens=8, do_sample=True, temperature=0.8, top_k=8,
              seed=5),
         dict(max_new_tokens=5, do_sample=True, top_p=0.9, seed=9),
         dict(max_new_tokens=7),
         dict(max_new_tokens=10, do_sample=True, temperature=1.2, top_k=12,
              top_p=0.95, seed=3)]


def test_mixed_greedy_and_sampled_requests_match_generate_and_jax():
    jm, tm, cfg = tiny_pair(max_position_embeddings=256)
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
    assert outs["torch"][1] != tm.generate(
        prompts[1][None], max_new_tokens=8)[0, 9:].tolist()   # it sampled


def test_sampled_request_preempted_mid_decode_resumes_bit_identical():
    """An oversubscribed pool preempts the later-admitted, sampled request
    while both decode; it resumes from its seed's chain walked back to
    the token its resumed prefill re-derives: its tokens equal an
    undisturbed B = 1 generate and the JAX engine's at the same pool
    (where the JAX engine completes), and nothing is delivered twice."""
    jm, tm, cfg = tiny_pair(max_position_embeddings=256)
    rng = np.random.RandomState(13)
    pa, pb = (rng.randint(1, cfg.vocab_size, n) for n in (10, 12))
    sb = dict(max_new_tokens=30, do_sample=True, top_k=5, seed=7)
    kw = dict(max_slots=2, max_len=64, block_size=8, num_blocks=10,
              prefill_chunk=16)
    outs = {}
    for name, eng in (("jax", jserving.ServingEngine(jm, **kw)),
                      ("torch", tserving.ServingEngine(tm, device="cpu",
                                                       **kw))):
        ra = eng.submit(pa, max_new_tokens=30)
        rb = eng.submit(pb, **sb)
        eng.run_until_idle(max_steps=2000)
        assert ra.status == rb.status == "completed", name
        assert rb.preempt_count > 0, name
        assert len(ra.output_tokens) == len(rb.output_tokens) == 30, name
        outs[name] = (list(ra.output_tokens), list(rb.output_tokens))
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == tm.generate(pa[None],
                                           max_new_tokens=30)[0, 10:].tolist()
    assert outs["torch"][1] == tm.generate(pb[None], **sb)[0, 12:].tolist()
