"""Speculative decoding, the chain lane (tiny fp32 Llama, CPU): the port
against the JAX package on the same numpy-seeded weights.

- ``spec_accept_length`` equals the JAX package's;
- offline ``generate(draft_model=, spec_k=)`` gives the JAX package's
  tokens and plain ``generate``'s;
- the paged engine's chain lane serves the same requests as the JAX
  engine (a per-request ``spec_k=0`` opt-out and a shrunk ``spec_k=1``
  among them): equal tokens, equal ``spec_stats()`` totals and
  accept-length histogram;
- preemption and COW under speculation, the tree lane over int8 KV
  pools against the JAX engine's, an EOS inside an accepted run, a
  coupled draft that accepts every proposal, and the config errors.

The random 1-layer draft is the adversarial case (accepts are rare, the
rollback paths dominate); a draft can only change how far a round
advances, never the tokens.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
from paddle_tpu import serving as jserving
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from torch_parity import jax_state, tiny_pair

SEED = 20250805


@pytest.fixture(scope="module")
def pair():
    """(jax target, jax draft, port target, port draft, config): the
    tiny 2-layer target and an independent random 1-layer draft."""
    jm, tm, cfg = tiny_pair(max_position_embeddings=256)
    paddle.seed(99)
    jd = JLlama(JConfig.tiny(num_hidden_layers=1,
                             max_position_embeddings=256))
    td = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1,
                                           max_position_embeddings=256),
                          device="cpu")
    load_paddle_tpu_state(td, jax_state(jd))
    return jm, jd, tm, td, cfg


@pytest.fixture(scope="module")
def coupled():
    """A 4-layer port target whose layers 2-3 are exact identities (their
    o_proj and down_proj zeroed) and its 2-layer truncated draft: one
    function, so greedy accepts every proposal."""
    torch.manual_seed(3)
    cfg = LlamaConfig.tiny(num_hidden_layers=4, max_position_embeddings=256)
    target = LlamaForCausalLM(cfg, device="cpu")
    with torch.no_grad():
        for i in (2, 3):
            target.llama.layers[i].self_attn.o_proj.weight.zero_()
            target.llama.layers[i].mlp.down_proj.weight.zero_()
    return target, tgen.truncated_draft(target, 2), cfg


def _prompts(cfg, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in lens]


def _plain(model, p, n, **kw):
    return model.generate(p[None], max_new_tokens=n, **kw)[0, len(p):] \
        .tolist()


def test_spec_accept_length_matches_jax():
    rng = np.random.RandomState(SEED)
    B, k = 64, 4
    cand = rng.randint(0, 3, (B, k + 1)).astype(np.int32)
    drafts = np.where(rng.rand(B, k) < 0.7, cand[:, :k],
                      rng.randint(0, 3, (B, k))).astype(np.int32)
    spec_len = rng.randint(0, k + 2, B).astype(np.int32)
    want = np.asarray(jgen.spec_accept_length(drafts, cand, spec_len))
    got = tgen.spec_accept_length(torch.from_numpy(drafts),
                                  torch.from_numpy(cand),
                                  torch.from_numpy(spec_len))
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_chain_matches_jax_and_plain(pair):
    jm, jd, tm, td, cfg = pair
    ids = np.stack(_prompts(cfg, (9, 9, 9), SEED + 1))
    want = np.asarray(jgen.generate(jm, ids, max_new_tokens=12,
                                    draft_model=jd, spec_k=3)._data)
    got = tgen.generate(tm, ids, max_new_tokens=12, draft_model=td, spec_k=3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  tgen.generate(tm, ids,
                                                max_new_tokens=12).numpy())
    # spec_k=0 decodes plainly
    np.testing.assert_array_equal(
        tgen.generate(tm, ids, max_new_tokens=5, draft_model=td,
                      spec_k=0).numpy(), want[:, :9 + 5])


def test_engine_chain_matches_jax(pair):
    """Both engines on the same mixed requests: tokens, per-request
    drafted/accepted counts and the spec_stats totals and histogram."""
    jm, jd, tm, td, cfg = pair
    prompts = _prompts(cfg, (9, 40, 23, 70, 5), SEED + 2)
    new = [12, 9, 15, 7, 10]
    ks = [None, 0, 1, None, 2]
    kw = dict(max_slots=3, max_len=256, prefill_chunk=32, spec_k=3)
    # the port's default pool (room for a COW fork per slot, C3)
    nb = tserving.ServingConfig(**kw).default_num_blocks()
    runs = {}
    for name, eng in (
            ("jax", jserving.ServingEngine(jm, draft_model=jd,
                                           num_blocks=nb, **kw)),
            ("torch", tserving.ServingEngine(tm, device="cpu",
                                             draft_model=td, **kw))):
        reqs = [eng.submit(p, max_new_tokens=n, spec_k=k)
                for p, n, k in zip(prompts, new, ks)]
        eng.run_until_idle()
        assert all(r.status == "completed" for r in reqs), name
        st = eng.stats()["spec"]
        runs[name] = ([list(r.output_tokens) for r in reqs],
                      [(r.spec_drafted, r.spec_accepted) for r in reqs],
                      {k: st[k] for k in ("mode", "k", "rounds",
                                          "drafted_tokens",
                                          "accepted_tokens",
                                          "rejected_tokens")},
                      st["accept_len"]["hist"])
    assert runs["torch"] == runs["jax"]
    for p, n, got in zip(prompts, new, runs["torch"][0]):
        assert got == _plain(tm, p, n)
    # the opted-out request never drafted
    assert runs["torch"][1][1] == (0, 0)


def test_engine_chain_preemption_and_cow(pair):
    """An oversubscribed pool preempts mid-speculation and two prompts
    share a prefix (COW of both models' pools): every request completes
    with plain greedy decode's tokens, as in the JAX engine."""
    jm, jd, tm, td, cfg = pair
    shared = _prompts(cfg, (24,), SEED + 3)[0]
    tail = _prompts(cfg, (5, 9), SEED + 4)
    prompts = [np.concatenate([shared, tail[0]]),
               np.concatenate([shared, tail[1]]),
               _prompts(cfg, (12,), SEED + 5)[0]]
    kw = dict(max_slots=2, max_len=64, block_size=8, prefill_chunk=16,
              num_blocks=10, spec_k=4)
    outs = {}
    for name, eng in (
            ("jax", jserving.ServingEngine(jm, draft_model=jd, **kw)),
            ("torch", tserving.ServingEngine(tm, device="cpu",
                                             draft_model=td, **kw))):
        reqs = [eng.submit(p, max_new_tokens=28) for p in prompts]
        eng.run_until_idle()
        assert all(r.status == "completed" for r in reqs), name
        assert eng._preempt_count > 0, name
        assert eng.pool.stats()["cow_forks"] >= 1, name
        outs[name] = [list(r.output_tokens) for r in reqs]
    assert outs["torch"] == outs["jax"]
    for p, got in zip(prompts, outs["torch"]):
        assert got == _plain(tm, p, 28)


def test_engine_on_quantized_pools_matches_jax(pair):
    """The tree lane over int8 KV pools (both models' pools quantized,
    the path move carrying the scales): the JAX engine's tokens and
    spec totals, and the port's plain int8 ``generate``."""
    jm, jd, tm, td, cfg = pair
    prompts = _prompts(cfg, (9, 40, 23), SEED + 9)
    new = [12, 9, 15]
    kw = dict(max_slots=2, max_len=128, prefill_chunk=32, kv_format="int8",
              spec_tree=[2, 2])
    nb = tserving.ServingConfig(**kw).default_num_blocks()
    runs = {}
    for name, eng in (
            ("jax", jserving.ServingEngine(jm, draft_model=jd,
                                           num_blocks=nb, **kw)),
            ("torch", tserving.ServingEngine(tm, device="cpu",
                                             draft_model=td, **kw))):
        reqs = [eng.submit(p, max_new_tokens=n, spec_k=k)
                for p, n, k in zip(prompts, new, (None, 1, None))]
        eng.run_until_idle()
        st = eng.stats()["spec"]
        runs[name] = ([list(r.output_tokens) for r in reqs],
                      st["drafted_tokens"], st["accepted_tokens"],
                      st["accept_len"]["hist"])
    assert runs["torch"] == runs["jax"]
    for p, n, got in zip(prompts, new, runs["torch"][0]):
        assert got == _plain(tm, p, n, kv_format="int8")


def test_coupled_draft_accepts_every_proposal(coupled):
    target, draft, cfg = coupled
    p = _prompts(cfg, (7,), SEED + 6)[0]
    eng = tserving.ServingEngine(target, device="cpu", draft_model=draft,
                                 max_slots=2, max_len=128, spec_k=4)
    r = eng.submit(p, max_new_tokens=16)
    eng.run_until_idle()
    assert r.output_tokens == _plain(target, p, 16)
    st = eng.stats()["spec"]
    assert st["accept_rate"] == 1.0
    assert st["rejected_tokens"] == 0
    assert st["rounds"] < 16


def test_eos_inside_accepted_run_truncates(coupled):
    target, draft, cfg = coupled
    p = _prompts(cfg, (6,), SEED + 7)[0]
    base = _plain(target, p, 16)
    eos = base[5]
    ref = _plain(target, p, 16, eos_token_id=eos)
    stop = ref.index(eos) + 1
    eng = tserving.ServingEngine(target, device="cpu", draft_model=draft,
                                 max_slots=2, max_len=128, spec_k=4)
    r = eng.submit(p, max_new_tokens=16, eos_token_id=eos)
    eng.run_until_idle()
    assert r.output_tokens == ref[:stop]
    assert r.status == "completed"


def test_config_errors(pair):
    _, _, tm, td, cfg = pair
    with pytest.raises(ValueError, match="spec_k"):
        tserving.ServingConfig(spec_k=tda.MAX_SPEC_K + 1)
    with pytest.raises(ValueError, match="dead weight"):
        tserving.ServingEngine(tm, device="cpu", draft_model=td, spec_k=0)
    other = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=128,
                                              num_hidden_layers=1),
                             device="cpu")
    with pytest.raises(ValueError, match="vocab mismatch"):
        tserving.ServingEngine(tm, device="cpu", draft_model=other)
    with pytest.raises(ValueError, match="vocab mismatch"):
        tgen.generate(tm, np.ones((1, 4), np.int64), max_new_tokens=4,
                      draft_model=other)
    with pytest.raises(ValueError, match="kv_format"):
        tgen.generate(tm, np.ones((1, 4), np.int64), max_new_tokens=4,
                      draft_model=td, kv_format="int8")
    short = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1,
                                              max_position_embeddings=64),
                             device="cpu")
    with pytest.raises(ValueError, match="DRAFT"):
        tserving.ServingEngine(tm, device="cpu", draft_model=short,
                               max_len=128)
    with pytest.raises(ValueError, match="num_layers"):
        tgen.truncated_draft(tm, 3)


def test_truncated_draft_copies_the_first_layers(pair):
    _, _, tm, _, cfg = pair
    d = tgen.truncated_draft(tm, 1)
    assert d.config.num_hidden_layers == 1
    assert d.config.vocab_size == cfg.vocab_size
    full = tm.state_dict()
    for k, v in d.state_dict().items():
        assert torch.equal(v, full[k]), k


def test_scheduler_counts_spec_opt_outs(pair):
    _, _, tm, td, cfg = pair
    eng = tserving.ServingEngine(tm, device="cpu", draft_model=td,
                                 max_slots=1, max_len=128)
    for k in (0, None, 0):
        eng.submit(_prompts(cfg, (4,), SEED + 8)[0], max_new_tokens=2,
                   spec_k=k)
    assert eng.stats()["spec"]["queue_spec_opted_out"] == 2
    eng.run_until_idle()
    assert eng.stats()["spec"]["queue_spec_opted_out"] == 0
    plain = tserving.ServingEngine(tm, device="cpu", max_slots=1)
    assert plain.stats()["spec"] == {"enabled": False}


@pytest.mark.parametrize("num_blocks", [9, 10])
def test_engine_chain_pool_without_room_for_the_fork(pair, num_blocks):
    """C5 on the chain lane over int8 pools: 1 slot, blocks of 8, a
    60-token prompt whose cached partial tail the first bundle forks.
    Nine blocks (8 usable) span the request but not the fork: ``submit``
    refuses it (before, 2999 preemptions in 3000 steps). With ten it
    completes in bounded steps with the JAX engine's tokens and plain
    int8 greedy decode's."""
    jm, jd, tm, td, cfg = pair
    prompt = _prompts(cfg, (60,), SEED + 11)[0]
    kw = dict(max_slots=1, max_len=64, block_size=8, prefill_chunk=16,
              kv_format="int8", spec_k=4, num_blocks=num_blocks)
    eng = tserving.ServingEngine(tm, device="cpu", draft_model=td, **kw)
    if num_blocks == 9:
        with pytest.raises(ValueError, match="fork"):
            eng.submit(prompt, max_new_tokens=4)
        return
    req = eng.submit(prompt, max_new_tokens=4)
    steps = eng.run_until_idle(max_steps=40)
    assert req.status == "completed" and steps < 40
    assert eng._preempt_count == 0
    jeng = jserving.ServingEngine(jm, draft_model=jd, **kw)
    jreq = jeng.submit(prompt, max_new_tokens=4)
    jeng.run_until_idle(max_steps=40)
    assert jreq.status == "completed"
    assert list(req.output_tokens) == list(jreq.output_tokens) \
        == _plain(tm, prompt, 4, kv_format="int8")
