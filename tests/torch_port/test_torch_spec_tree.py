"""Tree speculative decoding (tiny fp32 Llama, CPU): the port against the
JAX package on the same numpy-seeded weights and inputs.

- ``spec_tree_plan`` gives the JAX package's arrays;
- the plain K8 (``paged_flash_decode_attention_ref`` with an
  ``ancestor_mask``) equals the JAX kernel with the same mask in
  interpret mode (atol 1e-5) for [2, 2], [4, 2, 2] and [1, 1, 1, 1]
  trees over fp32 and int8 pools, and a causal mask gives the maskless
  output exactly;
- offline ``generate(draft_model=, spec_tree=)`` gives the JAX
  package's tokens and plain ``generate``'s;
- the engine's tree lane serves the JAX engine's tokens with equal
  ``spec_stats()`` totals and depth histogram (int8 pools:
  test_torch_spec_decode.py); preemption, COW and a per-request
  ``spec_k`` clamp under the tree lane; a coupled draft accepts the
  full depth every round; the tree config errors.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import generation as jgen
from paddle_tpu import serving as jserving
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.pallas_kernels import decode_attention as jda
from paddle_tpu.quantization import intx as jintx

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.kernels import decode_attention as tda
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from torch_parity import generate_case, jax_state, serve_cases, tiny_pair

SEED = 20250807
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _zero_counters():
    tda.reset_counters()
    yield


@pytest.fixture(scope="module")
def pair():
    jm, tm, cfg = tiny_pair(max_position_embeddings=256)
    paddle.seed(99)
    jd = JLlama(JConfig.tiny(num_hidden_layers=1,
                             max_position_embeddings=256))
    td = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1,
                                           max_position_embeddings=256),
                          device="cpu")
    load_paddle_tpu_state(td, jax_state(jd))
    return jm, jd, tm, td, cfg


def _prompts(cfg, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in lens]


def _plain(model, p, n, **kw):
    return model.generate(p[None], max_new_tokens=n, **kw)[0, len(p):] \
        .tolist()


@pytest.mark.parametrize("factors", [[2, 2], [4, 2, 2], [1, 1, 1, 1], [3],
                                     [2, 1, 3]])
def test_tree_plan_matches_jax(factors):
    want = jgen.spec_tree_plan(factors)
    got = tgen.spec_tree_plan(factors)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert tda.spec_tree_width(factors) == jda.spec_tree_width(factors)


def _pool(rng, shape, fmt):
    """(jax operand, port tensor, scales or None): an fp32 pool, or one
    quantized per token per head by the JAX package."""
    x = rng.randn(*shape).astype(np.float32)
    if fmt == "f32":
        return x, torch.from_numpy(x), None
    import jax.numpy as jnp

    amax = np.abs(x).max(axis=-1)
    q = np.asarray(jintx.pack_absmax(jnp.asarray(x),
                                     jnp.asarray(amax)[..., None], fmt))
    return q, torch.from_numpy(q.copy()), amax


# every tree meets both pool formats across the cases; each case is one
# interpret-mode compile of the JAX kernel (~1.5 s), so not the product
@pytest.mark.parametrize("factors,fmt,group", [
    ([2, 2], "f32", 1), ([4, 2, 2], "f32", 2), ([1, 1, 1, 1], "int8", 2),
    ([2, 2], "int8", 2), ([4, 2, 2], "int8", 1)])
def test_plain_k8_matches_jax(factors, fmt, group):
    """The tree bundle over a paged pool with shuffled blocks: row 0
    ends at the table's end, row 1 starts its bundle inside a block,
    row 2 is a dead slot (zeroed table, pos 0)."""
    plan = tgen.spec_tree_plan(factors)
    w = plan["nodes"]
    rng = np.random.RandomState(sum(factors) * 10 + group)
    B, KV, D, bs, nb, N = 3, 2, 16, 8, 6, 20
    q = rng.randn(B, w, KV * group, D).astype(np.float32)
    kj, kt, ks = _pool(rng, (N, bs, KV, D), fmt)
    vj, vt, vs = _pool(rng, (N, bs, KV, D), fmt)
    bt = (rng.permutation(N - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    bt[2] = 0
    pos = np.array([nb * bs - w, 13, 0], np.int32)
    mask = np.broadcast_to(plan["anc"], (B, w, w))
    scales = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    want = np.asarray(jda.paged_flash_decode_attention(
        q, kj, vj, bt, pos, ancestor_mask=mask, **scales))
    tscales = {k: torch.from_numpy(v) for k, v in scales.items()}
    args = (torch.from_numpy(q), kt, vt, torch.from_numpy(bt),
            torch.from_numpy(pos))
    got = tda.paged_flash_decode_attention(
        *args, ancestor_mask=torch.from_numpy(mask.copy()), **tscales)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    causal = torch.ones(w, w, dtype=torch.bool).tril()[None].expand(B, w, w)
    torch.testing.assert_close(
        tda.paged_flash_decode_attention(*args, ancestor_mask=causal,
                                         **tscales),
        tda.paged_flash_decode_attention(*args, **tscales), atol=0, rtol=0)
    assert all(n == 0 for n in tda.LAUNCHES.values())


def test_generate_tree_matches_jax_and_plain(pair):
    jm, jd, tm, td, cfg = pair
    ids = np.stack(_prompts(cfg, (9, 9), SEED + 1))
    want = np.asarray(jgen.generate(jm, ids, max_new_tokens=12,
                                    draft_model=jd, spec_tree=[2, 2])._data)
    got = tgen.generate(tm, ids, max_new_tokens=12, draft_model=td,
                        spec_tree=[2, 2])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tgen.generate(tm, ids, max_new_tokens=12).numpy())
    deep = tgen.generate(tm, ids, max_new_tokens=12,
                         draft_model=tgen.truncated_draft(tm, 1),
                         spec_tree=[4, 2, 2])
    np.testing.assert_array_equal(deep.numpy(), want)


def _serve(eng, prompts, new, ks=None):
    ks = ks or [None] * len(prompts)
    reqs = [eng.submit(p, max_new_tokens=n, spec_k=k)
            for p, n, k in zip(prompts, new, ks)]
    eng.run_until_idle()
    assert all(r.status == "completed" for r in reqs)
    st = eng.stats()["spec"]
    return ([list(r.output_tokens) for r in reqs],
            [(r.spec_drafted, r.spec_accepted) for r in reqs],
            {k: st[k] for k in ("mode", "k", "rounds", "drafted_tokens",
                                "accepted_tokens")},
            st["accept_len"]["hist"], st["tree"])


def test_engine_tree_matches_jax(pair):
    """The tree lane of both engines over the same requests (a depth
    clamp spec_k=1 and an opt-out spec_k=0 among them); the int8-pool
    tree lane is in test_torch_spec_decode.py."""
    jm, jd, tm, td, cfg = pair
    prompts = _prompts(cfg, (9, 40, 23, 5), SEED + 2)
    new = [12, 9, 15, 10]
    ks = [None, 1, 0, None]
    kw = dict(max_slots=3, max_len=256, prefill_chunk=32, spec_tree=[2, 2])
    # the port's default pool (room for a COW fork per slot, C3)
    nb = tserving.ServingConfig(**kw).default_num_blocks()
    want = _serve(jserving.ServingEngine(jm, draft_model=jd, num_blocks=nb,
                                         **kw), prompts, new, ks)
    got = _serve(tserving.ServingEngine(tm, device="cpu", draft_model=td,
                                        **kw), prompts, new, ks)
    assert got == want
    for p, n, toks in zip(prompts, new, got[0]):
        assert toks == _plain(tm, p, n)


def test_engine_tree_preemption_and_cow(pair):
    """[4, 2, 2] under an oversubscribed pool with a shared prefix: the
    requests preempt, fork shared blocks and still give plain greedy
    decode's tokens."""
    _, _, tm, td, cfg = pair
    shared = _prompts(cfg, (24,), SEED + 3)[0]
    tail = _prompts(cfg, (5, 9), SEED + 4)
    prompts = [np.concatenate([shared, tail[0]]),
               np.concatenate([shared, tail[1]]),
               _prompts(cfg, (12,), SEED + 5)[0]]
    eng = tserving.ServingEngine(tm, device="cpu", draft_model=td,
                                 max_slots=2, max_len=64, block_size=8,
                                 prefill_chunk=16, num_blocks=10,
                                 spec_tree=[4, 2, 2])
    got = _serve(eng, prompts, [28, 28, 28])[0]
    assert eng._preempt_count > 0
    assert eng.pool.stats()["cow_forks"] >= 1
    for p, toks in zip(prompts, got):
        assert toks == _plain(tm, p, 28)


def test_coupled_draft_accepts_full_depth():
    """A target whose layers 2-3 are exact identities and its 2-layer
    truncated draft: branch 0 is the target's own chain, so every round
    commits the full depth-2 path."""
    torch.manual_seed(3)
    cfg = LlamaConfig.tiny(num_hidden_layers=4, max_position_embeddings=256)
    target = LlamaForCausalLM(cfg, device="cpu")
    with torch.no_grad():
        for i in (2, 3):
            target.llama.layers[i].self_attn.o_proj.weight.zero_()
            target.llama.layers[i].mlp.down_proj.weight.zero_()
    from paddle_tpu_torch.serving import metrics as sm

    eng = tserving.ServingEngine(target, device="cpu",
                                 draft_model=tgen.truncated_draft(target, 2),
                                 max_slots=1, max_len=128, spec_tree=[2, 2])
    p = _prompts(cfg, (7,), SEED + 6)[0]
    before = dict(sm.COUNTERS)
    n_depth = sm.digest("spec_accept_depth")["count"]
    r = eng.submit(p, max_new_tokens=16)
    eng.run_until_idle()
    assert r.output_tokens == _plain(target, p, 16)
    st = eng.stats()["spec"]
    assert st["accept_len"]["p50"] == 2.0
    assert st["tree"]["mean_accepted_path_len"] == 3.0
    assert st["rounds"] < 16
    # the node counters and the depth digest move with the request's own
    # accounting, and its debug row reports it
    for key, want in (("spec_tree_nodes_drafted", r.spec_drafted),
                      ("spec_tree_nodes_accepted", r.spec_accepted)):
        assert sm.COUNTERS[key] - before.get(key, 0) == want > 0
    assert sm.digest("spec_accept_depth")["count"] - n_depth \
        == st["accept_len"]["count"]
    row = r.debug_row()
    assert (row["spec_drafted"], row["spec_accepted"]) == \
        (r.spec_drafted, r.spec_accepted)
    assert row["spec_accept_rate"] == round(r.spec_accepted
                                            / r.spec_drafted, 4)


def test_tree_config_errors(pair):
    _, _, tm, _, _ = pair
    with pytest.raises(ValueError, match="branching"):
        tserving.ServingConfig(spec_tree=[2, 0, 2])
    with pytest.raises(ValueError, match="spec_tree"):
        tserving.ServingConfig(spec_tree=[])
    with pytest.raises(ValueError, match="MAX_PAGED_Q_LEN"):
        tserving.ServingConfig(spec_tree=[2] * 9)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tserving.ServingConfig(spec_k=3, spec_tree=[2, 2])
    assert tserving.ServingConfig(spec_tree=[4, 2, 2]).spec_tree == (4, 2, 2)
    with pytest.raises(ValueError, match="draft_model"):
        tgen.generate(tm, np.ones((1, 4), np.int64), max_new_tokens=4,
                      spec_tree=[2, 2])
    with pytest.raises(ValueError, match="ancestor_mask"):
        tda.paged_flash_decode_attention(
            torch.zeros(1, 3, 2, 16), torch.zeros(4, 8, 2, 16),
            torch.zeros(4, 8, 2, 16), torch.ones(1, 2, dtype=torch.int32),
            0, ancestor_mask=torch.ones(1, 2, 2, dtype=torch.bool))


def test_verify_eligibility_reasons():
    assert tda.spec_verify_eligibility(4, torch.bfloat16) == (True, None)
    assert tda.spec_verify_eligibility(0, torch.float32,
                                       spec_tree=[4, 2, 2]) == (True, None)
    assert tda.spec_verify_eligibility(0, torch.float32,
                                       spec_tree=[2] * 9) == (False, "q_len")
    assert tda.spec_verify_eligibility(3, torch.float16) == (False, "dtype")
    assert dict(tda.DISPATCH_FALLBACKS) == {"spec_tree_q_len": 1,
                                            "spec_dtype": 1}


# greedy, top-k, top-p-only, an opt-out and a depth clamp (the JAX
# package's tree-lane parity cases)
SAMPLED_CASES = [
    (5, dict(max_new_tokens=12)),
    (37, dict(max_new_tokens=9, do_sample=True, temperature=0.8, top_k=8,
              seed=3)),
    (9, dict(max_new_tokens=15, do_sample=True, top_p=0.9, seed=4)),
    (7, dict(max_new_tokens=10, spec_k=0)),
    (6, dict(max_new_tokens=10, do_sample=True, temperature=1.2, top_k=12,
             top_p=0.95, seed=6, spec_k=1)),
]


def test_engine_tree_sampled_matches_plain_and_jax(pair):
    """Sampled children draw with their depth's chain subkey (branch 0)
    or its ``fold_in`` by BFS index; every node verifies with its depth's
    subkey. Each request equals the plain sampled engine, the JAX tree
    lane and a B = 1 ``generate`` with its seed."""
    jm, jd, tm, td, cfg = pair
    rng = np.random.RandomState(SEED + 4)
    prompts = [rng.randint(1, cfg.vocab_size, n) for n, _ in SAMPLED_CASES]
    kw = dict(max_slots=3, max_len=128, spec_tree=[2, 2])
    nb = tserving.ServingConfig(**kw).default_num_blocks()
    want, jreqs = serve_cases(
        jserving.ServingEngine(jm, draft_model=jd, num_blocks=nb, **kw),
        prompts, SAMPLED_CASES)
    got, reqs = serve_cases(
        tserving.ServingEngine(tm, device="cpu", draft_model=td, **kw),
        prompts, SAMPLED_CASES)
    plain, _ = serve_cases(
        tserving.ServingEngine(tm, device="cpu", max_slots=3, max_len=128),
        prompts, SAMPLED_CASES)
    assert got == want == plain
    # the drafts too: per-request drafted and accepted counts
    assert [(r.spec_drafted, r.spec_accepted) for r in reqs] == \
        [(r.spec_drafted, r.spec_accepted) for r in jreqs]
    for p, (_, c), g in zip(prompts, SAMPLED_CASES, got):
        assert g == generate_case(tm, p, c)
    assert reqs[3].spec_drafted == 0 and reqs[1].spec_drafted > 0


def test_engine_tree_sampled_preempted_mid_speculation(pair):
    jm, jd, tm, td, cfg = pair
    rng = np.random.RandomState(SEED + 8)
    pa, pb = rng.randint(1, cfg.vocab_size, 10), \
        rng.randint(1, cfg.vocab_size, 12)
    sb = dict(max_new_tokens=30, do_sample=True, top_k=5, seed=7)
    kw = dict(max_slots=2, max_len=64, block_size=8, num_blocks=10,
              spec_tree=[2, 2])
    outs = {}
    for name, eng in (
            ("jax", jserving.ServingEngine(jm, draft_model=jd, **kw)),
            ("torch", tserving.ServingEngine(tm, device="cpu",
                                             draft_model=td, **kw))):
        ra = eng.submit(pa, max_new_tokens=30)
        rb = eng.submit(pb, **sb)
        eng.run_until_idle(max_steps=2000)
        assert ra.status == rb.status == "completed", name
        assert rb.preempt_count > 0, name
        assert len(rb.output_tokens) == 30, name
        outs[name] = [list(ra.output_tokens), list(rb.output_tokens)]
    assert outs["torch"] == outs["jax"]
    assert outs["torch"] == [generate_case(tm, pa, dict(max_new_tokens=30)),
                             generate_case(tm, pb, sb)]


def test_sampled_children_draw_like_the_reference():
    """A level's sampled children: branch 0 of each node draws with the
    level's chain subkey, branch r > 0 with ``fold_in(subkey, BFS
    index)``, over the node's logits repeated per branch; greedy rows
    keep their greedy children. Built here from jax.random and the JAX
    package's ``select_tokens`` (the reference engine's ``_samp``)."""
    import jax
    import jax.numpy as jnp

    B, n, f, first, V = 3, 2, 2, 3, 256
    rng = np.random.RandomState(SEED + 9)
    lvl = (rng.randn(B, n, V) * 2).astype(np.float32)
    base = jax.vmap(lambda r: jax.random.fold_in(jax.random.PRNGKey(5), r))(
        jnp.arange(B, dtype=jnp.uint32))
    ds = np.array([True, False, True])
    temp = np.array([0.8, 1.0, 1.2], np.float32)
    tk = np.array([8, 0, 0], np.int32)
    tp = np.array([1.0, 1.0, 0.9], np.float32)
    w = n * f
    gidx = first + jnp.arange(w, dtype=jnp.uint32)
    folded = jax.vmap(lambda kk: jax.vmap(
        lambda g: jax.random.fold_in(kk, g))(gidx))(base)
    keys = jnp.where(((jnp.arange(w) % f) == 0)[None, :, None],
                     jnp.broadcast_to(base[:, None], (B, w, 2)), folded)

    def rep(x):
        return jnp.repeat(jnp.asarray(x), w)

    want = np.array(jgen.select_tokens(
        jnp.repeat(jnp.asarray(lvl), f, axis=1).reshape(B * w, V),
        keys.reshape(B * w, 2), rep(ds), rep(temp), rep(tk),
        rep(tp))).reshape(B, w)
    greedy = tgen.tree_children(torch.from_numpy(lvl), f)
    want[~ds] = greedy.numpy()[~ds]
    params = (torch.from_numpy(ds), torch.from_numpy(temp),
              torch.from_numpy(tk).long(), torch.from_numpy(tp))
    got = tgen.sampled_children(torch.from_numpy(lvl), f, first,
                                torch.from_numpy(np.array(base)
                                                 .astype(np.int64)),
                                params, greedy)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(got.numpy()[0, ::2], got.numpy()[0, 1::2])
