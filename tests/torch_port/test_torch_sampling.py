"""Sampling parity with the JAX package (CPU): the port's threefry key
chain (``paddle_tpu_torch.prng``) is jax.random's bit for bit, and the
port's selectors (``_select_token``, ``select_tokens``) draw the JAX
package's tokens exactly, in float32 and bfloat16.

Integer work (threefry, keys, random bits, uniforms) is held exactly.
``-log(-log(u))`` goes through two logs whose last bit differs between
XLA:CPU and torch, so Gumbel values are held to 2 ulp at the scale of
the logits they perturb (ulp of max(|g|, 1)); tokens are held exactly.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from paddle_tpu import generation as jgen

from paddle_tpu_torch import generation as tgen
from paddle_tpu_torch import prng

SEEDS = [0, 7, 2 ** 31 - 1, 2 ** 32 + 5, 123456789]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
V = 1000
# the grid of rows: temperature x top_k x top_p
GRID = list(itertools.product([0.7, 1.0, 1.3],
                              [0, 1, 40, 256, 257, 300, V],
                              [1.0, 0.9, 0.5]))


def _t(a):
    """A jax uint32 key (or any integer array) as the port's int64."""
    return torch.from_numpy(np.array(a).astype(np.int64))


def _as_torch(x_jax, tdt):
    return torch.from_numpy(np.array(x_jax.astype(jnp.float32))).to(tdt)


def _root_keys(n, seed=5):
    root = jax.random.PRNGKey(seed)
    return jax.vmap(lambda r: jax.random.fold_in(root, r))(
        jnp.arange(n, dtype=jnp.uint32))


# Random123's threefry2x32_20 known-answer vectors
KAT = [((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
       ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
        (0x1cb996fc, 0xbb002be7)),
       ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
        (0xc4923a9c, 0x483df7a0))]


@pytest.mark.parametrize("key,ctr,want", KAT)
def test_threefry_known_answers(key, ctr, want):
    t = [torch.tensor([v], dtype=torch.int64) for v in key + ctr]
    got = tuple(int(y) for y in prng.threefry2x32(*t))
    assert got == want
    ref = jprng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                              jnp.asarray(ctr, jnp.uint32))
    assert tuple(int(v) for v in np.asarray(ref)) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_key_chain_matches_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert torch.equal(_t(jk), tk)
    for i in range(12):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk).unbind(0)
        assert torch.equal(_t(jk), tk) and torch.equal(_t(jsub), tsub)
        assert torch.equal(_t(jax.random.fold_in(jk, 1000 + i)),
                           prng.fold_in(tk, 1000 + i))
    assert torch.equal(_t(jax.random.split(jk, 5)), prng.split(tk, 5))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_split_keys_and_levels_match_jax(seed):
    jkeys = _root_keys(4, seed)
    tkeys = _t(jkeys)
    jn, js = jgen.split_keys(jkeys)
    tn, ts = tgen.split_keys(tkeys)
    assert torch.equal(_t(jn), tn) and torch.equal(_t(js), ts)
    jl, jsub = jgen.split_key_levels(jkeys, 5)
    tl, tsub = tgen.split_key_levels(tkeys, 5)
    assert torch.equal(_t(jl), tl) and torch.equal(_t(jsub), tsub)
    # fold_in over a [B] vector of data, and batched keys
    data = jnp.arange(7, dtype=jnp.uint32) * 977
    want = jax.vmap(lambda d: jax.random.fold_in(jkeys[1], d))(data)
    assert torch.equal(_t(want), prng.fold_in(tkeys[1], _t(data)))


@pytest.mark.parametrize("width", [8, 16, 32])
def test_random_bits_match_jax(width):
    k = jax.random.PRNGKey(3)
    want = jax.random.bits(k, (3, 1000), getattr(jnp, f"uint{width}"))
    got = prng.random_bits(_t(k), width, (3, 1000))
    assert torch.equal(_t(want), got)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_uniform_matches_jax_bit_for_bit(jdt, tdt):
    for seed in (0, 11):
        k = jax.random.PRNGKey(seed)
        want = _as_torch(jax.random.uniform(k, (3, 1000), jdt), tdt)
        got = prng.uniform(_t(k), (3, 1000), tdt)
        assert got.dtype == tdt
        assert torch.equal(want.view(torch.int16 if tdt == torch.bfloat16
                                     else torch.int32),
                           got.view(torch.int16 if tdt == torch.bfloat16
                                    else torch.int32))
    # a bfloat16 draw takes 8 random bits (fewer than 8 mantissa bits)
    if tdt == torch.bfloat16:
        bits = prng.random_bits(_t(k), 8, (3, 1000))
        assert torch.equal(((bits >> 1) | 0x3F80).to(torch.int16),
                           (got + 1).view(torch.int16))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_gumbel_within_two_ulp(jdt, tdt):
    k = jax.random.PRNGKey(4)
    want = np.asarray(jax.random.gumbel(k, (8, 4000), jdt)
                      .astype(jnp.float32))
    got = prng.gumbel(_t(k), (8, 4000), tdt).float().numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    if tdt == torch.bfloat16:
        ulp = ulp * 2.0 ** 16           # 7 mantissa bits instead of 23
    assert np.all(np.abs(want - got) <= 2 * ulp)


def test_categorical_matches_jax():
    rs = np.random.RandomState(0)
    lg = jnp.asarray(rs.randn(4, V).astype(np.float32) * 2)
    k = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.categorical(k, lg))
    assert np.array_equal(prng.categorical(_t(k), _as_torch(lg, torch.float32))
                          .numpy(), want)
    keys = _root_keys(4)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, lg))
    assert np.array_equal(prng.categorical(_t(keys),
                                           _as_torch(lg, torch.float32))
                          .numpy(), want)


@pytest.mark.parametrize("n", [5, 16, 17, 256, 1000, 32000])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_scan_cumsum_is_xla_cumsum(n, jdt, tdt):
    x = np.random.RandomState(n).dirichlet(np.full(n, 0.3), size=3)
    xj = jnp.asarray(x.astype(np.float32), jdt)
    want = _as_torch(jnp.cumsum(xj, axis=-1), tdt)
    got = tgen._scan_cumsum(_as_torch(xj, tdt))
    assert torch.equal(want, got)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("top_k", [0, 1, 40, 256, V])
def test_select_token_static_matches_jax(jdt, tdt, top_k):
    """``_select_token`` (plain generate's selector: one key, counters
    flat over [B, V]) over temperature x top_p for one top_k."""
    rs = np.random.RandomState(top_k)
    lj = jnp.asarray((rs.randn(4, V) * 3).astype(np.float32), jdt)
    lt = _as_torch(lj, tdt)
    for i, (temp, top_p) in enumerate(itertools.product([0.7, 1.0, 1.3],
                                                        [1.0, 0.9, 0.5])):
        key = jax.random.PRNGKey(100 + i)
        kw = dict(do_sample=True, temperature=temp, top_k=top_k, top_p=top_p)
        want = np.asarray(jgen._select_token(lj, jgen.GenerationConfig(**kw),
                                             key))
        got = tgen._select_token(lt, tgen.GenerationConfig(**kw), _t(key))
        assert np.array_equal(got.numpy(), want), kw
    greedy = tgen._select_token(lt, tgen.GenerationConfig(), None)
    assert np.array_equal(greedy.numpy(), np.asarray(jnp.argmax(lj, -1)))


def _grid_rows(extra_greedy=6):
    ds = np.array([True] * len(GRID) + [False] * extra_greedy)
    temp = np.array([g[0] for g in GRID] + [1.0] * extra_greedy, np.float32)
    tk = np.array([g[1] for g in GRID] + [0] * extra_greedy, np.int32)
    tp = np.array([g[2] for g in GRID] + [1.0] * extra_greedy, np.float32)
    return ds, temp, tk, tp


def _check_rows(lg, keys, ds, temp, tk, tp, jdt, tdt):
    lj = jnp.asarray(lg, jdt)
    want = np.asarray(jax.jit(jgen.select_tokens)(
        lj, keys, jnp.asarray(ds), jnp.asarray(temp), jnp.asarray(tk),
        jnp.asarray(tp)))
    got = tgen.select_tokens(_as_torch(lj, tdt), _t(keys),
                             torch.from_numpy(ds), torch.from_numpy(temp),
                             torch.from_numpy(tk), torch.from_numpy(tp))
    assert np.array_equal(got.numpy(), want), (got.numpy(), want)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_select_tokens_mixed_grid_matches_jax(jdt, tdt):
    """One batch: the whole grid (top_k 0, 257, 300 and V force the full
    sort) with greedy rows mixed in."""
    ds, temp, tk, tp = _grid_rows()
    lg = (np.random.RandomState(1).randn(len(ds), V) * 3).astype(np.float32)
    _check_rows(lg, _root_keys(len(ds)), ds, temp, tk, tp, jdt, tdt)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_select_tokens_bounded_nucleus_matches_jax(jdt, tdt):
    """Every sampled row inside the bound: the reference takes its
    top-256 path; the port's full-sort filter gives its tokens."""
    keep = [i for i, g in enumerate(GRID) if 0 < g[1] <= 256]
    ds, temp, tk, tp = (a[keep + [-1, -2]] for a in _grid_rows())
    lg = (np.random.RandomState(2).randn(len(ds), V) * 3).astype(np.float32)
    _check_rows(lg, _root_keys(len(ds), 6), ds, temp, tk, tp, jdt, tdt)


def test_select_tokens_tie_straddling_the_bound_matches_jax():
    """Integer logits tie across the 256th value: the reference falls
    back to its full sort, and the port's gives the same tokens."""
    rs = np.random.RandomState(3)
    lg = np.round(rs.randn(6, V) * 2).astype(np.float32)
    srt = -np.sort(-lg, axis=1)
    assert np.all(srt[:, 255] == srt[:, 256])          # ties straddle
    tk = np.array([256, 256, 250, 256, 200, 256], np.int32)
    tp = np.array([0.9, 0.99, 0.5, 1.0, 0.95, 0.999], np.float32)
    for jdt, tdt in DTYPES:
        _check_rows(lg, _root_keys(6, 8), np.ones(6, bool),
                    np.ones(6, np.float32), tk, tp, jdt, tdt)


def _reference_static_filter(logits, temperature, top_k, top_p):
    """The reference's filter lines of ``_select_token`` (before its
    categorical draw), on a jnp array."""
    logits = logits / jnp.maximum(temperature, 1e-6)
    if top_k > 0:
        kth = jnp.sort(logits, axis=-1)[:, -top_k][:, None]
        logits = jnp.where(logits < kth, -1e30, logits)
    if top_p < 1.0:
        sorted_logits = jnp.sort(logits, axis=-1)[:, ::-1]
        probs = jax.nn.softmax(sorted_logits, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        inside = cum - probs < top_p
        cutoff = jnp.min(jnp.where(inside, sorted_logits, jnp.inf), axis=-1,
                         keepdims=True)
        logits = jnp.where(logits < cutoff, -1e30, logits)
    return logits


@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.95])
def test_bf16_top_p_kept_set_at_the_boundary(top_p):
    """bf16 filter math (``_select_token`` on bf16 logits): rows with a
    plateau of near-equal probabilities whose sum crosses ``top_p``, so
    the nucleus edge falls inside the plateau, where bf16 rounding of
    the softmax and the scan decides it (at 0.9 and 0.95 a float32
    accumulation of the same bf16 values keeps another set in one row);
    the kept set equals the reference's, and so do the tokens over 64
    keys."""
    rs = np.random.RandomState(int(top_p * 100))
    rows = []
    for j in range(12):
        lg = rs.randn(V).astype(np.float32) * 0.5 - 6.0
        n = 8 + j
        lg[:n] = np.log(top_p / n) + 7.0 + rs.randn(n) * 0.01 * (j % 3)
        rows.append(lg)
    lj = jnp.asarray(np.stack(rows), jnp.bfloat16)
    lt = _as_torch(lj, torch.bfloat16)
    want = np.asarray(_reference_static_filter(lj, 1.0, 0, top_p)
                      .astype(jnp.float32)) > -1e29
    cfg = tgen.GenerationConfig(do_sample=True, top_p=top_p)
    got = tgen._static_filter(lt, cfg).float().numpy() > -1e29
    assert np.array_equal(got, want)
    assert 1 < want.sum(axis=1).min() < V     # the cutoff falls inside
    jcfg = jgen.GenerationConfig(do_sample=True, top_p=top_p)
    for s in range(64):
        key = jax.random.PRNGKey(s)
        assert np.array_equal(
            tgen._select_token(lt, cfg, _t(key)).numpy(),
            np.asarray(jgen._select_token(lj, jcfg, key)))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_chain_key_walks_the_split_chain(seed):
    """``prng.chain_key`` (the host walk of a preemption's resume key)
    is ``PRNGKey(seed)`` after n links of ``split(key)[0]`` in jax."""
    key = jax.random.PRNGKey(seed)
    for n in range(6):
        assert torch.equal(prng.chain_key(seed, n), _t(key))
        key = jax.random.split(key)[0]


def test_bf16_generate_and_engine_samplers_differ_as_in_the_reference():
    """On bf16 logits the reference's plain ``generate`` draws in bf16
    (``_select_token``: the temperature is a weakly typed scalar) while
    its engine draws in float32 (``select_tokens``: a float32
    temperature vector promotes), so the two disagree on most seeds; in
    float32 they agree. The port mirrors both selectors."""
    rs = np.random.RandomState(0)
    lj = jnp.asarray(rs.randn(1, V) * 3, jnp.bfloat16)
    lt = _as_torch(lj, torch.bfloat16)
    kw = dict(do_sample=True, temperature=0.8, top_k=40)
    jcfg = jgen.GenerationConfig(**kw)
    jgen_draw = jax.jit(lambda lg, k: jgen._select_token(lg, jcfg, k))
    jeng_draw = jax.jit(lambda lg, k: jgen.select_tokens(
        lg, k[None], jnp.array([True]), jnp.array([0.8], jnp.float32),
        jnp.array([40]), jnp.array([1.0], jnp.float32)))
    differ = 0
    for s in range(16):
        key = jax.random.PRNGKey(s)
        jg, je = int(jgen_draw(lj, key)[0]), int(jeng_draw(lj, key)[0])
        tg = int(tgen._select_token(lt, tgen.GenerationConfig(**kw),
                                    _t(key))[0])
        te = int(tgen.select_tokens(lt, _t(key)[None], [True], [0.8], [40],
                                    [1.0])[0])
        assert (tg, te) == (jg, je)
        differ += tg != te
        f32 = lt.float()
        assert int(tgen._select_token(f32, tgen.GenerationConfig(**kw),
                                      _t(key))[0]) == int(tgen.select_tokens(
            f32, _t(key)[None], [True], [0.8], [40], [1.0])[0])
    assert differ >= 8
