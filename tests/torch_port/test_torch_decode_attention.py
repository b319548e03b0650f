"""Flash-decode parity: the port's kernels, through their plain PyTorch
versions on the CPU, against the JAX package's Pallas kernels called
directly (interpret mode on the CPU). Same seeded numpy inputs, fp32,
atol 1e-5; the quantized cases (K5, K7) feed both the same int8/fp8
caches and per-token-per-head scales. The CUDA kernels themselves run
only on a GPU (``test_torch_kernels_cuda.py`` and ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from paddle_tpu.pallas_kernels import decode_attention as jda
from paddle_tpu.quantization import intx as jintx

from paddle_tpu_torch.kernels import decode_attention as tda

ATOL = 1e-5
KV, D = 2, 16


@pytest.fixture(autouse=True)
def _zero_counters():
    tda.reset_counters()
    yield


# every listed q_len and group appears; each case is one interpret-mode
# compile of the JAX kernel (~1.5 s), so not the full product
@pytest.mark.parametrize("q_len,group", [(1, 1), (1, 4), (4, 2), (8, 1),
                                         (8, 4)])
def test_contiguous_matches_jax(q_len, group):
    rng = np.random.RandomState(100 * q_len + group)
    B, max_len = 4, 48
    q = rng.randn(B, q_len, KV * group, D).astype(np.float32)
    k = rng.randn(B, max_len, KV, D).astype(np.float32)
    v = rng.randn(B, max_len, KV, D).astype(np.float32)
    # ragged rows: empty cache, middle, full, one block in
    pos = np.array([0, 21, max_len - q_len, 16], np.int32)
    want = np.asarray(jda.flash_decode_attention(q, k, v, pos, block_k=16))
    got = tda.flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert tda.LAUNCHES["flash_decode_attention"] == 0


@pytest.mark.parametrize("q_len,group", [(1, 1), (1, 2), (5, 4), (32, 1),
                                         (32, 4)])
def test_paged_matches_jax(q_len, group):
    rng = np.random.RandomState(1000 + 10 * q_len + group)
    B, bs, nb, N = 3, 8, 6, 20
    q = rng.randn(B, q_len, KV * group, D).astype(np.float32)
    kp = rng.randn(N, bs, KV, D).astype(np.float32)
    vp = rng.randn(N, bs, KV, D).astype(np.float32)
    # shuffled physical blocks; row 2 is a dead slot (zeroed table, pos 0)
    bt = (rng.permutation(N - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    bt[2] = 0
    pos = np.array([0, nb * bs - q_len, 0], np.int32)
    want = np.asarray(jda.paged_flash_decode_attention(q, kp, vp, bt, pos))
    got = tda.paged_flash_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert tda.LAUNCHES["paged_flash_decode_attention"] == 0


def test_scalar_position_equals_vector():
    rng = np.random.RandomState(7)
    q = torch.from_numpy(rng.randn(2, 3, 4, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 24, KV, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 24, KV, D).astype(np.float32))
    a = tda.flash_decode_attention(q, k, v, 9)
    b = tda.flash_decode_attention(q, k, v, torch.tensor([9, 9]))
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def _quant_cache(rng, shape, fmt):
    """A seeded cache quantized per token per head by the JAX package:
    (storage as numpy, the same as a torch tensor, scales [.., KV])."""
    import jax.numpy as jnp

    x = rng.randn(*shape).astype(np.float32)
    amax = np.abs(x).max(axis=-1)
    q = np.asarray(jintx.pack_absmax(jnp.asarray(x),
                                     jnp.asarray(amax)[..., None], fmt))
    dt = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    t = torch.from_numpy(np.array(q.view(np.uint8))).view(dt)
    return q, t, amax


# each format meets each kind of bundle once (interpret-mode compiles
# are ~1.5 s each)
@pytest.mark.parametrize("fmt,q_len,group", [("int8", 1, 1), ("fp8", 4, 2)])
def test_contiguous_quant_matches_jax(fmt, q_len, group):
    """K5's plain version against the JAX dequant-prologue kernel."""
    rng = np.random.RandomState(300 + 10 * q_len + group)
    B, max_len = 3, 48
    q = rng.randn(B, q_len, KV * group, D).astype(np.float32)
    kq, kt, ks = _quant_cache(rng, (B, max_len, KV, D), fmt)
    vq, vt, vs = _quant_cache(rng, (B, max_len, KV, D), fmt)
    pos = np.array([0, 21, max_len - q_len], np.int32)
    want = np.asarray(jda.flash_decode_attention(
        q, kq, vq, pos, block_k=16, k_scale=ks, v_scale=vs))
    got = tda.flash_decode_attention(
        torch.from_numpy(q), kt, vt, torch.from_numpy(pos),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert tda.LAUNCHES["flash_decode_attention_quant"] == 0


@pytest.mark.parametrize("fmt,q_len,group", [("fp8", 1, 2), ("int8", 32, 1)])
def test_paged_quant_matches_jax(fmt, q_len, group):
    """K7's plain version against the JAX paged dequant kernel, scales
    read through the same block table."""
    rng = np.random.RandomState(400 + 10 * q_len + group)
    B, bs, nb, N = 3, 8, 6, 20
    q = rng.randn(B, q_len, KV * group, D).astype(np.float32)
    kq, kt, ks = _quant_cache(rng, (N, bs, KV, D), fmt)
    vq, vt, vs = _quant_cache(rng, (N, bs, KV, D), fmt)
    bt = (rng.permutation(N - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    bt[2] = 0
    pos = np.array([nb * bs - q_len, 5, 0], np.int32)
    want = np.asarray(jda.paged_flash_decode_attention(
        q, kq, vq, bt, pos, k_scale=ks, v_scale=vs))
    got = tda.paged_flash_decode_attention(
        torch.from_numpy(q), kt, vt, torch.from_numpy(bt),
        torch.from_numpy(pos), k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_scales_must_pair():
    q = torch.zeros(1, 1, 2, D)
    k = torch.zeros(1, 8, KV, D, dtype=torch.int8)
    with pytest.raises(ValueError, match="both"):
        tda.flash_decode_attention(q, k, k, 0, k_scale=torch.ones(1, 8, KV))


def test_dispatch_gates_and_reasons():
    f32 = torch.float32
    with torch.no_grad():
        assert tda.decode_dispatch("llama", q_len=8, has_mask=False, dtype=f32)
        assert not tda.decode_dispatch("llama", q_len=9, has_mask=False,
                                       dtype=f32)
        assert not tda.decode_dispatch("llama", q_len=1, has_mask=True,
                                       dtype=f32)
        assert not tda.decode_dispatch("llama", q_len=1, has_mask=False,
                                       dtype=torch.float16)
        assert tda.paged_decode_dispatch("llama", q_len=256, has_mask=False,
                                         dtype=torch.bfloat16)
        assert not tda.paged_decode_dispatch("llama", q_len=257,
                                             has_mask=False, dtype=f32)
    assert not tda.decode_dispatch("llama", q_len=1, has_mask=False, dtype=f32)
    assert dict(tda.DISPATCH_HITS) == {"llama": 1, "llama_paged": 1}
    assert dict(tda.DISPATCH_FALLBACKS) == {
        "q_len": 1, "external_mask": 1, "dtype": 1, "paged_q_len": 1,
        "grad_mode": 1}


def test_quant_dispatch_labels():
    """Quantized caches count under their own labels, as the JAX
    package's ``quantized=`` dispatch does."""
    f32 = torch.float32
    with torch.no_grad():
        assert tda.decode_dispatch("llama", q_len=1, has_mask=False,
                                   dtype=f32, quantized=True)
        assert not tda.decode_dispatch("llama", q_len=9, has_mask=False,
                                       dtype=f32, quantized=True)
        assert tda.paged_decode_dispatch("llama", q_len=256, has_mask=False,
                                         dtype=f32, quantized=True)
        assert not tda.paged_decode_dispatch("llama", q_len=1, has_mask=True,
                                             dtype=f32, quantized=True)
    assert dict(tda.DISPATCH_HITS) == {"llama_quant": 1,
                                       "llama_paged_quant": 1}
    assert dict(tda.DISPATCH_FALLBACKS) == {"quant_q_len": 1,
                                            "paged_quant_external_mask": 1}


# -- the kernel body and launch plan (pure functions; no card needed) -------

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("q_len,group,dtype,body", [
    (1, 1, BF16, "qrows"), (1, 4, BF16, "qrows"), (1, 8, BF16, "qrows"),
    (1, 16, BF16, "mma"),           # more rows than the qrows body holds
    (2, 1, BF16, "mma"), (5, 1, BF16, "mma"), (7, 4, BF16, "mma"),
    (29, 1, BF16, "mma"), (256, 1, BF16, "mma"), (256, 8, BF16, "mma"),
    (1, 1, F32, "rows"), (8, 1, F32, "rows"), (2, 4, F32, "rows"),
    (9, 1, F32, "tiled"), (29, 1, F32, "tiled"), (256, 4, F32, "tiled")])
def test_bundle_body_routing(q_len, group, dtype, body):
    """The bf16 decode step takes the qrows body over bf16 K/V too, every
    bf16 bundle of q_len >= 2 goes to the tensor cores, and fp32 keeps
    the SIMT bodies."""
    assert tda.bundle_body(q_len, group, dtype) == body
    assert tda.bundle_body(q_len, group, dtype, "bf16") == body


@pytest.mark.parametrize("fmt", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("q_len,group,dtype,body", [
    (1, 1, BF16, "qrows"), (1, 2, BF16, "qrows"), (1, 4, BF16, "qrows"),
    (1, 8, BF16, "qrows"), (1, 16, BF16, "mma"), (2, 1, BF16, "mma"),
    (7, 1, BF16, "mma"), (256, 1, BF16, "mma"), (1, 1, F32, "rows"),
    (8, 1, F32, "rows"), (9, 1, F32, "tiled")])
def test_bundle_body_routing_over_narrow_storage(q_len, group, dtype, body,
                                                 fmt):
    """bf16 decode steps (q_len 1, at most 8 rows) over int8, fp8 and
    bf16 K/V take the qrows body; every other bundle the body it takes
    over bf16 K/V (fp32 queries keep the SIMT bodies, the card-against-CPU
    path)."""
    assert tda.bundle_body(q_len, group, dtype, fmt) == body


def test_bundle_body_refuses_other_dtypes():
    with pytest.raises(TypeError, match="no kernel body"):
        tda.bundle_body(4, 1, torch.float16)


# (q_len, group, dtype, B, KV, max_len)
PLAN_CASES = [
    (1, 1, BF16, 8, 32, 2048), (1, 4, BF16, 8, 8, 2048),
    (256, 1, BF16, 1, 32, 2048), (256, 4, BF16, 1, 8, 2048),
    (29, 1, BF16, 8, 32, 2048), (7, 1, BF16, 8, 32, 2048),
    (5, 1, BF16, 8, 32, 2048), (16, 1, BF16, 3, 2, 272),
    (17, 4, BF16, 3, 2, 272), (200, 8, BF16, 3, 2, 272),
    (48, 1, F32, 1, 4, 64), (256, 1, F32, 1, 32, 2048),
    (1, 1, F32, 8, 32, 2000), (33, 4, BF16, 2, 2, 1000)]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_launch_plan_splits_tile_the_key_range(case):
    """Splits cover [0, max_len) exactly in whole units, none empty; the
    row tile holds the bundle; the mma body's fp32 partials stay within
    their share of the K/V bytes whenever it splits."""
    q_len, group, dtype, B, KV, max_len = case
    p = tda.launch_plan(q_len, group, dtype, B, KV, max_len, 132)
    gq = q_len * group
    unit = 64 if p["body"] == "mma" else 32
    assert p["split_keys"] % unit == 0
    assert p["n_split"] * p["split_keys"] >= max_len
    assert (p["n_split"] - 1) * p["split_keys"] < max_len
    assert p["tiles"] * p["rows"] >= gq > (p["tiles"] - 1) * p["rows"]
    if p["body"] == "mma":
        assert p["rows"] == (16 if gq <= 16 else tda.MMA_ROWS)
        if p["n_split"] > 1:   # partials against the bf16 K/V, per d
            assert p["n_split"] * gq * 4 \
                <= max_len * 2 * 2 / tda._MMA_PART_SHARE
    elif p["body"] == "rows":
        assert p["rows"] >= gq and p["rows"] in (1, 2, 4, 8)


def test_launch_plan_at_the_serving_shapes():
    """Llama-2-7B's shapes on 132 SMs: the decode step keeps its split
    (eight of 256 keys on the qrows body, over bf16 and narrow K/V; bf16
    K/V splits groups 4 and 8 twice as finely); a 256-token chunk takes
    four 64-row tiles on the tensor cores in four splits (its partials
    half of its K/V), the 8-row verify bundles four splits of one tile;
    on a card with a quarter of the SMs a bundle runs in one."""
    for fmt in ("int8", "fp8", "bf16"):
        assert tda.launch_plan(1, 1, BF16, 8, 32, 2048, 132, fmt) == {
            "body": "qrows", "rows": 1, "tiles": 1, "n_split": 8,
            "split_keys": 256}
        # the split counts of the groups the body holds (PERF.md)
        assert [tda.launch_plan(1, g, BF16, 8, 32 // g, 2048, 132, fmt)[k]
                for g in (2, 4, 8) for k in ("rows", "n_split")] \
            == ([2, 8, 4, 16, 8, 32] if fmt == "bf16"
                else [2, 8, 4, 8, 8, 16])
        # the engine's bundles over narrow pools stay on the tensor cores
        assert tda.launch_plan(256, 1, BF16, 1, 32, 2048, 132, fmt) \
            == tda.launch_plan(256, 1, BF16, 1, 32, 2048, 132)
    plan = {q_len: tda.launch_plan(q_len, 1, BF16, B, 32, 2048, 132)
            for q_len, B in ((256, 1), (29, 8), (7, 8), (5, 8))}
    assert {k: (p["body"], p["rows"], p["tiles"], p["n_split"])
            for k, p in plan.items()} == {
        256: ("mma", 64, 4, 4), 29: ("mma", 64, 1, 4), 7: ("mma", 16, 1, 4),
        5: ("mma", 16, 1, 4)}
    assert tda.launch_plan(7, 1, BF16, 8, 32, 2048, 32)["n_split"] == 1
    chunk32 = tda.launch_plan(256, 1, F32, 1, 32, 2048, 132)
    assert chunk32["body"] == "tiled" and chunk32["rows"] == 64


def _rn32(v64, rounded=False):
    """float64 values rounded to float32. ``rounded``: the float64 values
    were themselves rounded, so none may sit on a float32 midpoint (where
    rounding twice could differ from rounding the exact value once)."""
    out = v64.astype(np.float32)
    if rounded:
        lo = np.nextafter(out, np.float32(-np.inf)).astype(np.float64)
        hi = np.nextafter(out, np.float32(np.inf)).astype(np.float64)
        o = out.astype(np.float64)
        assert not ((v64 == (o + lo) / 2) | (v64 == (o + hi) / 2)).any()
    return out


def _div_bound_consts(bound):
    """csrc/div_bound.cuh's zh (1 / bound rounded down to float32) and zl
    (RN(1 / bound - zh), positive), as float64 values."""
    zh = np.float32(1.0) / np.float32(bound)
    if np.float64(zh) > 1.0 / bound:
        zh = np.nextafter(zh, np.float32(0))
    zl = np.float32(1.0 / bound - np.float64(zh))
    assert zl > 0
    return np.float64(zh), np.float64(zl)


def _div_bound_emulated(x64, bound):
    """div_bound on float32 values held in float64: RN(x * zh + RN(x *
    zl)), its one fma exact in float64 before the last rounding."""
    zh, zl = _div_bound_consts(bound)
    u = _rn32(x64 * zl).astype(np.float64)        # x * zl exact in float64
    p = x64 * zh                                  # exact in float64
    assert np.array_equal((p + u) - p, u)         # and so is the sum
    return _rn32(p + u)


@pytest.mark.parametrize("bound", [127.0, 448.0])
def test_div_bound_emulated_is_correctly_rounded(bound):
    """The quantized bodies divide by the absmax bound without a division
    (``csrc/div_bound.cuh``): RN(x * zh + RN(x * zl)) with zh = 1 / bound
    rounded down and zl = RN(1 / bound - zh), one multiply and one fma.
    Emulated in float64 (each product and the fma's sum are exact there)
    over every float32 x in [1, 2), it equals RN(x / bound) (whose float64
    quotient never lands on a float32 midpoint). A power-of-two scale of
    x scales every step exactly, so this covers every binade whose
    intermediates stay normal; the card checks the compiled code."""
    x = (np.uint32(0x3F800000) | np.arange(1 << 23, dtype=np.uint32)) \
        .view(np.float32).astype(np.float64)
    got = _div_bound_emulated(x, bound)
    want = _rn32(x / bound, rounded=True)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # the constants csrc/div_bound.cuh spells in hex
    assert [c.hex() for c in _div_bound_consts(bound)] == (
        ["0x1.0204080000000p-7", "0x1.0204080000000p-35"] if bound == 127
        else ["0x1.2492480000000p-9", "0x1.24924a0000000p-33"])
    # exact_scale's range: every nonzero |q| * s of int8 (1..127) and fp8
    # (2^-9..448) stays inside [2^-90, 2^100] for s in [2^-80, 2^90]
    assert 2.0 ** -9 * 2.0 ** -80 >= 2.0 ** -90
    assert 448 * 2.0 ** 90 <= 2.0 ** 100


# (q_len, group, B, KV, max_len) of decode steps over narrow K/V
NARROW_PLAN_CASES = [(1, 1, 8, 32, 2048), (1, 4, 8, 8, 2048),
                     (1, 8, 2, 2, 1000), (1, 2, 3, 2, 272), (1, 1, 1, 1, 17)]


@pytest.mark.parametrize("case", NARROW_PLAN_CASES)
def test_launch_plan_splits_narrow_decode_steps(case):
    """The qrows body's splits (over int8, fp8 and bf16 K/V) tile [0,
    max_len) in whole 64-key units (four 16-key pages) of at most 256
    keys, none empty; its row tile holds the group."""
    q_len, group, B, KV, max_len = case
    for fmt in ("int8", "fp8", "bf16"):
        p = tda.launch_plan(q_len, group, BF16, B, KV, max_len, 132, fmt)
        assert p["body"] == "qrows" and p["split_keys"] % 64 == 0
        assert p["split_keys"] <= tda._QROWS_SPLIT_KEYS
        assert p["n_split"] * p["split_keys"] >= max_len
        assert (p["n_split"] - 1) * p["split_keys"] < max_len
        assert p["tiles"] == 1 and p["rows"] in (1, 2, 4, 8)
        assert p["rows"] >= group > p["rows"] // 2


def _bf16_f32(bits):
    """bf16 bit patterns (uint32, low 16 bits) as float32, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _narrow_f32_emulated(codes, fmt):
    """csrc/widen.cuh's narrow4_f32 on each storage byte, in numpy. int8:
    the byte with its sign bit flipped under 2^23's exponent, minus 2^23 +
    128 (float32, exact). e4m3: widen2, the byte placed in a bf16 bit
    pattern times 2^120 (float32, exact), then the bf16 as f32."""
    r = codes.astype(np.uint32)
    if fmt == "int8":
        out = (np.uint32(0x4B000000) | (r ^ 0x80)).view(np.float32) \
            - np.float32(8388736.0)
    else:
        h = r << 8                       # the byte in the halfword's top
        out = _bf16_f32(((h >> 4) & 0x07F0) | (h & 0x8000)) \
            * np.float32(2.0 ** 120)
    assert not (out.view(np.uint32) & 0xFFFF).any()   # a bf16 value
    return out


def _qrows_dequant_emulated(codes, s, fmt):
    """flash_decode_qrows' dequant of ``codes`` (uint8) under scales ``s``
    (float32, broadcast against them), in numpy float32/uint32:
    narrow4_f32, __fmul_rn by the scale, div_bound (as its own test
    emulates it), then round to nearest even to bf16 (the bits of
    cvt.rn.bf16x2.f32). Returns the bf16 bits as uint16."""
    bound = 127.0 if fmt == "int8" else 448.0
    x = (_narrow_f32_emulated(codes, fmt) * s).astype(np.float32)
    u = _div_bound_emulated(x.astype(np.float64), bound).view(np.uint32)
    rounded = (u + np.uint32(0x7FFF) + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)
    return (rounded >> 16).astype(np.uint16)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_qrows_dequant_emulated_is_unpack_absmax(fmt):
    """The decode step's dequant without division or conversion
    instructions, emulated bit for bit, equals f32(q) * s / bound rounded
    to bf16 (the JAX prologue, torch's true division on the CPU) for
    every storage byte (e4m3's two NaN codes aside: the quantizer never
    writes them) over a spread of scales: exact_scale's edges (0, 2^-80,
    2^90), absmax-like ones and 200 log-uniform ones between; and equals
    the port's unpack_absmax(..., torch.bfloat16) wherever its 1e-9 clamp
    leaves the scale alone."""
    from paddle_tpu_torch.quantization.intx import (div_exact, format_bound,
                                                    format_dtype,
                                                    unpack_absmax)

    rng = np.random.RandomState(11)
    scales = np.concatenate([
        [0.0, 2.0 ** -80, 2.0 ** 90, 1e-9, 1.0, 0.5, 3.7, 250.0, 0.1234567,
         np.nextafter(np.float32(2.0 ** -80), np.float32(1)),
         np.nextafter(np.float32(2.0 ** 90), np.float32(0))],
        rng.uniform(0.01, 8.0, 40),
        2.0 ** rng.uniform(-80, 90, 200)]).astype(np.float32)
    codes = np.arange(256, dtype=np.uint8)
    if fmt == "fp8":
        codes = codes[(codes & 0x7F) != 0x7F]
    got = _qrows_dequant_emulated(codes[None, :], scales[:, None], fmt)
    q = torch.from_numpy(codes).view(format_dtype(fmt))[None, :]
    s = torch.from_numpy(scales)[:, None]
    want = div_exact(q.float() * s, format_bound(fmt)).to(torch.bfloat16)
    assert np.array_equal(got, want.view(torch.int16).numpy()
                          .view(np.uint16))
    ok = scales >= 1e-9
    ref = unpack_absmax(q, s, fmt, torch.bfloat16)
    assert torch.equal(ref.view(torch.int16)[ok], want.view(torch.int16)[ok])
