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
