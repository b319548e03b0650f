"""Flash-decode parity: the port's kernels, through their plain PyTorch
versions on the CPU, against the JAX package's Pallas kernels called
directly (interpret mode on the CPU). Same seeded numpy inputs, fp32,
atol 1e-5. The CUDA kernels themselves run only on a GPU
(``test_torch_kernels_cuda.py`` and ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from paddle_tpu.pallas_kernels import decode_attention as jda

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
