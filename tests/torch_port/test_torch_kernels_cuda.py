"""The CUDA flash-decode kernels against their plain PyTorch versions,
on a GPU. Skipped where CUDA is absent; on a GPU machine (which has no
jax) run this file alone:

    python -m pytest --noconftest tests/torch_port/test_torch_kernels_cuda.py

Tolerances: 1e-4 in fp32, 2e-2 in bf16 (the JAX suite's BF16_ATOL).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import decode_attention as tda
from torch_parity import require_cuda

ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _cuda(rng, shape, dtype):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
        .to("cuda").to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("q_len,group", [(1, 1), (1, 8), (8, 4)])
def test_contiguous_kernel_matches_plain(q_len, group, dtype):
    require_cuda()
    rng = np.random.RandomState(10 * q_len + group)
    B, KV, d, max_len = 3, 2, 128, 96
    q = _cuda(rng, (B, q_len, KV * group, d), dtype)
    k = _cuda(rng, (B, max_len, KV, d), dtype)
    v = _cuda(rng, (B, max_len, KV, d), dtype)
    pos = torch.tensor([0, 41, max_len - q_len], dtype=torch.int32,
                       device="cuda")
    tda.reset_counters()
    got = tda.flash_decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_attention"] == 1
    want = tda.flash_decode_attention_ref(q, k, v, pos)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("q_len,group", [(1, 1), (32, 4), (200, 1)])
def test_paged_kernel_matches_plain(q_len, group, dtype):
    require_cuda()
    rng = np.random.RandomState(100 + q_len + group)
    B, KV, d, bs, nb, N = 3, 2, 128, 16, 16, 50
    q = _cuda(rng, (B, q_len, KV * group, d), dtype)
    kp = _cuda(rng, (N, bs, KV, d), dtype)
    vp = _cuda(rng, (N, bs, KV, d), dtype)
    bt_np = (rng.permutation(N - 1)[:B * nb] + 1).reshape(B, nb)
    bt_np[2] = 0                 # dead slot: zeroed table, pos 0
    bt = torch.tensor(bt_np, dtype=torch.int32, device="cuda")
    pos = torch.tensor([nb * bs - q_len, 7, 0], dtype=torch.int32,
                       device="cuda")
    tda.reset_counters()
    got = tda.paged_flash_decode_attention(q, kp, vp, bt, pos)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["paged_flash_decode_attention"] == 1
    want = tda.paged_flash_decode_attention_ref(q, kp, vp, bt, pos)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype],
                               rtol=0)
