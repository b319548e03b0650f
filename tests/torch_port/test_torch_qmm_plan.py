"""The launch plan of K9's wgmma body (``quant_matmul.qmm_plan``) and the
arithmetic that ``csrc/quant_matmul.cu``'s ``qmm_wg`` and ``qmm_reduce``
build on it, on the CPU.

The geometry: at Llama-2-7B's four linear shapes and M from 17 to 2048,
the plan fits a block's shared memory, its work items cover every
(output tile, K range) exactly once, and every split starts and ends on
a 64-k boundary (or at K). The reduction: the f32 partial sums of the
splits added in split order and scaled after the sum, mirrored in plain
torch, equal ``quant_matmul_ref`` to f32 rounding. The widening: the
body's bit operations (a byte permute, a mask, one bf16 subtract or
multiply), mirrored in numpy, give every int8 and every non-NaN e4m3
byte bit-equal to torch's ``.to(torch.bfloat16)``.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import quant_matmul as qm

SMS = 132   # an H100's SMs
LLAMA2_7B = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]
MS = (17, 56, 64, 65, 232, 256, 300, 2048)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("N,K", LLAMA2_7B)
def test_items_cover_every_tile_and_k_range_once(M, N, K):
    plan = qm.qmm_plan(M, N, K, SMS)
    assert plan["smem"] <= qm.SMEM_MAX and 2 <= plan["stages"] <= 8
    assert plan["tn"] == (64 if M <= 64 else 128 if M <= 128 else 256)
    assert 1 <= plan["grid"] <= min(plan["items"], SMS)
    steps = -(-K // qm.KSTEP)
    assert (plan["splits"] - 1) * plan["per"] < steps \
        <= plan["splits"] * plan["per"]
    items = qm.qmm_items(plan, M, N, K)
    assert len(items) == plan["items"]
    # per output tile, the k steps its items cover
    covered = {}
    for n0, n1, m0, m1, k0, k1 in items:
        assert n0 < n1 and m0 < m1 and k0 < k1
        assert k0 % qm.KSTEP == 0 and (k1 % qm.KSTEP == 0 or k1 == K)
        assert n0 % qm.ROWS == 0 and m0 % plan["tn"] == 0
        assert n1 == min(n0 + qm.ROWS, N) and m1 == min(m0 + plan["tn"], M)
        covered.setdefault((n0, m0), []).extend(
            range(k0 // qm.KSTEP, -(-k1 // qm.KSTEP)))
    assert sorted(covered) == [(n0, m0) for n0 in range(0, N, qm.ROWS)
                               for m0 in range(0, M, plan["tn"])]
    for ks in covered.values():
        assert sorted(ks) == list(range(steps))


def test_k_splits_only_where_the_tiles_leave_the_card_half_idle():
    # q/k/v/o and down_proj: 32 row tiles, four splits fill 128 SMs;
    # gate/up and lm_head: 86 and 250 tiles, no split
    got = [qm.qmm_plan(256, N, K, SMS)["splits"] for N, K in LLAMA2_7B]
    assert got == [4, 1, 4, 1]
    assert qm.qmm_plan(2048, 4096, 4096, SMS)["splits"] == 1
    # small N: the count is cut so that no split is empty (17 k steps in
    # at most 8 splits of 3)
    assert qm.qmm_plan(256, 130, 1040, SMS)["splits"] == 6
    assert qm.qmm_plan(65, 33, 1040, SMS)["splits"] == 6


def _split_plan(K, splits):
    """The split layout of a plan of ``splits`` K splits (the wrapper's
    plans split 4 or 6 ways at the shapes below; other counts check the
    mirror's arithmetic): ``per`` 64-k steps each, none empty."""
    steps = -(-K // qm.KSTEP)
    per = -(-steps // splits)
    assert -(-steps // per) == splits
    return {"splits": splits, "per": per}


def _split_mirror(x, w, scale, plan):
    """qmm_wg's split partials (f32) added by qmm_reduce in split order,
    then scaled and cast."""
    K = x.shape[1]
    xf, wf = x.float(), w.to(x.dtype).float()
    acc = torch.zeros(x.shape[0], w.shape[0])
    step = plan["per"] * qm.KSTEP
    for sp in range(plan["splits"]):
        k0, k1 = sp * step, min(K, (sp + 1) * step)
        acc = acc + xf[:, k0:k1] @ wf[:, k0:k1].t()
    return acc * scale, (acc * scale).to(x.dtype)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("M,N,K,splits", [(300, 130, 1040, None),
                                          (56, 33, 1040, 5),
                                          (256, 256, 4096, 4),
                                          (17, 4096, 320, 3)])
def test_split_reduction_equals_the_plain_version(fmt, M, N, K, splits):
    rng = np.random.RandomState(M + N + K)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32) * K ** -0.5) \
        .to(torch.bfloat16)
    if fmt == "int8":
        w = torch.from_numpy(rng.randint(-127, 128, (N, K)).astype(np.int8))
    else:
        w = torch.from_numpy(rng.randn(N, K).astype(np.float32) * 50) \
            .to(torch.float8_e4m3fn)
    scale = torch.from_numpy(rng.rand(N).astype(np.float32) / 64 + 1e-3)
    plan = qm.qmm_plan(M, N, K, SMS) if splits is None \
        else _split_plan(K, splits)
    f32, out = _split_mirror(x, w, scale, plan)
    want = torch.matmul(x.float(), w.to(x.dtype).float().t()) * scale
    torch.testing.assert_close(f32, want, rtol=1e-5,
                               atol=1e-6 * want.abs().max().item())
    ref = qm.quant_matmul_ref(x, w, scale)
    # one bf16 rounding step where the two f32 sums round apart, and the
    # f32 error near zero
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                               atol=1e-5 * want.abs().max().item())


def _bf16_bits_as_f32(b):
    return (b.astype(np.uint32) << 16).view(np.float32)


def _f32_as_bf16_bits(f):
    bits = f.astype(np.float32).view(np.uint32)
    assert (bits & 0xFFFF == 0).all()   # exact: nothing to round
    return (bits >> 16).astype(np.uint16)


def _widen_mirror(byte, fmt):
    """qmm_wg's widen2 on one byte, in the halfword it lands in."""
    r = byte.astype(np.uint32)
    if fmt == "int8":
        hi = (r & 0x7F) | 0x4300
        lo = (r & 0x80) | 0x4300
        f = _bf16_bits_as_f32(hi) - _bf16_bits_as_f32(lo)
    else:
        r = r << 8
        bits = ((r >> 4) & 0x07F0) | (r & 0x8000)
        f = _bf16_bits_as_f32(bits) * np.float32(2.0 ** 120)
    return _f32_as_bf16_bits(f)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_widening_is_bit_equal_to_torch(fmt):
    byte = np.arange(256, dtype=np.uint8)
    dtype = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    want = torch.from_numpy(byte).view(dtype).to(torch.bfloat16) \
        .view(torch.int16).numpy().view(np.uint16)
    got = _widen_mirror(byte, fmt)
    if fmt == "fp8":
        keep = (byte & 0x7F) != 0x7F   # e4m3 NaN
        got, want = got[keep], want[keep]
        assert keep.sum() == 254
    np.testing.assert_array_equal(got, want)


# the GEMV (bf16, M <= 16): Llama-2-7B's shapes, ragged N and K, one
# group of one partial step, fewer groups than SMs, a long K
GEMV_CASES = LLAMA2_7B + [(4100, 4112), (8, 16), (1000, 1040),
                          (130, 28672)]


@pytest.mark.parametrize("M", (1, 8, 9, 16))
@pytest.mark.parametrize("N,K", GEMV_CASES)
def test_gemv_plan_covers_every_row_and_k_step_once(M, N, K):
    """The GEMV's plan: one block a SM at most; every weight row belongs
    to one block (blocks differ by at most one 8-row group) and every
    16-row tile's warps' runs of k steps cover [0, K) exactly once, in
    warp order."""
    plan = qm.gemv_plan(M, N, K, SMS)
    assert plan["x_tiles"] == -(-M // 8) and plan["splits"] == 1
    assert plan["step_round"] == (4 if M <= 8 else 2)
    assert plan["grid"] == min(SMS, plan["groups"]) and plan["smem"] == 0
    steps = -(-K // qm.KSTEP)
    assert (plan["per"] - 1) * qm.GEMV_WARPS < steps \
        <= plan["per"] * qm.GEMV_WARPS
    assert plan["rounds"] * plan["step_round"] >= plan["per"]
    runs, rows = {}, {}
    for blk, warp, n0, n1, k0, k1 in qm.gemv_items(plan, N, K):
        assert n0 < n1 <= n0 + 16 and k0 < k1
        assert k0 % qm.KSTEP == 0 and (k1 % qm.KSTEP == 0 or k1 == K)
        assert k1 - k0 <= plan["per"] * qm.KSTEP
        runs.setdefault((n0, n1), []).append((warp, k0, k1))
        rows.setdefault(blk, set()).update(range(n0, n1))
    covered = sorted(r for rs in rows.values() for r in rs)
    assert covered == list(range(N))
    sizes = [len(r) for r in rows.values()]
    assert max(sizes) - min(sizes) <= 8
    assert max(sizes) <= plan["block_groups"] * 8
    for r in runs.values():
        ks = [(k0, k1) for _, k0, k1 in sorted(r)]
        assert ks[0][0] == 0 and ks[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(ks, ks[1:]))


def _gemv_mirror(x, w, scale, plan):
    """The GEMV's sums in its order: each warp's run of k steps, the
    warps of a tile in order; then the scale and the cast."""
    K = x.shape[1]
    xf, wf = x.float(), w.to(x.dtype).float()
    acc = torch.zeros(x.shape[0], w.shape[0])
    span = plan["per"] * qm.KSTEP
    for warp in range(qm.GEMV_WARPS):
        k0, k1 = min(K, warp * span), min(K, (warp + 1) * span)
        acc = acc + xf[:, k0:k1] @ wf[:, k0:k1].t()
    return acc * scale, (acc * scale).to(x.dtype)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("M,N,K", [(8, 130, 1040), (16, 33, 4112),
                                   (1, 64, 30000)])
def test_gemv_reduction_equals_the_plain_version(fmt, M, N, K):
    rng = np.random.RandomState(M + N + K)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32) * K ** -0.5) \
        .to(torch.bfloat16)
    if fmt == "int8":
        w = torch.from_numpy(rng.randint(-127, 128, (N, K)).astype(np.int8))
    else:
        w = torch.from_numpy(rng.randn(N, K).astype(np.float32) * 50) \
            .to(torch.float8_e4m3fn)
    scale = torch.from_numpy(rng.rand(N).astype(np.float32) / 64 + 1e-3)
    plan = qm.gemv_plan(M, N, K, SMS)
    f32, out = _gemv_mirror(x, w, scale, plan)
    want = torch.matmul(x.float(), w.to(x.dtype).float().t()) * scale
    torch.testing.assert_close(f32, want, rtol=1e-5,
                               atol=1e-6 * want.abs().max().item())
    ref = qm.quant_matmul_ref(x, w, scale)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                               atol=1e-5 * want.abs().max().item())
