"""The CUDA kernels (flash decode K4-K8, flash attention K1-K3, the
quantized matmul K9 and the fused convs K10/K11) against their plain
PyTorch versions, on a GPU. Skipped where CUDA is absent; on a GPU machine (which has no
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


def _flash_case(rng, shape, dtype, with_seg):
    """Seeded q/k/v, output and LSE cotangents (and segment ids) on the
    card for one flash-attention case."""
    b, s, h, d = shape
    q, k, v, do = (_cuda(rng, shape, dtype) for _ in range(4))
    dlse = torch.from_numpy(rng.randn(b, h, s).astype(np.float32)).cuda()
    seg = None
    if with_seg:
        cuts = np.sort(rng.choice(np.arange(1, s), 3, replace=False))
        seg = torch.from_numpy(np.searchsorted(cuts, np.arange(s), "right")
                               .astype(np.int32)[None].repeat(b, 0)).cuda()
    return q, k, v, do, dlse, seg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,d,causal,with_seg", [
    (256, 64, True, False), (200, 128, True, False), (130, 32, False, False),
    (192, 64, True, True), (100, 64, False, True)])
def test_flash_kernels_match_plain(s, d, causal, with_seg, dtype):
    """K1 (out, lse), K2 (dk, dv) and K3 (dq) against the plain versions
    on the same inputs, with a nonzero LSE cotangent."""
    from paddle_tpu_torch.kernels import flash_attention as tfa

    require_cuda()
    rng = np.random.RandomState(s + d)
    shape = (2, s, 3, d)
    q, k, v, do, dlse, seg = _flash_case(rng, shape, dtype, with_seg)
    scale = 1.0 / np.sqrt(d)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    tfa.reset_counters()
    out, lse = tfa.flash_attention_lse(qg, kg, vg, causal=causal,
                                       segment_ids=seg)
    torch.autograd.backward([out, lse], [do, dlse])
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dkdv": 1,
                            "flash_bwd_dq": 1}
    want_out, want_lse = tfa.flash_attention_fwd_ref(q, k, v, seg, causal,
                                                     scale)
    want = tfa.flash_attention_bwd_ref(q, k, v, seg, want_out, want_lse, do,
                                       causal, scale, dlse)
    atol = ATOL[dtype]
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=atol, rtol=0)
    for got, ref in zip((qg.grad, kg.grad, vg.grad), want):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=0)


def _quantized(t, fmt):
    """Per-token-per-head absmax pack of a [.., KV, d] cache or pool:
    (narrow values, f32 scales [.., KV])."""
    from paddle_tpu_torch.quantization.intx import absmax_along, pack_absmax

    amax = absmax_along(t, -1)
    return pack_absmax(t, amax[..., None], fmt), amax


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("q_len,group", [(1, 1), (8, 4)])
def test_contiguous_quant_kernel_matches_plain(q_len, group, dtype, fmt):
    """K5: int8/fp8 caches with per-token scales, dequantized in the
    kernel, against the plain version (dequantize, then attend)."""
    require_cuda()
    rng = np.random.RandomState(20 * q_len + group)
    B, KV, d, max_len = 3, 2, 128, 96
    q = _cuda(rng, (B, q_len, KV * group, d), dtype)
    k, ks = _quantized(_cuda(rng, (B, max_len, KV, d), torch.float32), fmt)
    v, vs = _quantized(_cuda(rng, (B, max_len, KV, d), torch.float32), fmt)
    pos = torch.tensor([0, 41, max_len - q_len], dtype=torch.int32,
                       device="cuda")
    tda.reset_counters()
    got = tda.flash_decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_attention_quant"] == 1
    assert tda.LAUNCHES["flash_decode_attention"] == 0
    want = tda.flash_decode_attention_ref(q, k, v, pos, k_scale=ks,
                                          v_scale=vs)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("q_len,group", [(1, 1), (32, 4), (200, 1)])
def test_paged_quant_kernel_matches_plain(q_len, group, dtype, fmt):
    """K7: quantized pools and scale pools through the block table."""
    require_cuda()
    rng = np.random.RandomState(200 + q_len + group)
    B, KV, d, bs, nb, N = 3, 2, 128, 16, 16, 50
    q = _cuda(rng, (B, q_len, KV * group, d), dtype)
    kp, ks = _quantized(_cuda(rng, (N, bs, KV, d), torch.float32), fmt)
    vp, vs = _quantized(_cuda(rng, (N, bs, KV, d), torch.float32), fmt)
    bt_np = (rng.permutation(N - 1)[:B * nb] + 1).reshape(B, nb)
    bt_np[2] = 0
    bt = torch.tensor(bt_np, dtype=torch.int32, device="cuda")
    pos = torch.tensor([nb * bs - q_len, 7, 0], dtype=torch.int32,
                       device="cuda")
    tda.reset_counters()
    got = tda.paged_flash_decode_attention(q, kp, vp, bt, pos, k_scale=ks,
                                           v_scale=vs)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["paged_flash_decode_attention_quant"] == 1
    want = tda.paged_flash_decode_attention_ref(q, kp, vp, bt, pos,
                                                k_scale=ks, v_scale=vs)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("M,N,K", [(1, 100, 272), (3, 64, 4096),
                                   (8, 4096, 4096), (16, 33, 528),
                                   (17, 130, 1040), (256, 4096, 11008)])
def test_quant_matmul_kernel_matches_plain(M, N, K, dtype, fmt):
    """K9 at every body (GEMV for M <= 16, tiled above) and ragged M, N
    and K tails, against the plain version; outputs are kept near unit
    scale so the bf16 atol of 2e-2 covers a last-place rounding flip."""
    from paddle_tpu_torch.kernels import quant_matmul as tqm
    from paddle_tpu_torch.quantization.intx import pack_absmax

    require_cuda()
    rng = np.random.RandomState(M + N + K)
    x = (_cuda(rng, (M, K), torch.float32) * (0.5 / np.sqrt(K))).to(dtype)
    wf = _cuda(rng, (N, K), torch.float32)
    amax = wf.abs().amax(dim=1)
    w = pack_absmax(wf, amax[:, None], fmt)
    scale = amax / (127.0 if fmt == "int8" else 448.0)
    tqm.reset_counters()
    got = tqm.quant_matmul(x, w, scale)
    torch.cuda.synchronize()
    assert tqm.LAUNCHES["quant_matmul"] == 1
    want = tqm.quant_matmul_ref(x, w, scale)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype],
                               rtol=0)


def _tree_mask(factors, B):
    """The [B, w, w] ancestor mask of a BFS-flattened draft tree, on the
    card."""
    from paddle_tpu_torch.generation import spec_tree_plan

    anc = torch.from_numpy(spec_tree_plan(factors)["anc"])
    return anc[None].expand(B, -1, -1).contiguous().cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("factors,group", [([2, 2], 1), ([2, 2], 4),
                                           ([4, 2, 2], 1), ([4, 2, 2], 4),
                                           ([1, 1, 1, 1], 1)])
def test_tree_kernel_matches_plain(factors, group, dtype, fmt):
    """K8: a draft tree's ancestor mask over a paged pool (unquantized
    or int8/fp8 with scales) in both kernel bodies (gq <= 8 takes the
    small-bundle body, larger bundles the tiled one) against the plain
    version; row 0's bundle ends at the table's end, row 2 is a dead
    slot."""
    require_cuda()
    rng = np.random.RandomState(300 + sum(factors) + group)
    mask = _tree_mask(factors, 3)
    w = mask.shape[1]
    B, KV, d, bs, nb, N = 3, 2, 128, 16, 16, 50
    q = _cuda(rng, (B, w, KV * group, d), dtype)
    if fmt == "bf16":
        kp = _cuda(rng, (N, bs, KV, d), dtype)
        vp = _cuda(rng, (N, bs, KV, d), dtype)
        scales = {}
    else:
        kp, ks = _quantized(_cuda(rng, (N, bs, KV, d), torch.float32), fmt)
        vp, vs = _quantized(_cuda(rng, (N, bs, KV, d), torch.float32), fmt)
        scales = dict(k_scale=ks, v_scale=vs)
    bt_np = (rng.permutation(N - 1)[:B * nb] + 1).reshape(B, nb)
    bt_np[2] = 0
    bt = torch.tensor(bt_np, dtype=torch.int32, device="cuda")
    pos = torch.tensor([nb * bs - w, 19, 0], dtype=torch.int32,
                       device="cuda")
    tda.reset_counters()
    got = tda.paged_flash_decode_attention(q, kp, vp, bt, pos,
                                           ancestor_mask=mask, **scales)
    torch.cuda.synchronize()
    name = "paged_flash_decode_attention_tree" + ("_quant" if scales else "")
    assert tda.LAUNCHES[name] == 1
    want = tda.paged_flash_decode_attention_ref(q, kp, vp, bt, pos,
                                                ancestor_mask=mask, **scales)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("q_len,group", [(5, 1), (8, 1), (29, 1), (3, 4)])
def test_causal_tree_mask_is_bitwise_default(q_len, group, dtype, fmt):
    """K8 with a causal (lower-triangular) mask gives K6/K7's maskless
    output bit for bit, in both bodies."""
    require_cuda()
    rng = np.random.RandomState(400 + q_len + group)
    B, KV, d, bs, nb, N = 3, 2, 128, 16, 16, 50
    q = _cuda(rng, (B, q_len, KV * group, d), dtype)
    if fmt == "bf16":
        kp = _cuda(rng, (N, bs, KV, d), dtype)
        vp = _cuda(rng, (N, bs, KV, d), dtype)
        scales = {}
    else:
        kp, ks = _quantized(_cuda(rng, (N, bs, KV, d), torch.float32), fmt)
        vp, vs = _quantized(_cuda(rng, (N, bs, KV, d), torch.float32), fmt)
        scales = dict(k_scale=ks, v_scale=vs)
    bt = torch.tensor((rng.permutation(N - 1)[:B * nb] + 1).reshape(B, nb),
                      dtype=torch.int32, device="cuda")
    pos = torch.tensor([nb * bs - q_len, 100, 0], dtype=torch.int32,
                       device="cuda")
    causal = torch.ones(q_len, q_len, dtype=torch.bool,
                        device="cuda").tril()[None].expand(B, -1, -1)
    got = tda.paged_flash_decode_attention(q, kp, vp, bt, pos,
                                           ancestor_mask=causal, **scales)
    want = tda.paged_flash_decode_attention(q, kp, vp, bt, pos, **scales)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


CONV_SHAPES = [((2, 8, 8, 16), 32, 3), ((3, 6, 5, 8), 8, 3),
               ((2, 7, 7, 32), 16, 1), ((2, 4, 4, 6), 8, 3),
               ((8, 1, 1, 64), 64, 3), ((4, 14, 14, 64), 40, 3),
               ((2, 9, 9, 128), 13, 1)]
CONV_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,k,kh", CONV_SHAPES)
@pytest.mark.parametrize("variant", ["eval", "eval_relu", "stats", "pre"])
def test_fused_conv_kernels_match_plain(variant, shape, k, kh, dtype,
                                        monkeypatch):
    """K10 (with and without its ReLU) and K11 (with and without its
    prologue) on both bodies (tensor cores for bf16 with C % 8 == 0,
    plain FMA otherwise), odd C and K, a 1x1 image under a 3x3 kernel.
    bf16 outputs: atol plus one rounding step of the stored value (the
    same f32 sum, summed in another order, may round one step apart);
    the batch statistics (f32) to 1e-4."""
    from paddle_tpu_torch.kernels import fused_conv as tfc

    require_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.RandomState(sum(shape) + k + kh)
    c = shape[-1]
    x = _cuda(rng, shape, dtype)
    w = (_cuda(rng, (k, c, kh, kh), torch.float32)
         * (2.0 / (c * kh * kh)) ** 0.5).to(dtype)
    tfc.reset_counters()
    if variant.startswith("eval"):
        relu = variant == "eval_relu"
        scale = _cuda(rng, (k,), torch.float32).abs() + 0.5
        shift = _cuda(rng, (k,), torch.float32) * 0.1
        got = (tfc.fused_conv_bn_eval(x, w, scale, shift, relu),)
        want = (tfc._eval_ref(x, w, scale, shift, relu),)
        name = "fused_conv_bn_eval_relu" if relu else "fused_conv_bn_eval"
    elif variant == "stats":
        got, want = tfc.conv_stats(x, w), tfc._conv_stats_ref(x, w)
        name = "conv_stats"
    else:
        m_p = _cuda(rng, (c,), torch.float32) * 0.1
        v_p = _cuda(rng, (c,), torch.float32).abs() + 0.5
        gp = (_cuda(rng, (c,), torch.float32).abs() + 0.5).to(dtype)
        bp = (_cuda(rng, (c,), torch.float32) * 0.1).to(dtype)
        got = tfc.conv_stats_pre(x, m_p, v_p, gp, bp, w, True, 1e-5)
        want = tfc._conv_stats_pre_ref(x, m_p, v_p, gp, bp, w, True, 1e-5)
        name = "conv_stats_pre"
    torch.cuda.synchronize()
    assert tfc.LAUNCHES[name] == 1 and sum(tfc.LAUNCHES.values()) == 1
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               atol=ATOL[dtype], rtol=CONV_RTOL[dtype])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,kh", CONV_SHAPES[:3])
def test_fused_conv_grads_on_the_card_match_the_cpu(shape, k, kh,
                                                    monkeypatch):
    """conv_stats_pre's outputs and gradients (all six inputs, all three
    cotangents) through the kernel on the card against the plain version
    on the CPU, fp32."""
    from paddle_tpu_torch.kernels import fused_conv as tfc

    require_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.RandomState(7 + k)
    c = shape[-1]
    host = [rng.randn(*shape), rng.randn(c) * 0.1, rng.rand(c) + 0.5,
            rng.rand(c) + 0.5, rng.randn(c) * 0.1,
            rng.randn(k, c, kh, kh) * 0.1]
    host = [torch.from_numpy(np.asarray(a, np.float32)) for a in host]
    cts = None
    res = {}
    for dev in ("cuda", "cpu"):
        args = [a.to(dev).requires_grad_(True) for a in host]
        outs = tfc.conv_stats_pre(*args, True, 1e-5)
        if cts is None:
            cts = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32))
                   for o in outs]
        grads = torch.autograd.grad(outs, args, [t.to(dev) for t in cts])
        res[dev] = [t.detach().cpu() for t in list(outs) + list(grads)]
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)

