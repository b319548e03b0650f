"""The CUDA kernels (flash decode K4-K8, its quantized decode step and
its exact division, flash attention K1-K3, the quantized matmul K9 and
the fused convs K10/K11) against their plain PyTorch versions, on a GPU,
K4-K9 also at GPT-3 1.3B's shapes (``-k gpt``, with the biased
weight-only linear); and the sampler (threefry keys, bits, Gumbel
draws, ``select_tokens``) on the card against the same code on the
CPU.
Skipped where CUDA is absent; on a GPU machine (which has no jax) run
this file alone:

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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 200, 1024])
@pytest.mark.parametrize("causal,with_seg", [(True, False), (False, False),
                                             (True, True)])
def test_flash_fwd_bodies_match_plain(s, d, causal, with_seg):
    """K1 in bf16 at every head_dim, short and ragged lengths, causal or
    not, with segments: out and lse against the plain version, every
    launch on the wgmma body, and two launches bit-equal."""
    from paddle_tpu_torch.kernels import flash_attention as tfa

    require_cuda()
    rng = np.random.RandomState(s * d + causal)
    shape = (2, s, 3, d)
    q, k, v, _, _, seg = _flash_case(rng, shape, torch.bfloat16,
                                     with_seg and s > 4)
    scale = 1.0 / np.sqrt(d)
    tfa.reset_counters()
    out, lse = tfa._launch_fwd(q, k, v, seg, causal, scale)
    out2, lse2 = tfa._launch_fwd(q, k, v, seg, causal, scale)
    torch.cuda.synchronize()
    assert dict(tfa.BODY_LAUNCHES) == {"flash_fwd/wgmma": 2}
    assert torch.equal(out.view(torch.int16), out2.view(torch.int16))
    assert torch.equal(lse, lse2)
    want_out, want_lse = tfa.flash_attention_fwd_ref(q, k, v, seg, causal,
                                                     scale)
    atol = ATOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_fwd_reads_a_fused_qkv_view(d):
    """q, k and v as strided views of one fused [b, s, 3 h d] projection
    (the layout a fused qkv linear gives): the wgmma body reads them in
    place through its tensor maps, with no copy."""
    from paddle_tpu_torch.kernels import flash_attention as tfa

    require_cuda()
    rng = np.random.RandomState(d)
    b, s, h = 2, 300, 4
    qkv = _cuda(rng, (b, s, 3 * h * d), torch.bfloat16)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, s, h, d)
               for i in range(3))
    assert not q.is_contiguous() and tfa._strided(q) is q
    out, lse = tfa._launch_fwd(q, k, v, None, True, 1.0 / np.sqrt(d))
    want_out, want_lse = tfa.flash_attention_fwd_ref(
        q.contiguous(), k.contiguous(), v.contiguous(), None, True,
        1.0 / np.sqrt(d))
    atol = ATOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=atol, rtol=0)


def _flash_bwd_inputs(q, k, v, do, dlse, seg, causal):
    """The backward kernels' inputs from K1's own forward: (lse, delta)."""
    from paddle_tpu_torch.kernels import flash_attention as tfa

    out, lse = tfa._launch_fwd(q, k, v, seg, causal, 1.0 / np.sqrt(q.shape[-1]))
    return out, lse, tfa._delta(out, do, dlse)


def _flash_bwd(q, k, v, do, seg, lse, delta, causal):
    from paddle_tpu_torch.kernels import flash_attention as tfa

    scale = 1.0 / np.sqrt(q.shape[-1])
    dk, dv = tfa._launch_bwd_kernel("flash_bwd_dkdv", q, k, v, seg, do, lse,
                                    delta, causal, scale)
    dq = tfa._launch_bwd_kernel("flash_bwd_dq", q, k, v, seg, do, lse, delta,
                                causal, scale)
    return dq, dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 200, 1024])
@pytest.mark.parametrize("causal,with_seg", [(True, False), (False, False),
                                             (True, True)])
def test_flash_bwd_bodies_match_plain(s, d, causal, with_seg):
    """K2 and K3 in bf16 at every head_dim, short and ragged lengths,
    causal or not, with segments, with a nonzero LSE cotangent: dq, dk
    and dv against the plain version, every launch on the wgmma bodies."""
    from paddle_tpu_torch.kernels import flash_attention as tfa

    require_cuda()
    rng = np.random.RandomState(7 * s + d + causal)
    shape = (2, s, 3, d)
    q, k, v, do, dlse, seg = _flash_case(rng, shape, torch.bfloat16,
                                         with_seg and s > 4)
    out, lse, delta = _flash_bwd_inputs(q, k, v, do, dlse, seg, causal)
    tfa.reset_counters()
    got = _flash_bwd(q, k, v, do, seg, lse, delta, causal)
    torch.cuda.synchronize()
    assert dict(tfa.BODY_LAUNCHES) == {"flash_bwd_dkdv/wgmma": 1,
                                       "flash_bwd_dq/wgmma": 1}
    want = tfa.flash_attention_bwd_ref(q, k, v, seg, out, lse, do, causal,
                                       1.0 / np.sqrt(d), dlse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=ATOL[torch.bfloat16], rtol=0,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_bwd_reads_a_fused_qkv_view(d):
    """The backward through autograd with q, k and v as strided views of
    one fused [b, s, 3 h d] projection: the wgmma bodies read them in
    place, and the gradients land in the fused tensor's gradient."""
    from paddle_tpu_torch.kernels import flash_attention as tfa

    require_cuda()
    rng = np.random.RandomState(10 + d)
    b, s, h = 2, 300, 4
    qkv = _cuda(rng, (b, s, 3 * h * d), torch.bfloat16).requires_grad_(True)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, s, h, d)
               for i in range(3))
    assert not q.is_contiguous() and tfa._strided(q) is q
    do = _cuda(rng, (b, s, h, d), torch.bfloat16)
    tfa.reset_counters()
    tfa.flash_attention(q, k, v, causal=True).backward(do)
    torch.cuda.synchronize()
    assert tfa.BODY_LAUNCHES["flash_bwd_dkdv/wgmma"] == 1
    assert tfa.BODY_LAUNCHES["flash_bwd_dq/wgmma"] == 1
    qc, kc, vc = (t.detach().contiguous() for t in (q, k, v))
    out, lse = tfa.flash_attention_fwd_ref(qc, kc, vc, None, True,
                                           1.0 / np.sqrt(d))
    want = tfa.flash_attention_bwd_ref(qc, kc, vc, None, out, lse, do, True,
                                       1.0 / np.sqrt(d))
    grads = qkv.grad.view(b, s, 3, h, d)
    for i, w in enumerate(want):
        torch.testing.assert_close(grads[:, :, i].float(), w.float(),
                                   atol=ATOL[torch.bfloat16], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_is_deterministic(d):
    """No atomics: two backward calls on the same inputs give bitwise
    equal dq, dk and dv (the training shape's width, causal, ragged S)."""
    require_cuda()
    rng = np.random.RandomState(20 + d)
    q, k, v, do, dlse, seg = _flash_case(rng, (4, 1000, 12, d),
                                         torch.bfloat16, False)
    _, lse, delta = _flash_bwd_inputs(q, k, v, do, dlse, seg, True)
    first = _flash_bwd(q, k, v, do, seg, lse, delta, True)
    second = _flash_bwd(q, k, v, do, seg, lse, delta, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _dv_edge_case(seed):
    """chip_smoke.py's flash ``segments`` case (b 4, s 1024, 12 heads of
    64, causal, four packed documents a row at random cut points) drawn
    on the CPU from ``seed``: q, k, v, do and the segment ids on the
    card."""
    g = torch.Generator().manual_seed(seed)
    b, s, h, d = 4, 1024, 12, 64
    q, k, v, do = (torch.randn(b, s, h, d, generator=g)
                   .to(torch.bfloat16).cuda() for _ in range(4))
    cuts = torch.stack([torch.randperm(s - 1, generator=g)[:3].sort()
                        .values + 1 for _ in range(b)])
    seg = torch.searchsorted(cuts, torch.arange(s).repeat(b, 1),
                             right=True).to(torch.int32).cuda()
    return q, k, v, do, seg


def _exact_dv(q, k, do, seg, scale):
    """dV of causal attention within segments, in float64 from the same
    (bf16) inputs, and its mass: (P^T dO, P^T |dO|), P the exact
    softmax."""
    qf, kf, dof = (t.double().transpose(1, 2) for t in (q, k, do))
    s = qf.shape[2]
    keep = (seg[:, None, :, None] == seg[:, None, None, :]) & torch.ones(
        s, s, dtype=torch.bool, device=q.device).tril()
    pt = torch.softmax((qf @ kf.transpose(-1, -2) * scale)
                       .masked_fill(~keep, float("-inf")),
                       dim=-1).transpose(-1, -2)
    return (pt @ dof).transpose(1, 2), (pt @ dof.abs()).transpose(1, 2)


def _dv_excess(x, exact, mass):
    """The largest |x - exact| of bf16 dV values x as a share of what a
    correct bf16 dV may be off: half a bf16 step of x (the last rounding),
    plus p rounded to bf16 before its product (as the plain version and
    the TPU kernel round it; bf16's unit roundoff 2^-8 of P^T |dO|), and
    2^-12 of P^T |dO| more for the fp32 sums and exponentials."""
    _, e = torch.frexp(x.double())
    room = torch.ldexp(torch.ones_like(exact), e - 9) \
        + (2.0 ** -8 + 2.0 ** -12) * mass
    return ((x.double() - exact).abs() / room).max().item()


# a draw of that case on which K2's bf16 dv and the plain version's are a
# bf16 step (0.03125, at |dv| in [4, 8)) apart, more than the bf16 atol
# (the first such seed counting from 0; few draws show it)
DV_EDGE_SEED = 113


@pytest.mark.cuda
def test_flash_bwd_dv_rounding_edge():
    """Where K2's bf16 dv and the plain version's differ by more than
    the bf16 atol, both lie next to the exact gradient: every element of
    each is within its rounding room (``_dv_excess``) of dV computed in
    float64 from the same inputs, so the gap is the two fp32 sums
    rounding to either side of a bf16 edge, not a fault of the kernel;
    where they differ by more than the atol, the exact value lies between
    them."""
    from paddle_tpu_torch.kernels import flash_attention as tfa

    require_cuda()
    q, k, v, do, seg = _dv_edge_case(DV_EDGE_SEED)
    scale = 1.0 / np.sqrt(q.shape[-1])
    out, lse = tfa._launch_fwd(q, k, v, seg, True, scale)
    _, dv = tfa._launch_bwd_kernel("flash_bwd_dkdv", q, k, v, seg, do, lse,
                                   tfa._delta(out, do, None), True, scale)
    want_out, want_lse = tfa.flash_attention_fwd_ref(q, k, v, seg, True,
                                                     scale)
    plain = tfa.flash_attention_bwd_ref(q, k, v, seg, want_out, want_lse,
                                        do, True, scale)[2]
    gap = (dv.double() - plain.double()).abs() > ATOL[torch.bfloat16]
    assert gap.any()
    exact, mass = _exact_dv(q, k, do, seg, scale)
    assert _dv_excess(dv, exact, mass) <= 1.0
    assert _dv_excess(plain, exact, mass) <= 1.0
    lo = torch.minimum(dv, plain).double()[gap]
    hi = torch.maximum(dv, plain).double()[gap]
    assert ((lo < exact[gap]) & (exact[gap] < hi)).all()


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


def _qmm_case(rng, M, N, K, fmt):
    from paddle_tpu_torch.quantization.intx import pack_absmax

    x = (_cuda(rng, (M, K), torch.float32) * (0.5 / np.sqrt(K))) \
        .to(torch.bfloat16)
    wf = _cuda(rng, (N, K), torch.float32)
    amax = wf.abs().amax(dim=1)
    w = pack_absmax(wf, amax[:, None], fmt)
    return x, w, amax / (127.0 if fmt == "int8" else 448.0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("M,N,K", [(17, 33, 1040), (56, 130, 1040),
                                   (65, 130, 1040), (128, 33, 1040),
                                   (129, 130, 1040), (256, 33, 1040),
                                   (300, 130, 1040), (56, 8450, 1040),
                                   (128, 11008, 1040), (129, 11008, 1040),
                                   (300, 4096, 4096)])
def test_quant_matmul_wgmma_body_matches_plain(M, N, K, fmt):
    """K9's wgmma body (bf16, M > 16) at its three token-tile widths, M
    past one 256-token tile, N and K tails, split K (small N) and one
    split with the element-wise store (N % 8 != 0); two launches are
    bit-equal (the split partials are summed in a fixed order)."""
    from paddle_tpu_torch.kernels import quant_matmul as tqm

    require_cuda()
    rng = np.random.RandomState(M + N + K)
    x, w, scale = _qmm_case(rng, M, N, K, fmt)
    tqm.reset_counters()
    got = tqm.quant_matmul(x, w, scale)
    again = tqm.quant_matmul(x, w, scale)
    torch.cuda.synchronize()
    assert dict(tqm.BODY_LAUNCHES) == {"quant_matmul/wgmma": 2}
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    want = tqm.quant_matmul_ref(x, w, scale)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATOL[torch.bfloat16], rtol=0)


# Llama-2-7B's four linear shapes, N past a 16-row unit with K past a
# 64-column step, and one unit of one partial step
GEMV_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096),
               (4100, 4112), (33, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("M", [1, 2, 8, 9, 16])
@pytest.mark.parametrize("N,K", GEMV_SHAPES)
def test_quant_matmul_gemv_body_matches_plain(N, K, M, fmt):
    """K9's bf16 GEMV (M <= 16: one and two n8 tiles of x, partly
    filled) on its cluster plan, against the plain version; two launches
    are bit-equal (warps and ranks sum in a fixed order)."""
    from paddle_tpu_torch.kernels import quant_matmul as tqm

    require_cuda()
    rng = np.random.RandomState(M + N + K)
    x, w, scale = _qmm_case(rng, M, N, K, fmt)
    tqm.reset_counters()
    got = tqm.quant_matmul(x, w, scale)
    again = tqm.quant_matmul(x, w, scale)
    torch.cuda.synchronize()
    assert dict(tqm.BODY_LAUNCHES) == {"quant_matmul/gemv": 2}
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    want = tqm.quant_matmul_ref(x, w, scale)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATOL[torch.bfloat16], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("M,body", [(17, "wgmma"), (8, "gemv")],
                         ids=["wgmma", "gemv"])
def test_quant_matmul_widens_every_byte_like_torch(M, body, fmt):
    """Every int8 byte and every non-NaN e4m3 byte through the wgmma
    body and the GEMV: with x a one-hot row and a unit scale, out[m, n]
    is weight row n's first byte widened, equal to torch's
    .to(torch.bfloat16) (a negative zero comes back as +0: the sum adds
    +0 products)."""
    from paddle_tpu_torch.kernels import quant_matmul as tqm

    require_cuda()
    dtype = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    byte = torch.arange(256, dtype=torch.uint8)
    w = byte[:, None].repeat(1, 64).view(dtype).cuda().contiguous()
    x = torch.zeros(M, 64, dtype=torch.bfloat16, device="cuda")
    x[:, 0] = 1
    tqm.reset_counters()
    got = tqm.quant_matmul(x, w, torch.ones(256, device="cuda"))
    assert dict(tqm.BODY_LAUNCHES) == {f"quant_matmul/{body}": 1}
    want = w[:, 0].to(torch.bfloat16)
    keep = byte.cuda() & 0x7F != 0x7F if fmt == "fp8" \
        else torch.ones(256, dtype=torch.bool, device="cuda")
    assert torch.equal(got[:, keep].float(),
                       want[keep].float()[None].expand(M, -1))


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


# the JAX tests' shapes, odd C and K, a 1x1 image under a 3x3 kernel; then
# a 56-wide 3x3 whose 128-row tiles cross image rows and images, the
# wide-N tile (K >= 256: 3x3, and 1x1 over two column blocks) and a
# 224-wide image (the per-tap mode)
CONV_SHAPES = [((2, 8, 8, 16), 32, 3), ((3, 6, 5, 8), 8, 3),
               ((2, 7, 7, 32), 16, 1), ((2, 4, 4, 6), 8, 3),
               ((8, 1, 1, 64), 64, 3), ((4, 14, 14, 64), 40, 3),
               ((2, 9, 9, 128), 13, 1), ((2, 56, 56, 64), 64, 3),
               ((3, 14, 14, 256), 256, 3), ((2, 7, 7, 512), 512, 1),
               ((1, 4, 224, 64), 64, 3)]
CONV_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,k,kh", CONV_SHAPES)
@pytest.mark.parametrize("variant", ["eval", "eval_relu", "stats", "pre"])
def test_fused_conv_kernels_match_plain(variant, shape, k, kh, dtype,
                                        monkeypatch):
    """K10 (with and without its ReLU) and K11 (with and without its
    prologue) on both bodies (tensor cores for bf16 with C % 8 == 0, in
    its slab and per-tap modes and all three tile widths; plain FMA
    otherwise), odd C and K, a 1x1 image under a 3x3 kernel.
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


@pytest.mark.cuda
@pytest.mark.parametrize("tiles,span,rows,ok", [
    (5, 64, 0, True), (130, 64, 3, True), (130, 16, 9, True),
    (130, 64, 2, False), (130, 64, 0, False), (5, 64, 1, False),
    (5, 0, 0, False)])
def test_conv_stats_finish_checks_its_scratch(tiles, span, rows, ok):
    """The statistics' reduction sums the partials in spans of the
    caller's ``span`` into the caller's ``rows`` scratch rows, and
    refuses (cudaErrorInvalidValue) a scratch that is not
    ceil(tiles / span) rows, or 0 where that is 1."""
    from paddle_tpu_torch.kernels._build import load_library

    require_cuda()
    k, count = 40, tiles * 128
    rng = np.random.RandomState(tiles + span)
    part = torch.from_numpy(rng.rand(2, tiles, k).astype(np.float32)).cuda()
    scratch = torch.empty((2, rows, k), dtype=torch.float32, device="cuda")
    m = torch.empty(k, dtype=torch.float32, device="cuda")
    v = torch.empty_like(m)
    rc = load_library("fused_conv.cu").paddle_conv_stats_finish(
        part.data_ptr(), tiles, k, count, span, rows,
        scratch.data_ptr() if rows else 0, m.data_ptr(), v.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == (0 if ok else 1)
    if ok:
        sums = part.double().sum(1) / count
        torch.testing.assert_close(m.double(), sums[0], atol=0, rtol=1e-5)
        torch.testing.assert_close(
            v.double(), (sums[1] - sums[0] ** 2).clamp_min(0),
            atol=1e-6, rtol=1e-4)



# ---------------------------------------------------------------------------
# flash_decode_mma: every bf16 bundle of q_len >= 2 on the tensor cores
# ---------------------------------------------------------------------------

def _bundle_case(rng, q_len, group, d, fmt, B=3, nb=17, bs=16):
    """A paged bundle over a bf16 or int8/fp8 pool: row 0 ends at the
    table's end (full to max_len), row 1 sits at a random position, row
    2 is a dead slot (zeroed table, pos 0)."""
    KV, N = 2, B * nb + 2
    max_len = nb * bs
    q = _cuda(rng, (B, q_len, KV * group, d), torch.bfloat16)
    if fmt == "bf16":
        kp = _cuda(rng, (N, bs, KV, d), torch.bfloat16)
        vp = _cuda(rng, (N, bs, KV, d), torch.bfloat16)
        scales = {}
    else:
        kp, ks = _quantized(_cuda(rng, (N, bs, KV, d), torch.float32), fmt)
        vp, vs = _quantized(_cuda(rng, (N, bs, KV, d), torch.float32), fmt)
        scales = dict(k_scale=ks, v_scale=vs)
    bt_np = (rng.permutation(N - 1)[:B * nb] + 1).reshape(B, nb)
    bt_np[2] = 0
    bt = torch.tensor(bt_np, dtype=torch.int32, device="cuda")
    pos = torch.tensor([max_len - q_len, rng.randint(0, max_len - q_len + 1),
                        0], dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, pos, scales


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("q_len", [2, 5, 7, 16, 17, 29, 33, 200, 256])
def test_mma_body_matches_plain(q_len, group, d, fmt):
    """The tensor-core body (small tiles up to 16 rows, wide tiles past
    them, the 64- and 128-row edges) over paged bf16/int8/fp8 pools
    against the plain version, and the contiguous cache (K4/K5) at the
    same bundle."""
    require_cuda()
    rng = np.random.RandomState(500 + q_len * 7 + group + d + len(fmt))
    q, kp, vp, bt, pos, scales = _bundle_case(rng, q_len, group, d, fmt)
    tda.reset_counters()
    got = tda.paged_flash_decode_attention(q, kp, vp, bt, pos, **scales)
    torch.cuda.synchronize()
    name = "paged_flash_decode_attention" + ("_quant" if scales else "")
    assert dict(tda.BODY_LAUNCHES) == {f"{name}/mma": 1}
    want = tda.paged_flash_decode_attention_ref(q, kp, vp, bt, pos,
                                                **scales)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    if q_len <= 33 and group == 4:
        # the same bundle over the rows' caches laid out contiguously
        kc, vc = tda._take_blocks(kp, bt), tda._take_blocks(vp, bt)
        cs = {k: tda._take_blocks(s, bt) for k, s in scales.items()}
        tda.reset_counters()
        got = tda.flash_decode_attention(q, kc.contiguous(), vc.contiguous(),
                                         pos, **{k: s.contiguous()
                                                 for k, s in cs.items()})
        torch.cuda.synchronize()
        cname = "flash_decode_attention" + ("_quant" if scales else "")
        assert dict(tda.BODY_LAUNCHES) == {f"{cname}/mma": 1}
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=0)


def _random_ancestors(rng, B, w):
    """A random [B, w, w] mask: each node sees itself and a random subset
    of the others (not a tree: any pattern is legal)."""
    m = rng.rand(B, w, w) < 0.4
    m[:, np.arange(w), np.arange(w)] = True
    return torch.from_numpy(m).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind,group", [("[4,2,2]", 1), ("[4,2,2]", 4),
                                        ("random 40", 1), ("random 40", 4),
                                        ("random 9", 8)])
def test_mma_body_ancestor_masks(kind, group, d, fmt):
    """K8 through the tensor-core body: the [4, 2, 2] tree and random
    ancestor masks (two mask words at 40 nodes) against the plain
    version."""
    require_cuda()
    rng = np.random.RandomState(600 + group + d + len(kind) + len(fmt))
    if kind.startswith("random"):
        mask = _random_ancestors(rng, 3, int(kind.split()[1]))
    else:
        mask = _tree_mask([4, 2, 2], 3)
    w = mask.shape[1]
    q, kp, vp, bt, pos, scales = _bundle_case(rng, w, group, d, fmt)
    tda.reset_counters()
    got = tda.paged_flash_decode_attention(q, kp, vp, bt, pos,
                                           ancestor_mask=mask, **scales)
    torch.cuda.synchronize()
    name = "paged_flash_decode_attention_tree" + ("_quant" if scales else "")
    assert dict(tda.BODY_LAUNCHES) == {f"{name}/mma": 1}
    want = tda.paged_flash_decode_attention_ref(q, kp, vp, bt, pos,
                                                ancestor_mask=mask, **scales)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("q_len", [2, 5, 7, 17, 29, 256])
def test_mma_causal_mask_is_bitwise_default(q_len, group, fmt):
    """A causal ancestor mask through the tensor-core body gives the
    maskless output bit for bit: the masked launch scans keys past the
    causal edge, and they must leave m, l and acc unchanged."""
    require_cuda()
    rng = np.random.RandomState(700 + q_len + group)
    q, kp, vp, bt, pos, scales = _bundle_case(rng, q_len, group, 128, fmt)
    causal = torch.ones(q_len, q_len, dtype=torch.bool,
                        device="cuda").tril()[None].expand(3, -1, -1)
    got = tda.paged_flash_decode_attention(q, kp, vp, bt, pos,
                                           ancestor_mask=causal, **scales)
    want = tda.paged_flash_decode_attention(q, kp, vp, bt, pos, **scales)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# flash_decode_qrows: the bf16 decode step over int8/fp8 K/V (K5, K7)
# ---------------------------------------------------------------------------

def _kv(rng, shape, fmt):
    """A cache or pool of ``shape`` in bf16 (scales None) or quantized
    int8/fp8 with its scales."""
    if fmt == "bf16":
        return _cuda(rng, shape, torch.bfloat16), None
    return _quantized(_cuda(rng, shape, torch.float32), fmt)


def _qrows_case(rng, lens, group, d, fmt, paged, KV=2, nb=40, bs=16):
    """A decode step (q_len 1) of len(lens) rows whose caches hold
    ``lens`` tokens, over a contiguous bf16/int8/fp8 cache or a paged
    pool. The pool's table points every unused column at block 0 and row
    1's first column at block 0 too (a real block, shared by no other
    row)."""
    B, max_len = len(lens), nb * bs
    q = _cuda(rng, (B, 1, KV * group, d), torch.bfloat16)
    pos = torch.tensor([n - 1 for n in lens], dtype=torch.int32,
                       device="cuda")
    if not paged:
        k, ks = _kv(rng, (B, max_len, KV, d), fmt)
        v, vs = _kv(rng, (B, max_len, KV, d), fmt)
        return q, k, v, ks, vs, None, pos
    N = B * nb + 1
    k, ks = _kv(rng, (N, bs, KV, d), fmt)
    v, vs = _kv(rng, (N, bs, KV, d), fmt)
    bt_np = (rng.permutation(N - 1)[:B * nb] + 1).reshape(B, nb)
    for i, n in enumerate(lens):
        bt_np[i, -(-n // bs):] = 0
    bt_np[1, 0] = 0
    bt = torch.tensor(bt_np, dtype=torch.int32, device="cuda")
    return q, k, v, ks, vs, bt, pos


def _qrows_run(q, k, v, ks, vs, bt, pos, **kw):
    """The kernel (BODY_LAUNCHES counted from zero) and the plain
    version."""
    tda.reset_counters()
    sfx = "" if ks is None else "_quant"
    if bt is None:
        got = tda.flash_decode_attention(q, k, v, pos, k_scale=ks,
                                         v_scale=vs)
        want = tda.flash_decode_attention_ref(q, k, v, pos, k_scale=ks,
                                              v_scale=vs)
        name = "flash_decode_attention" + sfx
    else:
        got = tda.paged_flash_decode_attention(q, k, v, bt, pos, k_scale=ks,
                                               v_scale=vs, **kw)
        want = tda.paged_flash_decode_attention_ref(q, k, v, bt, pos,
                                                    k_scale=ks, v_scale=vs,
                                                    **kw)
        name = "paged_flash_decode_attention" + (
            "_tree" if kw else "") + sfx
    torch.cuda.synchronize()
    assert dict(tda.BODY_LAUNCHES) == {f"{name}/qrows": 1}
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("paged,bs", [(False, 16), (True, 16), (True, 1),
                                      (True, 12), (True, 24)],
                         ids=["K5", "K7", "K7-bs1", "K7-bs12", "K7-bs24"])
def test_qrows_body_matches_plain(paged, bs, group, d, fmt):
    """The decode step over int8/fp8 K/V (K5, K7) and bf16 K/V (K4, K6
    under the same ids) at every group the body holds:
    rows of 1, 15, 16, 17 keys, a split boundary -1, 0, +1 (the plan's
    split at this shape) and max_len, against the plain version. K7 also
    over pages of 1, 12 and 24 tokens (the body finds a key's page by a
    multiply-high, exact for a power of two and, for any other size,
    within the bound the launch checks)."""
    require_cuda()
    rng = np.random.RandomState(800 + 10 * group + d + len(fmt) + paged
                                + (0 if bs == 16 else 1000 + bs))
    nb, KV = 640 // bs, 2
    plan = tda.launch_plan(1, group, torch.bfloat16, 8, KV, nb * bs,
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count, fmt)
    assert plan["body"] == "qrows" and plan["n_split"] > 1
    cut = plan["split_keys"]
    lens = [1, 15, 16, 17, cut - 1, cut, cut + 1, nb * bs]
    got, want = _qrows_run(*_qrows_case(rng, lens, group, d, fmt, paged,
                                        KV, nb, bs))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["K5", "K7"])
def test_qrows_body_at_the_serving_shape(paged, group, fmt):
    """Llama-2-7B's decode step (B 8, 32 heads of 128, max_len 2048):
    long splits (many steps a warp), a split boundary +-1, a full row
    and a one-key row, against the plain version."""
    require_cuda()
    rng = np.random.RandomState(900 + group + len(fmt) + paged)
    nb, bs, KV = 128, 16, 32 // group
    cut = tda.launch_plan(1, group, torch.bfloat16, 8, KV, nb * bs,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count, fmt)["split_keys"]
    lens = [nb * bs, 1, cut - 1, cut, cut + 1, 1000, 1777, 2 * cut + 3]
    got, want = _qrows_run(*_qrows_case(rng, lens, group, 128, fmt, paged,
                                        KV, nb, bs))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


# scales on both sides of div_bound's range (csrc/div_bound.cuh
# exact_scale: 0 and [2^-80, 2^90]); the ones outside take the IEEE
# division
QROWS_SCALES = {"inside": [1.0, 3.7, 1e-3, 250.0, 2.0 ** -80, 2.0 ** 90, 0.0,
                           0.1234567],
                "outside": [2.0 ** -85, 2.0 ** -100, 2.0 ** 95, 1.0, 0.5,
                            2.0 ** -81, 2.0 ** 91, 7.0]}


@pytest.mark.cuda
@pytest.mark.parametrize("scales", ["inside", "outside"])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("paged", [False, True], ids=["K5", "K7"])
def test_qrows_one_key_is_the_dequantized_row(paged, fmt, group, scales):
    """One visible key: p = 1 and l = 1, so the output is the key's V row
    dequantized, bit for bit: every storage byte (fp8's two NaN codes
    aside) in the V rows, at scales inside and outside div_bound's range,
    against f32(q) * s / bound rounded to bf16 on the CPU (the JAX
    prologue, unclamped; unpack_absmax too where s >= 1e-9)."""
    from paddle_tpu_torch.quantization.intx import (div_exact, format_bound,
                                                    format_dtype,
                                                    unpack_absmax)

    require_cuda()
    rng = np.random.RandomState(1000 + len(fmt) + paged)
    B, KV, d, bs, nb = 4, 2, 128, 16, 4
    dt = format_dtype(fmt)
    codes = torch.arange(B * KV * d) % 256
    if fmt == "fp8":
        codes[(codes & 0x7F) == 0x7F] = 0
    vrow = codes.to(torch.uint8).view(dt).reshape(B, KV, d)
    s = torch.tensor(QROWS_SCALES[scales], dtype=torch.float32) \
        .reshape(B, KV)
    q = _cuda(rng, (B, 1, KV * group, d), torch.bfloat16)
    pos = torch.zeros(B, dtype=torch.int32, device="cuda")
    if paged:
        N = B * nb + 1
        v = _quantized(_cuda(rng, (N, bs, KV, d), torch.float32), fmt)[0]
        vs = torch.rand(N, bs, KV, device="cuda") + 0.5
        bt = torch.arange(1, N, dtype=torch.int32,
                          device="cuda").reshape(B, nb)
        first = bt[:, 0].long()
        v.view(torch.uint8)[first, 0] = vrow.view(torch.uint8).cuda()
        vs[first, 0] = s.cuda()
    else:
        v = _quantized(_cuda(rng, (B, nb * bs, KV, d), torch.float32),
                       fmt)[0]
        vs = torch.rand(B, nb * bs, KV, device="cuda") + 0.5
        v.view(torch.uint8)[:, 0] = vrow.view(torch.uint8).cuda()
        vs[:, 0] = s.cuda()
        bt = None
    k, ks = v.clone(), vs.clone()
    got, _ = _qrows_run(q, k, v, ks, vs, bt, pos)
    rows = div_exact(vrow.float() * s[..., None], format_bound(fmt)) \
        .to(torch.bfloat16)                                   # [B, KV, d]
    want = rows.repeat_interleave(group, dim=1)[:, None]      # [B, 1, H, d]
    assert torch.equal(got.cpu(), want)
    ok = s >= 1e-9
    ref = unpack_absmax(vrow, s[..., None], fmt, torch.bfloat16)
    assert torch.equal(ref[ok], rows[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_qrows_masked_decode_step(group, fmt):
    """A q_len 1 bundle under an ancestor mask (a draft tree's root level)
    runs the same body's MASKED instantiation: with the node visible to
    itself it equals the maskless step bit for bit and the plain
    version."""
    require_cuda()
    rng = np.random.RandomState(1100 + group + len(fmt))
    case = _qrows_case(rng, [1, 17, 300, 640, 64, 65, 2, 500], group, 128,
                       fmt, True)
    mask = torch.ones(8, 1, 1, dtype=torch.bool, device="cuda")
    got, want = _qrows_run(*case, ancestor_mask=mask)
    plain, _ = _qrows_run(*case)
    assert torch.equal(got, plain)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("paged,bs", [(False, 16), (True, 16), (True, 12)],
                         ids=["K4", "K6", "K6-bs12"])
def test_qrows_bf16_one_key_and_dead_rows(paged, bs, group):
    """The bf16 decode step where a row sees one key (p = 1, l = 1: the
    output is that key's V row, bit for bit), where a row is empty (no
    key: zeros) and, paged, where a dead slot's table is all zeros (it
    reads block 0 and agrees with the plain version)."""
    require_cuda()
    rng = np.random.RandomState(1200 + group + paged + bs)
    KV, d, nb = 2, 128, 240 // bs
    q, k, v, ks, vs, bt, pos = _qrows_case(rng, [1, 1, 1, 1, 9, 200, 0],
                                           group, d, "bf16", paged, KV, nb,
                                           bs)
    if paged:
        bt[5] = 0
    got, want = _qrows_run(q, k, v, ks, vs, bt, pos)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    first = v[bt[:4, 0].long(), 0] if paged else v[:4, 0]   # [4, KV, d]
    assert torch.equal(got[:4, 0],
                       first.repeat_interleave(group, dim=1))
    assert not got[6].any()


_DIV_CHECK = r"""
#include "div_bound.cuh"
// every float32 bit pattern where the dequant uses div_bound (x = 0 or
// |x| in [2^-90, 2^100]) against the IEEE division; counts mismatches
template <typename S>
__global__ void check(unsigned long long* bad, unsigned long long base) {
  const unsigned long long i =
      base + blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
  const float x = __uint_as_float((unsigned)i);
  const float ax = fabsf(x);
  if (!(ax == 0.f || (ax >= 0x1p-90f && ax <= 0x1p100f))) return;
  const float y = std::is_same<S, int8_t>::value ? 127.f : 448.f;
  if (__float_as_uint(div_bound<S>(x)) != __float_as_uint(__fdiv_rn(x, y)))
    atomicAdd(bad, 1ull);
}
extern "C" int run(int fp8, unsigned long long* host) {
  unsigned long long* d;
  cudaMalloc(&d, sizeof(unsigned long long));
  cudaMemset(d, 0, sizeof(unsigned long long));
  for (unsigned long long base = 0; base < (1ull << 32); base += 1ull << 30) {
    if (fp8) check<__nv_fp8_e4m3><<<(1u << 30) / 256, 256>>>(d, base);
    else check<int8_t><<<(1u << 30) / 256, 256>>>(d, base);
  }
  cudaMemcpy(host, d, sizeof(unsigned long long), cudaMemcpyDeviceToHost);
  cudaFree(d);
  return (int)cudaGetLastError();
}
"""


@pytest.mark.cuda
def test_div_bound_matches_ieee_division_everywhere(tmp_path):
    """``csrc/div_bound.cuh``, the tensor-core body's division by 127 and
    448, compiled for the card and run over all 2^32 float32 inputs of
    its range: bit for bit the IEEE division."""
    import ctypes
    import subprocess

    from paddle_tpu_torch.kernels import _build

    require_cuda()
    src, lib = tmp_path / "div_check.cu", tmp_path / "libdiv_check.so"
    src.write_text(_DIV_CHECK)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", _build._CSRC, "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).run
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    for fp8 in (0, 1):
        bad = ctypes.c_ulonglong(0)
        assert fn(fp8, ctypes.addressof(bad)) == 0
        assert bad.value == 0, ("fp8" if fp8 else "int8", bad.value)


# ---------------------------------------------------------------------------
# sampling: the same code on the card and on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_prng_chain_on_the_card_equals_the_cpu(seed):
    """Keys, splits, fold_in, bits and uniforms are integer work: equal
    bit for bit; Gumbel draws within 2 ulp of max(|g|, 1)."""
    require_cuda()
    from paddle_tpu_torch import prng

    keys = {}
    for dev in ("cpu", "cuda"):
        k, chain = prng.PRNGKey(seed, dev), []
        for i in range(64):
            k, sub = prng.split(k).unbind(0)
            chain += [k, sub, prng.fold_in(k, i)]
        keys[dev] = torch.stack(chain).cpu()
    assert torch.equal(keys["cpu"], keys["cuda"])
    k = prng.PRNGKey(seed)
    for dtype in (torch.float32, torch.bfloat16):
        u = prng.uniform(k, (8, 32000), dtype)
        ug = prng.uniform(k.cuda(), (8, 32000), dtype).cpu()
        assert torch.equal(u.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                           ug.view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32))
        g = prng.gumbel(k, (8, 32000), dtype).float()
        gg = prng.gumbel(k.cuda(), (8, 32000), dtype).cpu().float()
        ulp = torch.from_numpy(np.spacing(
            np.maximum(g.abs().numpy(), 1.0).astype(np.float32)))
        if dtype == torch.bfloat16:
            ulp = ulp * 2.0 ** 16
        assert bool(((g - gg).abs() <= 2 * ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_select_tokens_on_the_card_equals_the_cpu(dtype):
    """The grid of temperature x top_k x top_p with greedy rows mixed in,
    over Llama-2-7B's vocabulary, integer logits tied across the 256th
    value, and the static selector of plain ``generate``: equal
    tokens."""
    require_cuda()
    import itertools

    from paddle_tpu_torch import generation as tgen
    from paddle_tpu_torch import prng

    V = 32000
    grid = list(itertools.product([0.7, 1.0, 1.3], [0, 1, 40, 256, 257, V],
                                  [1.0, 0.9, 0.5]))
    B = len(grid) + 4
    rng = np.random.RandomState(12)
    logits = torch.from_numpy((rng.randn(B, V) * 3).astype(np.float32)) \
        .to(dtype)
    ds = torch.tensor([True] * len(grid) + [False] * 4)
    temp = torch.tensor([g[0] for g in grid] + [1.0] * 4)
    tk = torch.tensor([g[1] for g in grid] + [0] * 4)
    tp = torch.tensor([g[2] for g in grid] + [1.0] * 4)
    keys = prng.fold_in(prng.PRNGKey(3), torch.arange(B))
    args = (ds, temp, tk, tp)
    want = tgen.select_tokens(logits, keys, *args)
    got = tgen.select_tokens(logits.cuda(), keys.cuda(),
                             *(a.cuda() for a in args)).cpu()
    assert torch.equal(got, want)
    # integer logits tied across the 256th value
    tie = torch.from_numpy(np.round(rng.randn(6, V) * 2).astype(np.float32)) \
        .to(dtype)
    sub = (tie, keys[:6], torch.ones(6, dtype=torch.bool), torch.ones(6),
           torch.tensor([256, 256, 250, 256, 200, 256]),
           torch.tensor([0.9, 0.99, 0.5, 1.0, 0.95, 0.999]))
    want = tgen.select_tokens(*sub)
    got = tgen.select_tokens(*(a.cuda() for a in sub)).cpu()
    assert torch.equal(got, want)
    cfg = tgen.GenerationConfig(do_sample=True, temperature=0.8, top_k=40,
                                top_p=0.9)
    k = prng.PRNGKey(9)
    assert torch.equal(tgen._select_token(logits[:8], cfg, k),
                       tgen._select_token(logits[:8].cuda(), cfg,
                                          k.cuda()).cpu())


# GPT-3 1.3B's decode shapes: 16 heads of 128 (group 1), B 8 at the first
# eight row lengths of chip_smoke.py's served traffic, 2048 positions
GPT_LENS = [1500, 530, 1480, 1400, 1350, 1300, 1100, 700]
GPT_HEADS, GPT_BLOCKS = 16, 128


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["K4-K5", "K6-K7"])
def test_gpt_decode_step_matches_plain(paged, fmt):
    """The decode step at GPT-3 1.3B's shape (bf16 queries over bf16 or
    int8 K/V, contiguous and paged) on ``flash_decode_qrows``, against
    the plain version."""
    require_cuda()
    rng = np.random.RandomState(1300 + paged + len(fmt))
    got, want = _qrows_run(*_qrows_case(rng, GPT_LENS, 1, 128, fmt, paged,
                                        GPT_HEADS, GPT_BLOCKS, 16))
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("factors", [None, [2, 2]], ids=["chunk", "tree"])
def test_gpt_bundles_match_plain(factors, fmt):
    """GPT-3 1.3B's 256-token prefill chunk (K6/K7) and [2, 2] verify
    bundle over B 8 rows (K8) on the tensor-core body, 16 heads of 128,
    bf16 and int8 pools, against the plain version."""
    require_cuda()
    rng = np.random.RandomState(1310 + len(fmt) + (factors is None))
    B, bs, N = (1, 16, GPT_BLOCKS + 1) if factors is None \
        else (8, 16, 8 * GPT_BLOCKS + 1)
    w = 256 if factors is None else 7
    q = _cuda(rng, (B, w, GPT_HEADS, 128), torch.bfloat16)
    kp, ks = _kv(rng, (N, bs, GPT_HEADS, 128), fmt)
    vp, vs = _kv(rng, (N, bs, GPT_HEADS, 128), fmt)
    scales = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    bt = torch.tensor((rng.permutation(N - 1)[:B * GPT_BLOCKS] + 1)
                      .reshape(B, GPT_BLOCKS), dtype=torch.int32,
                      device="cuda")
    pos = torch.tensor([1280] if factors is None else GPT_LENS,
                       dtype=torch.int32, device="cuda")
    mask = None if factors is None else _tree_mask(factors, B)
    tda.reset_counters()
    got = tda.paged_flash_decode_attention(q, kp, vp, bt, pos,
                                           ancestor_mask=mask, **scales)
    torch.cuda.synchronize()
    name = "paged_flash_decode_attention" + ("" if mask is None else "_tree") \
        + ("_quant" if scales else "")
    assert dict(tda.BODY_LAUNCHES) == {f"{name}/mma": 1}
    want = tda.paged_flash_decode_attention_ref(q, kp, vp, bt, pos,
                                                ancestor_mask=mask, **scales)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("M", [8, 256])
@pytest.mark.parametrize("N,K", [(2048, 2048), (8192, 2048), (2048, 8192),
                                 (50304, 2048)])
def test_gpt_quant_matmul_matches_plain(N, K, M, fmt):
    """K9 at GPT-3 1.3B's four linear shapes, a decode step (M 8, the
    GEMV) and a prefill chunk (M 256, the wgmma body), against the plain
    version."""
    from paddle_tpu_torch.kernels import quant_matmul as tqm

    require_cuda()
    rng = np.random.RandomState(M + N + K + len(fmt))
    x, w, scale = _qmm_case(rng, M, N, K, fmt)
    tqm.reset_counters()
    got = tqm.quant_matmul(x, w, scale)
    torch.cuda.synchronize()
    body = "gemv" if M <= 16 else "wgmma"
    assert dict(tqm.BODY_LAUNCHES) == {f"quant_matmul/{body}": 1}
    want = tqm.quant_matmul_ref(x, w, scale)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATOL[torch.bfloat16], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("M", [8, 256])
def test_weight_only_linear_with_bias_on_the_card(M, fmt):
    """A biased weight-only linear (GPT's q_proj at 2048 x 2048, bf16):
    K9, then the bias in x's dtype. The card's output is the kernel's
    unbiased output plus the bias bit for bit, and within the bf16 atol
    of the plain product plus the bias."""
    from paddle_tpu_torch.kernels import quant_matmul as tqm
    from paddle_tpu_torch.nn.quant import weight_only_linear

    require_cuda()
    rng = np.random.RandomState(1320 + M + len(fmt))
    x, w, scale = _qmm_case(rng, M, 2048, 2048, fmt)
    bias = (_cuda(rng, (2048,), torch.float32) * 0.1).to(torch.bfloat16)
    tqm.reset_counters()
    with torch.no_grad():      # the kernel is forward-only
        got = weight_only_linear(x, w, bias, scale, weight_dtype=fmt)
        bare = weight_only_linear(x, w, None, scale, weight_dtype=fmt)
    torch.cuda.synchronize()
    assert tqm.LAUNCHES["quant_matmul"] == 2
    assert torch.equal(got, bare + bias)
    want = tqm.quant_matmul_ref(x, w, scale) + bias
    torch.testing.assert_close(got.float(), want.float(),
                               atol=ATOL[torch.bfloat16], rtol=0)


@pytest.mark.cuda
def test_started_engine_on_the_card_equals_run_until_idle():
    """A small bf16 Llama engine on the card (head_dim 64, the paged
    kernel's path), warmed up then started: its tokens equal a
    synchronous engine's bit for bit, a second ``warmup()`` builds
    nothing, and the loop thread, whose grad mode is on as in any new
    thread, builds no autograd graph in any program it runs."""
    require_cuda()
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    torch.manual_seed(0)
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16).eval()
    rng = np.random.RandomState(14)
    prompts = [rng.randint(1, cfg.vocab_size, n) for n in (5, 40, 70, 9)]
    params = [dict(max_new_tokens=12), dict(max_new_tokens=20),
              dict(max_new_tokens=9, do_sample=True, top_k=20, seed=4),
              dict(max_new_tokens=15)]
    kw = dict(max_slots=2, max_len=128, block_size=16, prefill_chunk=32)
    sync = ServingEngine(model, device="cuda", **kw)
    reqs = [sync.submit(p, **pk) for p, pk in zip(prompts, params)]
    sync.run_until_idle()
    want = [r.output_tokens for r in reqs]

    eng = ServingEngine(model, device="cuda", **kw)
    tda.reset_counters()
    info = eng.warmup()
    assert info["entries"] == ["serving.prefill_chunk", "serving.cow",
                               "serving.step"]
    # one chunk and one step a layer, each on its kernel body
    L = cfg.num_hidden_layers
    assert tda.LAUNCHES["paged_flash_decode_attention"] == 2 * L
    assert eng.warmup()["compiles"] == 0
    seen = []
    for name in ("_chunk", "_step"):
        orig = getattr(eng, name)

        def spy(*a, _orig=orig, _name=name, **k):
            out = _orig(*a, **k)
            seen.append((_name, torch.is_grad_enabled(), out is not None
                         and out.requires_grad,
                         eng._pos.requires_grad, eng._tokens.requires_grad))
            return out

        setattr(eng, name, spy)
    reqs = [eng.submit(p, **pk) for p, pk in zip(prompts, params)]
    eng.start()
    got = [r.result(timeout=120) for r in reqs]
    eng.stop()
    assert got == want
    assert {s[0] for s in seen} == {"_chunk", "_step"}
    assert not any(any(s[1:]) for s in seen), seen
    assert eng.health()[1]["status"] == "stopped"


@pytest.mark.cuda
@pytest.mark.parametrize("crash_at", [3, 8])
def test_router_over_supervised_engines_on_the_card(crash_at):
    """Two supervised small Llama engines on the card behind a
    ``Router``, r0's engine crashed once mid-traffic and restarted by its
    supervisor: every request's tokens equal ``run_until_idle`` on one
    engine, and K6 launched exactly layers x (decode steps + prefill
    chunks) of every engine that lived plus one chunk and one step a
    layer for each warmup. fp32: the restart replays the generated
    tokens through prefill chunks, whose K/V round differently from the
    decode steps' in bf16 (``chip_smoke.py``'s bf16 ``router_serve``
    restart reports its equality; its fp32 part asserts it)."""
    require_cuda()
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (EngineSupervisor, LocalReplica,
                                          Router, RouterConfig,
                                          ServingEngine, SupervisedChaos)

    torch.manual_seed(0)
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.float32).eval()
    rng = np.random.RandomState(15)
    prompts = [rng.randint(1, cfg.vocab_size, n) for n in (5, 40, 70, 9, 33,
                                                            17)]
    params = [dict(max_new_tokens=12), dict(max_new_tokens=20),
              dict(max_new_tokens=9, do_sample=True, top_k=20, seed=4),
              dict(max_new_tokens=15), dict(max_new_tokens=16),
              dict(max_new_tokens=10)]
    kw = dict(max_slots=2, max_len=128, block_size=16, prefill_chunk=32)
    sync = ServingEngine(model, device="cuda", **kw)
    reqs = [sync.submit(p, **pk) for p, pk in zip(prompts, params)]
    sync.run_until_idle()
    want = [r.output_tokens for r in reqs]

    engines = []
    sups = [EngineSupervisor(model, device="cuda", **kw) for _ in range(2)]
    for s in sups:
        engines.append(s.engine)
        s.add_rebuild_hook(engines.append)
    tda.reset_counters()
    router = Router([LocalReplica(s, f"r{i}") for i, s in enumerate(sups)],
                    RouterConfig(seed=0))
    try:
        # armed just before the traffic: an idle loop steps too
        chaos = SupervisedChaos(sups[0])
        chaos.current.crash_after_steps(crash_at)
        rrs = [router.submit(p, **pk) for p, pk in zip(prompts, params)]
        got = [rr.result(timeout=120) for rr in rrs]
        assert got == want
        assert chaos.injected["crash"] == 1 and sups[0].restarts == 1
        assert all(rr.retries == 0 for rr in rrs)
    finally:
        router.stop(drain=True, timeout_s=60)
    L = cfg.num_hidden_layers
    steps = sum(e.stats()["steps"] for e in engines)
    chunks = sum(e.stats()["prefill_chunks"] for e in engines)
    warm = sum(e.warmed_up for e in engines)
    assert (len(engines), warm) == (3, 3)
    assert tda.LAUNCHES["paged_flash_decode_attention"] == \
        L * (steps + chunks + 2 * warm)
    assert engines[0]._pools == []  # the dead engine's pools went
