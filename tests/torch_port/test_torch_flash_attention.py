"""Flash-attention parity: the port's ``flash_attention`` family, through
its plain PyTorch versions on the CPU, against the JAX package's Pallas
kernels (interpret mode on the CPU, as the JAX suite runs them). Same
seeded numpy inputs, fp32; out, LSE and dq/dk/dv (``jax.vjp`` against
torch autograd) agree at atol 1e-5. The CUDA kernels run only on a GPU
(``test_torch_kernels_cuda.py`` and ``chip_smoke.py``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the package re-exports the function under the module's name
jfa = importlib.import_module("paddle_tpu.pallas_kernels.flash_attention")

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models.llama import repeat_kv

ATOL = 1e-5
# small JAX blocks so its kernels walk several tiles (the port's plain
# version takes whole rows)
BLOCK = 16


def _inputs(seed, b, s, h, d, kv_heads=None):
    rng = np.random.RandomState(seed)
    kvh = kv_heads or h
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, kvh, d).astype(np.float32)
    v = rng.randn(b, s, kvh, d).astype(np.float32)
    do = rng.randn(b, s, h, d).astype(np.float32)
    return q, k, v, do


def _jax_vjp(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (out,) + vjp(jnp.asarray(do))]


def _torch_vjp(fn, q, k, v, do):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _assert_all(got, want):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(causal):
    q, k, v, do = _inputs(1 + causal, 2, 48, 2, 16)
    want = _jax_vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, block_q=BLOCK, block_k=BLOCK), q, k, v, do)
    got = _torch_vjp(lambda a, b, c: tfa.flash_attention(
        a, b, c, causal=causal), q, k, v, do)
    _assert_all(got, want)


def test_non_dividing_length_matches_jax():
    q, k, v, do = _inputs(3, 1, 50, 2, 16)
    want = _jax_vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=True, block_q=BLOCK, block_k=BLOCK), q, k, v, do)
    got = _torch_vjp(lambda a, b, c: tfa.flash_attention(a, b, c), q, k, v,
                     do)
    _assert_all(got, want)


def test_segment_ids_match_jax():
    q, k, v, do = _inputs(4, 2, 48, 2, 16)
    seg = np.array([[0] * 10 + [1] * 22 + [2] * 16,
                    [0] * 30 + [1] * 18], np.int32)
    want = _jax_vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=True, block_q=BLOCK, block_k=BLOCK,
        segment_ids=seg), q, k, v, do)
    got = _torch_vjp(lambda a, b, c: tfa.flash_attention(
        a, b, c, segment_ids=torch.from_numpy(seg)), q, k, v, do)
    _assert_all(got, want)


def test_varlen_matches_jax():
    q, k, v, do = (x[0] for x in _inputs(5, 1, 40, 2, 16))
    cu = np.array([0, 13, 29, 40], np.int32)
    want = _jax_vjp(lambda a, b, c: jfa.flash_attn_varlen(
        a, b, c, cu, block_q=BLOCK, block_k=BLOCK), q, k, v, do)
    got = _torch_vjp(lambda a, b, c: tfa.flash_attn_varlen(
        a, b, c, torch.from_numpy(cu)), q, k, v, do)
    _assert_all(got, want)


def test_gqa_through_repeat_kv_matches_jax():
    q, k, v, do = _inputs(6, 1, 32, 4, 16, kv_heads=2)
    want = _jax_vjp(lambda a, b, c: jfa.flash_attention(
        a, jnp.repeat(b, 2, axis=2), jnp.repeat(c, 2, axis=2),
        block_q=BLOCK, block_k=BLOCK), q, k, v, do)
    got = _torch_vjp(lambda a, b, c: tfa.flash_attention(
        a, repeat_kv(b, 2), repeat_kv(c, 2)), q, k, v, do)
    _assert_all(got, want)


def test_lse_and_its_cotangent_match_jax():
    b, s, h, d = 1, 32, 2, 16
    q, k, v, do = _inputs(7, b, s, h, d)
    dlse = np.random.RandomState(8).randn(b, h, s).astype(np.float32)
    scale = 1.0 / np.sqrt(d)

    def bh(x):
        return jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(b * h, s, d)

    (jo, jl), vjp = jax.vjp(
        lambda a, b_, c: jfa._flash_lse(a, b_, c, None, True, scale, BLOCK,
                                        BLOCK), bh(q), bh(k), bh(v))
    jgrads = vjp((bh(do), jnp.asarray(dlse.reshape(b * h, s))))

    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out, lse = tfa.flash_attention_lse(*ts, causal=True)
    torch.autograd.backward([out, lse], [torch.from_numpy(do),
                                         torch.from_numpy(dlse)])
    np.testing.assert_allclose(out.detach().transpose(1, 2).reshape(
        b * h, s, d).numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.detach().reshape(b * h, s).numpy(),
                               np.asarray(jl), atol=ATOL, rtol=0)
    for t, jg, name in zip(ts, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.grad.transpose(1, 2).reshape(
            b * h, s, d).numpy(), np.asarray(jg), atol=ATOL, rtol=0,
            err_msg=name)


def test_other_devices_are_refused():
    """The wrapper picks the plain version by the tensor's device alone:
    a device that is neither the CPU nor CUDA is refused, not computed."""
    q = torch.zeros(1, 4, 1, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(q, q, q)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check(q, q, q, None)
    with pytest.raises(ValueError, match="repeat_kv"):
        tfa._check(q[..., :32], q[:, :, :1, :32], q[:, :, :1, :32], None)
    with pytest.raises(TypeError, match="bfloat16"):
        h = q[..., :32].half()
        tfa._check(h, h, h, None)


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "simt")])
def test_forward_body_routing(dtype, body):
    """K1's body by dtype: the wgmma body serves bf16 at every head_dim
    (32 computed as 64 zero-filled columns), plain FMA fp32."""
    assert tfa.fwd_body(dtype) == body


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "simt")])
def test_backward_body_routing(dtype, body):
    """K2's and K3's body by dtype: the wgmma bodies serve bf16 at every
    head_dim (the item's own tiles from shared memory at 128), plain FMA
    fp32."""
    assert tfa.bwd_body(dtype) == body


def test_cpu_backward_counts_no_launch():
    """On the CPU the backward runs the plain version: no kernel and no
    body is counted."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 16, 2, 32).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    tfa.reset_counters()
    tfa.flash_attention(q, k, v).sum().backward()
    assert all(n == 0 for n in tfa.LAUNCHES.values())
    assert not tfa.BODY_LAUNCHES
    assert q.grad is not None and torch.isfinite(q.grad).all()
