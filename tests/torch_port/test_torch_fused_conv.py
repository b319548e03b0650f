"""The port's fused conv kernels (plain versions, on the CPU) against the
JAX package's (``paddle_tpu/pallas_kernels/fused_conv.py``, its Pallas
kernels in interpret mode): K10 ``fused_conv_bn_eval``, K11
``conv_stats`` / ``conv_stats_pre`` with their batch statistics, and the
gradients of all three outputs of each (against ``jax.vjp``), and
``bn_apply``'s.

Tolerances (fp32): forward values atol 2e-5, rtol 1e-5 (the JAX suite's
own for these kernels); batch statistics 1e-5; gradients atol 1e-4,
rtol 1e-4 (sums over every output of a conv, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.pallas_kernels import fused_conv as jfc

from paddle_tpu_torch.kernels import fused_conv as tfc

SHAPES = [((2, 8, 8, 16), 32, 3), ((3, 6, 5, 8), 8, 3), ((2, 7, 7, 32), 16, 1),
          ((1, 4, 4, 8), 8, 1)]
FWD = dict(atol=2e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, shape, k, kh):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(k, shape[-1], kh, kh) * 0.1).astype(np.float32)
    return rng, x, w


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,k,kh", SHAPES)
def test_eval_kernel_matches_jax(shape, k, kh, relu):
    rng, x, w = _inputs(1, shape, k, kh)
    scale = (rng.rand(k) + 0.5).astype(np.float32)
    shift = rng.randn(k).astype(np.float32)
    want = np.asarray(jfc.fused_conv_bn_eval(x, w, scale, shift, relu))
    tfc.reset_counters()
    got = tfc.fused_conv_bn_eval(_t(x), _t(w), _t(scale), _t(shift), relu)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    assert sum(tfc.LAUNCHES.values()) == 0  # CPU: the plain version


def test_eval_on_a_1x1_image_gives_the_composition():
    """A 3x3 conv on 1x1 images: the JAX fused kernel raises (its block of
    nb*H*W rows is no longer than the tap offset W + 1); the port gives
    the XLA composition's answer."""
    rng, x, w = _inputs(2, (2, 1, 1, 8), 8, 3)
    scale = (rng.rand(8) + 0.5).astype(np.float32)
    shift = rng.randn(8).astype(np.float32)
    with pytest.raises(ValueError, match="Out of bound slice"):
        jfc.fused_conv_bn_eval(x, w, scale, shift, True)
    want = np.asarray(jfc._eval_ref(x, w, scale, shift, True))
    got = tfc.fused_conv_bn_eval(_t(x), _t(w), _t(scale), _t(shift), True)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def _cotangents(rng, co_shape, k):
    return (rng.randn(*co_shape).astype(np.float32),
            rng.randn(k).astype(np.float32),
            rng.randn(k).astype(np.float32))


@pytest.mark.parametrize("shape,k,kh", SHAPES[:3])
def test_conv_stats_and_grads_match_jax(shape, k, kh):
    rng, x, w = _inputs(3, shape, k, kh)
    (jco, jm, jv), vjp = jax.vjp(jfc.conv_stats, jnp.asarray(x),
                                 jnp.asarray(w))
    cts = _cotangents(rng, jco.shape, k)
    jdx, jdw = vjp(tuple(jnp.asarray(c) for c in cts))

    tx, tw = _t(x, True), _t(w, True)
    co, m, v = tfc.conv_stats(tx, tw)
    np.testing.assert_allclose(co.detach().numpy(), np.asarray(jco), **FWD)
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)
    dx, dw = torch.autograd.grad((co, m, v), (tx, tw),
                                 tuple(_t(c) for c in cts))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **GRAD)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **GRAD)


@pytest.mark.parametrize("relu_in", [True, False])
@pytest.mark.parametrize("shape,k,kh", [SHAPES[0], SHAPES[2]])
def test_conv_stats_pre_and_grads_match_jax(shape, k, kh, relu_in):
    rng, x, w = _inputs(4, shape, k, kh)
    c = shape[-1]
    m_p = (rng.randn(c) * 0.1).astype(np.float32)
    v_p = (rng.rand(c) + 0.5).astype(np.float32)
    gp = (rng.rand(c) + 0.5).astype(np.float32)
    bp = (rng.randn(c) * 0.1).astype(np.float32)
    args = (x, m_p, v_p, gp, bp, w)
    (jco, jm, jv), vjp = jax.vjp(
        lambda *a: jfc.conv_stats_pre(*a, relu_in, 1e-5),
        *(jnp.asarray(a) for a in args))
    cts = _cotangents(rng, jco.shape, k)
    jgrads = vjp(tuple(jnp.asarray(t) for t in cts))

    targs = [_t(a, True) for a in args]
    co, m, v = tfc.conv_stats_pre(*targs, relu_in, 1e-5)
    np.testing.assert_allclose(co.detach().numpy(), np.asarray(jco), **FWD)
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)
    grads = torch.autograd.grad((co, m, v), targs, tuple(_t(t) for t in cts))
    for name, got, want in zip(("co_p", "m_p", "v_p", "gp", "bp", "w"),
                               grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD,
                                   err_msg=name)


def test_bn_apply_grads_match_jax():
    rng = np.random.RandomState(5)
    co = rng.randn(2, 5, 5, 12).astype(np.float32) * 2 + 0.3
    m = co.mean((0, 1, 2))
    v = co.var((0, 1, 2))
    gamma = (rng.rand(12) + 0.5).astype(np.float32)
    beta = rng.randn(12).astype(np.float32)
    dy = rng.randn(*co.shape).astype(np.float32)
    args = (co, m, v, gamma, beta)
    jy, vjp = jax.vjp(lambda *a: jfc.bn_apply(*a, 1e-5),
                      *(jnp.asarray(a) for a in args))
    jgrads = vjp(jnp.asarray(dy))
    targs = [_t(a, True) for a in args]
    y = tfc.bn_apply(*targs, 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **FWD)
    grads = torch.autograd.grad(y, targs, _t(dy), allow_unused=True)
    for name, got, want in zip(("co", "m", "v", "gamma", "beta"), grads,
                               jgrads):
        got = torch.zeros(want.shape) if got is None else got
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD,
                                   err_msg=name)


def test_fused_train_unit_matches_jax():
    rng, x, w = _inputs(6, (2, 6, 6, 8), 16, 3)
    g = (rng.rand(16) + 0.5).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    want = jfc.fused_conv_bn_train(x, w, g, b, 1e-5)
    got = tfc.fused_conv_bn_train(_t(x), _t(w), _t(g), _t(b), 1e-5)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(e),
                                   atol=1e-4, rtol=1e-4)


def test_qualifying_shapes_match_jax():
    cases = [((3, 3), (1, 1), (1, 1), (1, 1), 1), ((1, 1), (1, 1), (0, 0),
             (1, 1), 1), ((3, 3), (2, 2), (1, 1), (1, 1), 1),
             ((3, 3), (1, 1), (0, 0), (1, 1), 1), ((1, 1), (1, 1), (0, 0),
             (1, 1), 32), ((3, 3), (1, 1), (2, 2), (2, 2), 1),
             ((7, 7), (1, 1), (3, 3), (1, 1), 1)]
    for case in cases:
        assert tfc.conv_qualifies(*case) == jfc.conv_qualifies(*case), case
