"""Weight and value quantization parity with the JAX package (CPU).

- ``pack_absmax`` / ``unpack_absmax`` give the JAX package's bytes and
  floats BIT FOR BIT, for int8 and fp8, on inputs that include zeros
  (and a zero scale), exact .5 rounding ties and clipped values;
- ``weight_quantize`` and ``convert_for_serving`` give the JAX package's
  ``qweight`` and ``scale`` bit for bit on the tiny Llama, and the
  converted state crosses between the packages with its bits kept;
- ``quant_matmul_ref`` (the plain version of K9) matches the JAX
  package's Pallas ``quant_matmul`` run in interpret mode, atol 1e-5 in
  fp32 (the two sum in another order), and ``weight_only_linear`` with
  the JAX kernel lane enabled (``PADDLE_TPU_QUANT_WEIGHTS=1``);
- the dispatch gates and counters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import quant as jquant
from paddle_tpu.pallas_kernels.quant_matmul import quant_matmul as j_qmm
from paddle_tpu.quantization import convert_for_serving as j_convert
from paddle_tpu.quantization import intx as jintx

from paddle_tpu_torch.kernels import quant_matmul as tqm
from paddle_tpu_torch.nn import quant as tquant
from paddle_tpu_torch.quantization import convert_for_serving as t_convert
from paddle_tpu_torch.quantization import intx as tintx
from torch_parity import jax_state, tiny_pair

FORMATS = ["int8", "fp8"]


def _bytes_t(t):
    return t.contiguous().view(torch.uint8).numpy() \
        if t.element_size() == 1 else t.numpy()


def _bytes_j(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _edge_values(fmt, rng):
    """[64, 32] values with absmax scales per row: random rows, a zero
    row with a zero scale, exact rounding ties, and rows whose scale is
    below their absmax (values clip)."""
    bound = jintx.format_bound(fmt)
    x = rng.randn(64, 32).astype(np.float32)
    s = np.abs(x).max(axis=1, keepdims=True)
    x[0] = 0.0
    s[0] = 0.0
    # ties: x * bound lands exactly half-way between two storage values
    if fmt == "int8":
        mids = np.arange(-60, 60, dtype=np.float32) + 0.5
    else:
        # e4m3 midpoints between neighbours of 3-bit mantissa
        mids = np.array([m * 2.0 ** e for m in (1.0625, 1.1875, 1.3125)
                         for e in range(-4, 8)], np.float32)
        mids = np.concatenate([mids, -mids])
    ties = (mids / np.float32(bound)).astype(np.float32)
    x[1:5] = np.resize(ties, (4, 32))
    s[1:5] = 1.0
    x[5:9] *= 3.0          # clipped: scale stays at the unscaled absmax
    return x, s


@pytest.mark.parametrize("fmt", FORMATS)
def test_pack_unpack_bit_identical_to_jax(fmt):
    x, s = _edge_values(fmt, np.random.RandomState(0))
    bound = np.float32(jintx.format_bound(fmt))
    scaled = x[1:5] / np.float32(1.0) * bound
    assert np.any(scaled == np.round(scaled * 2) / 2) \
        and np.any(scaled % 1 != 0), "no exact ties in the input"
    want = jintx.pack_absmax(jnp.asarray(x), jnp.asarray(s), fmt)
    got = tintx.pack_absmax(torch.from_numpy(x), torch.from_numpy(s), fmt)
    assert got.dtype == tintx.format_dtype(fmt)
    np.testing.assert_array_equal(_bytes_t(got), _bytes_j(want))
    assert np.abs(np.asarray(want, np.float32)).max() == bound  # clipped
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        w = jintx.unpack_absmax(want, jnp.asarray(s), fmt, jdt)
        g = tintx.unpack_absmax(got, torch.from_numpy(s), fmt, tdt)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


def test_formats_and_accounting_match_jax():
    assert tintx.KV_FORMATS == jintx.KV_FORMATS
    for fmt in FORMATS:
        assert tintx.format_bound(fmt) == jintx.format_bound(fmt)
        assert tintx.format_itemsize(fmt) == jintx.format_itemsize(fmt)
    with pytest.raises(ValueError):
        tintx.format_dtype("int4")


@pytest.mark.parametrize("fmt", FORMATS)
def test_weight_quantize_bit_identical_to_jax(fmt):
    rng = np.random.RandomState(1)
    w = rng.randn(48, 40).astype(np.float32)          # [in, out]
    w[:, 3] = 0.0                                     # a zero channel
    jq, js = jquant.weight_quantize(paddle.to_tensor(w),
                                    algo=f"weight_only_{fmt}")
    tq, ts = tquant.weight_quantize(torch.from_numpy(w),
                                    algo=f"weight_only_{fmt}")
    assert tuple(tq.shape) == (40, 48)
    np.testing.assert_array_equal(_bytes_t(tq), _bytes_j(jq._data))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js._data))
    jd = jquant.weight_dequantize(jq, js, algo=f"weight_only_{fmt}",
                                  out_dtype="float32")
    td = tquant.weight_dequantize(tq, ts, algo=f"weight_only_{fmt}",
                                  out_dtype=torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd._data))


@pytest.mark.parametrize("fmt", FORMATS)
def test_convert_for_serving_bit_identical_on_tiny_llama(fmt):
    jm, tm, _ = tiny_pair()
    j_convert(jm, fmt=fmt)
    t_convert(tm, fmt=fmt)
    js = jax_state(jm)
    ts = tm.state_dict()
    assert set(js) == set(ts)
    names = [k for k in ts if k.endswith(".qweight")]
    assert len(names) == 7 * 2 + 1        # every linear and lm_head
    for name in names:
        base = name[:-len("qweight")]
        assert isinstance(tm.get_submodule(base[:-1]), tquant.WeightOnlyLinear)
        np.testing.assert_array_equal(_bytes_t(ts[name]), _bytes_j(js[name]))
        np.testing.assert_array_equal(ts[base + "scale"].numpy(),
                                      js[base + "scale"])
    # the converted JAX state loads into a converted port model bit for bit
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_paddle_tpu_state)

    fresh = t_convert(LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"),
                      fmt=fmt)
    load_paddle_tpu_state(fresh, js)
    for name in names:
        np.testing.assert_array_equal(_bytes_t(fresh.state_dict()[name]),
                                      _bytes_j(js[name]))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("M,N,K", [(3, 40, 64), (8, 64, 128)])
def test_quant_matmul_ref_matches_jax_kernel(M, N, K, fmt):
    rng = np.random.RandomState(M + N)
    # x / sqrt(K) keeps the outputs near unit scale, where atol 1e-5 is
    # about a hundred float32 steps
    x = (rng.randn(M, K) / np.sqrt(K)).astype(np.float32)
    w = rng.randn(N, K).astype(np.float32)
    amax = np.abs(w).max(axis=1)
    q = jintx.pack_absmax(jnp.asarray(w), jnp.asarray(amax)[:, None], fmt)
    scale = (amax / jintx.format_bound(fmt)).astype(np.float32)
    want = np.asarray(j_qmm(jnp.asarray(x), q, jnp.asarray(scale),
                           block_k=64))
    tq = torch.from_numpy(np.array(_bytes_j(q))).view(tintx.format_dtype(fmt))
    got = tqm.quant_matmul_ref(torch.from_numpy(x), tq,
                               torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the wrapper on CPU tensors is the plain version, with no launch
    tqm.reset_counters()
    out = tqm.quant_matmul(torch.from_numpy(x)[None], tq,
                           torch.from_numpy(scale))
    assert out.shape == (1, M, N) and tqm.LAUNCHES["quant_matmul"] == 0
    torch.testing.assert_close(out[0], got, atol=0, rtol=0)


def test_weight_only_linear_matches_jax_kernel_lane(monkeypatch):
    rng = np.random.RandomState(5)
    w = rng.randn(64, 32).astype(np.float32)
    x = rng.randn(4, 64).astype(np.float32)
    bias = rng.randn(32).astype(np.float32)
    jq, js = jquant.weight_quantize(paddle.to_tensor(w))
    tq, ts = tquant.weight_quantize(torch.from_numpy(w))
    monkeypatch.setenv("PADDLE_TPU_QUANT_WEIGHTS", "1")
    with paddle.no_grad():
        want = jquant.weight_only_linear(paddle.to_tensor(x), jq,
                                         paddle.to_tensor(bias), js).numpy()
    with torch.no_grad():
        got = tquant.weight_only_linear(torch.from_numpy(x), tq,
                                        torch.from_numpy(bias), ts)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_dispatch_gates_and_counters():
    tqm.reset_counters()
    rng = np.random.RandomState(6)
    lin = torch.nn.Linear(32, 16, bias=True)
    wol = tquant.WeightOnlyLinear.from_linear(lin, fmt="int8")
    x = torch.from_numpy(rng.randn(2, 32).astype(np.float32))
    with torch.no_grad():
        a = wol(x)
        wol(x.to(torch.bfloat16))
    b = wol(x)                                    # grad mode: plain linear
    assert dict(tqm.DISPATCH_HITS) == {"int8": 2}
    assert dict(tqm.DISPATCH_FALLBACKS) == {"grad_mode": 1}
    with torch.no_grad():
        tqm.quant_matmul_dispatch(dtype=torch.float16, fmt="fp8")
    assert tqm.DISPATCH_FALLBACKS["dtype"] == 1
    # both lanes compute x @ dequant(q).T + bias up to rounding order
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    ref = x @ (wol.qweight.float() * wol.scale[:, None]).t() + lin.bias
    torch.testing.assert_close(a, ref.detach(), atol=1e-5, rtol=0)


def test_quantize_for_inference_replaces_every_linear():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tquant.quantize_for_inference(m, fmt="fp8",
                                  include=lambda n, l: "mlp" in n)
    kinds = {n: type(mod).__name__ for n, mod in m.named_modules()
             if n.endswith("_proj") or n == "lm_head"}
    assert all(k == "WeightOnlyLinear" for n, k in kinds.items()
               if ".mlp." in n)
    assert all(k == "Linear" for n, k in kinds.items() if ".mlp." not in n)
    assert m.llama.layers[0].mlp.up_proj.fmt == "fp8"
