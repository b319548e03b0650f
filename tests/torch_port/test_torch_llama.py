"""Llama parity: the port's model on the JAX model's weights (tiny
config, fp32, CPU). Uncached logits agree at atol 1e-4; rotary
embedding with int and per-row offsets agrees at atol 1e-6."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jllama

from paddle_tpu_torch.models import load_paddle_tpu_state
from paddle_tpu_torch.models import llama as tllama
from torch_parity import jax_state, tiny_pair


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def test_state_round_trips(pair):
    jm, tm, _ = pair
    js = jax_state(jm)
    ts = tm.state_dict()
    assert set(js) == set(ts)
    for name, arr in js.items():
        got = ts[name].numpy()
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            got = got.T
        np.testing.assert_array_equal(got, arr, err_msg=name)


def test_load_rejects_missing_and_leftover_keys(pair):
    jm, tm, _ = pair
    js = jax_state(jm)
    short = dict(js)
    short.pop("llama.norm.weight")
    with pytest.raises(ValueError, match="missing"):
        load_paddle_tpu_state(tm, short)
    extra = dict(js, **{"llama.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="leftover"):
        load_paddle_tpu_state(tm, extra)


def test_uncached_logits_match(pair):
    jm, tm, cfg = pair
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 24))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)))._data)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("offset", ["int", "per_row"])
def test_rope_matches(offset):
    rng = np.random.RandomState(5)
    b, s, h, d = 3, 4, 2, 16
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, h, d).astype(np.float32)
    off_np = 7 if offset == "int" else np.array([0, 9, 30], np.int32)
    jcos, jsin = jllama._rope_tables(d, 64, 10000.0)
    jq, jk = jllama.apply_rotary_pos_emb(
        paddle.to_tensor(q), paddle.to_tensor(k), jcos, jsin,
        off_np if offset == "int" else paddle.to_tensor(off_np)._data)
    tcos, tsin = tllama._rope_tables(d, 64, 10000.0)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    off_t = off_np if offset == "int" else torch.from_numpy(off_np)
    tq, tk = tllama.apply_rotary_pos_emb(torch.from_numpy(q),
                                         torch.from_numpy(k), tcos, tsin,
                                         off_t)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq._data), atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk._data), atol=1e-6)


def test_flash_uncached_logits_match():
    """``use_flash_attention`` routes the uncached forward through the
    flash-attention function (GQA expanded first): logits agree with the
    JAX model at atol 1e-4, and with the port's plain path."""
    jm, tm, cfg = tiny_pair(use_flash_attention=True)
    ids = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 40))
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)))._data)
    got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)
    for layer in tm.llama.layers:
        layer.self_attn.use_flash_attention = False
    plain = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), plain.detach().numpy(),
                               atol=1e-5, rtol=0)
