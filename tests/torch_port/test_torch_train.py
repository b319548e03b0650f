"""Training parity with the JAX package (tiny config, fp32, CPU): the
pretraining loss and its gradient, AdamW with a decay mask, the
global-norm clip, and a 3-step ``ShardedTrainStep`` on
``LlamaConfig.tiny(use_flash_attention=True)`` (the JAX side on a
one-device ``ProcessMesh``, its flash kernels in interpret mode).

Tolerances: loss values and gradients atol 1e-6; per-step train losses
rtol 1e-5. Updated weights agree within 0.02 * lr: Adam divides m by
sqrt(v), so on an element whose gradient sits near its rounding noise
the two packages' last-bit differences in g move the step by a
fraction of lr (3.9e-6 = 0.004 * lr measured at lr 1e-3), while a wrong
update rule moves it by ~lr."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.engine import ShardedTrainStep as JStep
from paddle_tpu.distributed.mesh import ProcessMesh
from paddle_tpu.models import llama as jllama
from paddle_tpu.optimizer import functional as jfopt

from paddle_tpu_torch.distributed import ShardedTrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     export_paddle_tpu_state,
                                     llama_pretrain_loss,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import functional as tfopt
from torch_parity import jax_state, tiny_pair

LR = 1e-3
W_ATOL = 0.02 * LR


@pytest.mark.parametrize("label_shape", ["bs", "bs1"])
def test_pretrain_loss_and_grad_match_jax(label_shape):
    rng = np.random.RandomState(0)
    b, s, v = 2, 9, 33
    logits = rng.randn(b, s, v).astype(np.float32) * 3
    labels = rng.randint(0, v, (b, s)).astype(np.int32)
    labels[0, 4] = labels[1, 1] = -100
    if label_shape == "bs1":
        labels = labels[..., None]
    jlab = Tensor(jnp.asarray(labels))

    def jloss(lg):
        return jllama.llama_pretrain_loss(Tensor(lg), jlab)._data

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = llama_pretrain_loss(lg, torch.from_numpy(labels))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_g), atol=1e-6,
                               rtol=0)


def _params_and_grads(seed):
    rng = np.random.RandomState(seed)
    shapes = {"a.weight": (4, 3), "a.norm.weight": (3,), "b.bias": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    return params, grads


def test_adamw_with_decay_mask_matches_jax():
    def mask(name):
        return not name.endswith("norm.weight")

    params, _ = _params_and_grads(1)
    j = jfopt.adamw(weight_decay=0.1, decay_mask_fn=mask)
    t = tfopt.adamw(weight_decay=0.1, decay_mask_fn=mask)
    jp = {k: jnp.asarray(x) for k, x in params.items()}
    tp = {k: torch.from_numpy(x.copy()) for k, x in params.items()}
    js, ts = j.init(jp), t.init(tp)
    for step in range(3):
        _, grads = _params_and_grads(10 + step)
        jp, js = j.update({k: jnp.asarray(g) for k, g in grads.items()}, js,
                          jp, jnp.asarray(0.05, jnp.float32))
        tp, ts = t.update({k: torch.from_numpy(g) for k, g in grads.items()},
                          ts, tp, 0.05)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(js["m"][k]),
                                   atol=1e-6, rtol=0, err_msg=k)
        np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js["v"][k]),
                                   atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("clip_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_jax(clip_norm):
    _, grads = _params_and_grads(2)
    jg, jn = jfopt.clip_by_global_norm(
        {k: jnp.asarray(g) for k, g in grads.items()}, clip_norm)
    tg, tn = tfopt.clip_by_global_norm(
        {k: torch.from_numpy(g) for k, g in grads.items()}, clip_norm)
    np.testing.assert_allclose(tn.item(), float(jn), atol=1e-6, rtol=0)
    for k in grads:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("clip", [None, 0.5], ids=["no_clip", "clip"])
def test_three_train_steps_match_jax(clip):
    jm, tm, cfg = tiny_pair(use_flash_attention=True)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    jstep = JStep(jm, jllama.llama_pretrain_loss, jopt,
                  ProcessMesh(np.arange(1), ["dp"]), dp_axis=None,
                  grad_clip_norm=clip)
    tstep = ShardedTrainStep(tm, llama_pretrain_loss, AdamW(learning_rate=LR),
                             grad_clip_norm=clip)
    for i in range(3):
        want = float(jstep.step(paddle.to_tensor(ids),
                                paddle.to_tensor(labels)))
        got = float(tstep.step(ids, labels))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"step {i}")
    assert tstep._eager_opt._step_count == 3
    jstep.sync_weights_to_model()
    tstep.sync_weights_to_model()
    want_w, got_w = jax_state(jm), export_paddle_tpu_state(tm)
    assert set(want_w) == set(got_w)
    for k in want_w:
        np.testing.assert_allclose(got_w[k], want_w[k], atol=W_ATOL, rtol=0,
                                   err_msg=k)


def test_export_inverts_load_exactly():
    jm, _, _ = tiny_pair()
    state = jax_state(jm)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    back = export_paddle_tpu_state(load_paddle_tpu_state(model, state))
    assert set(back) == set(state)
    for k, arr in state.items():
        assert back[k].dtype == arr.dtype and back[k].shape == arr.shape, k
        np.testing.assert_array_equal(back[k], arr, err_msg=k)


def test_sync_from_model_takes_new_weights_and_keeps_moments():
    _, tm, cfg = tiny_pair()
    step = ShardedTrainStep(tm, llama_pretrain_loss, AdamW(learning_rate=LR))
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (1, 16))
    step.step(ids, ids)
    moments = {k: m.clone() for k, m in step.opt_state["m"].items()}
    with torch.no_grad():
        tm.llama.norm.weight.fill_(2.0)
    step.sync_weights_from_model()
    assert torch.equal(step.params["llama.norm.weight"],
                       torch.full_like(tm.llama.norm.weight, 2.0))
    for k, m in moments.items():
        assert torch.equal(step.opt_state["m"][k], m), k


@pytest.mark.parametrize("kwargs,match", [
    ({"mesh": ProcessMesh(np.arange(1), ["dp"]), "dp_axis": "dp"}, "dp_axis"),
    ({"remat": True}, "remat"),
    ({"shard_optimizer_states": True}, "ZeRO"),
])
def test_later_slices_raise(kwargs, match):
    _, tm, _ = tiny_pair()
    with pytest.raises(NotImplementedError, match=match):
        ShardedTrainStep(tm, llama_pretrain_loss, AdamW(), **kwargs)


def test_multi_device_mesh_raises():
    class TwoDevices:
        process_ids = [0, 1]

    _, tm, _ = tiny_pair()
    with pytest.raises(NotImplementedError, match="more than one device"):
        ShardedTrainStep(tm, llama_pretrain_loss, AdamW(), mesh=TwoDevices())
