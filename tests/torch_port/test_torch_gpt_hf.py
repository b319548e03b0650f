"""``GPTForCausalLM.from_huggingface`` against ``transformers``'
GPT2LMHeadModel on a tiny random config (CPU, fp32): the logits agree
at atol 1e-5 and greedy decoding gives HF's tokens; the configurations
the JAX package refuses are refused. (Importing ``transformers`` takes
most of this file's time.)"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import GPTForCausalLM


def _hf_model(**kw):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.GPT2Config(vocab_size=96, n_positions=40, n_embd=32,
                                  n_layer=2, n_head=4, **kw)
    return transformers.GPT2LMHeadModel(cfg).eval()


def test_from_huggingface_matches_transformers():
    hf = _hf_model()
    tm = GPTForCausalLM.from_huggingface(hf, device="cpu")
    assert tm.config.max_position_embeddings == 40
    assert tm.config.intermediate_size == 128
    # untied: the head is a copy, not the embedding table itself
    assert tm.lm_head.weight.data_ptr() != tm.gpt.wte.weight.data_ptr()
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 96, (2, 17)))
    with torch.no_grad():
        want = hf(ids).logits
        got = tm(ids)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    out = tm.generate(ids[:1, :5], max_new_tokens=6)
    ref = hf.generate(ids[:1, :5], max_new_tokens=6, do_sample=False,
                      pad_token_id=0)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.mark.parametrize("kw", [dict(activation_function="relu"),
                                dict(scale_attn_by_inverse_layer_idx=True),
                                dict(scale_attn_weights=False)])
def test_from_huggingface_refuses_what_it_cannot_compute(kw):
    with pytest.raises(NotImplementedError):
        GPTForCausalLM.from_huggingface(_hf_model(**kw), device="cpu")
