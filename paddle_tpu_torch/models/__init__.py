"""Models of the port (counterpart of ``paddle_tpu/models``)."""

from .convert import export_paddle_tpu_state, load_paddle_tpu_state
from .gpt import GPTConfig, GPTForCausalLM
from .llama import LlamaConfig, LlamaForCausalLM, llama_pretrain_loss

__all__ = ["LlamaConfig", "LlamaForCausalLM", "llama_pretrain_loss",
           "GPTConfig", "GPTForCausalLM", "load_paddle_tpu_state",
           "export_paddle_tpu_state"]
