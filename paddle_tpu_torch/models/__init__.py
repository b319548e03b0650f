"""Models of the port (counterpart of ``paddle_tpu/models``)."""

from .convert import load_paddle_tpu_state
from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM", "load_paddle_tpu_state"]
