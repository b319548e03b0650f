"""Hand-written Hopper kernels of the port (counterpart of
``paddle_tpu/pallas_kernels``). CUDA sources live in ``csrc/`` and are
built by ``_build`` at first use; every kernel has a plain PyTorch
version beside it in the same module. The flash-attention and
quantized-matmul functions stay in their modules
(``kernels.flash_attention``, ``kernels.quant_matmul``), whose names the
functions would otherwise shadow here."""

from .decode_attention import (MAX_DECODE_Q_LEN, MAX_PAGED_Q_LEN,
                               decode_dispatch, flash_decode_attention,
                               paged_decode_dispatch,
                               paged_flash_decode_attention)
from .fused_conv import (bn_apply, conv_qualifies, conv_stats,
                         conv_stats_pre, fused_conv_bn_eval,
                         fused_conv_bn_train)

__all__ = ["flash_decode_attention", "paged_flash_decode_attention",
           "decode_dispatch", "paged_decode_dispatch", "MAX_DECODE_Q_LEN",
           "MAX_PAGED_Q_LEN", "conv_qualifies", "fused_conv_bn_eval",
           "conv_stats", "conv_stats_pre", "bn_apply",
           "fused_conv_bn_train"]
