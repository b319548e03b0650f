"""Functional ops of the ResNet and GPT paths (counterpart of the conv,
pooling, norm, activation and loss parts of ``paddle_tpu/nn/functional.py``).

Layouts follow the JAX package: ``data_format`` "NCHW" or "NHWC" names
the layout of the tensor's dimensions, weights stay OIHW. A channels-last
tensor here is a [N, H, W, C] tensor; for cuDNN it is handed over as the
[N, C, H, W] view with channels_last strides, so nothing is copied.

``batch_norm`` keeps Paddle's conventions, not ``torch.nn.functional
.batch_norm``'s: ``running = momentum * running + (1 - momentum) *
batch`` with the biased batch variance, and the statistics of a
half-precision input taken in one f32 pass (E[x^2] - E[x]^2), of an fp32
input in two. In training it updates ``running_mean``/``running_var`` in
place (the JAX package rebinds the Tensor's data; a model's buffers see
the new values either way).

``fused_conv_bn`` is Conv2D -> BatchNorm2D (-> ReLU) through the kernels
of ``kernels/fused_conv.py``. In training it returns a ``PendingBN``: the
unit's raw conv output and batch statistics, which the next qualifying
conv consumes as its kernel's prologue (``conv_stats_pre``) without the
normalized activation ever being computed; anything else asks for its
``value()``.

``layer_norm`` and ``gelu`` keep the JAX package's order of operations,
so that a bf16 activation rounds where it rounds there:
``layer_norm`` takes the mean and the variance in f32 and rounds each to
the activation dtype, then centres, scales, multiplies by the weight and
adds the bias in that dtype (``torch.nn.functional.layer_norm`` rounds
once at the end); ``gelu``'s tanh form computes ``jax.nn.gelu``'s
formula in the input dtype, its constants rounded to it first.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch
import torch.nn.functional as TF

from ..kernels import fused_conv as fc

__all__ = ["relu", "conv2d", "max_pool2d", "adaptive_avg_pool2d", "linear",
           "flatten", "cross_entropy", "batch_norm", "fused_conv_bn",
           "PendingBN", "value", "layer_norm", "gelu"]


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def relu(x):
    return torch.relu(value(x))


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` for a torch-layout [out, in] weight (the
    JAX package's [in, out] weights are transposed at load,
    ``models/convert.py``)."""
    return TF.linear(value(x), weight, bias)


def _const(v: float, dtype):
    """A 0-d constant rounded to ``dtype``, as a Python scalar of the JAX
    package's arithmetic (weakly typed) rounds to the array's dtype."""
    return torch.tensor(v, dtype=torch.float64).to(dtype)


def gelu(x, approximate=True):
    """``jax.nn.gelu``'s tanh form, ``x * 0.5 * (1 + tanh(sqrt(2 / pi) *
    (x + 0.044715 * x^3)))``, every step in x's dtype (the erf form is
    not ported: no model of the port uses it)."""
    if not approximate:
        raise NotImplementedError("gelu: only approximate=True (the tanh "
                                  "form) is ported")
    x = value(x)
    c = _const(math.sqrt(2.0 / math.pi), x.dtype)
    k = _const(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    """LayerNorm over the trailing ``normalized_shape`` dimensions: mean
    and (biased) variance in f32, each rounded to x's dtype, then ``(x -
    mean) * rsqrt(var + epsilon) * weight + bias`` in x's dtype."""
    x = value(x)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float()
    mean_f = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean_f).square().mean(dim=dims, keepdim=True).to(x.dtype)
    # rsqrt in f32, rounded once (torch's bf16 rsqrt on the CPU is not
    # correctly rounded; XLA's is)
    inv = torch.rsqrt((var + _const(epsilon, x.dtype)).float()).to(x.dtype)
    out = (x - mean_f.to(x.dtype)) * inv
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(value(x), start_axis, stop_axis)


def _conv_padding(padding):
    """-> ((top, bottom), (left, right)) from an int, a pair, four values
    or a pair of pairs."""
    if isinstance(padding, str):
        raise NotImplementedError(
            "string conv padding ('SAME'/'VALID') comes with a later slice; "
            "pass explicit padding")
    if isinstance(padding, (list, tuple)) and len(padding) == 2 \
            and all(isinstance(p, (list, tuple)) for p in padding):
        return tuple(tuple(p) for p in padding)
    p = _pair(padding)
    if len(p) == 2:
        return (p[0], p[0]), (p[1], p[1])
    if len(p) == 4:
        return (p[0], p[1]), (p[2], p[3])
    raise ValueError(f"conv2d: cannot read padding {padding!r}")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution of an OIHW weight over an NCHW or NHWC tensor, with
    symmetric or explicit (asymmetric) padding."""
    x = value(x)
    (pt, pb), (pl, pr) = _conv_padding(padding)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    elif data_format != "NCHW":
        raise ValueError(f"conv2d: data_format {data_format!r}")
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        x = TF.pad(x, (pl, pr, pt, pb))
        pad = 0
    out = TF.conv2d(x, weight, bias, _pair(stride), pad, _pair(dilation),
                    groups)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def max_pool2d(x, kernel_size, stride=None, padding=0, data_format="NCHW"):
    """Max pool with implicit -inf padding (``ceil_mode`` and
    ``return_mask`` come with a later slice)."""
    x = value(x)
    stride = kernel_size if stride is None else stride
    if data_format == "NHWC":
        return TF.max_pool2d(x.permute(0, 3, 1, 2), kernel_size, stride,
                             padding).permute(0, 2, 3, 1)
    return TF.max_pool2d(x, kernel_size, stride, padding)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Adaptive average pool; region i spans floor(i * in / out) to
    ceil((i + 1) * in / out), as in the JAX package."""
    x = value(x)
    if data_format == "NHWC":
        return TF.adaptive_avg_pool2d(x.permute(0, 3, 1, 2),
                                      _pair(output_size)).permute(0, 2, 3, 1)
    return TF.adaptive_avg_pool2d(x, _pair(output_size))


def cross_entropy(input, label, ignore_index=-100, reduction="mean",
                  axis=-1):
    """Softmax cross entropy over hard labels ([..., 1] or [...]) in the
    logits' dtype; "mean" divides by the count of labels that are not
    ``ignore_index`` (at least 1)."""
    logp = torch.log_softmax(input, dim=axis)
    lab = label.long()
    if lab.dim() == logp.dim() and lab.shape[axis] == 1:
        lab = lab.squeeze(axis)
    mask = lab != ignore_index
    picked = torch.gather(logp, axis, torch.where(mask, lab, 0).unsqueeze(
        axis)).squeeze(axis)
    loss = -picked * mask.to(logp.dtype)
    if reduction == "mean":
        return loss.sum() / torch.clamp(mask.sum().to(loss.dtype), min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------


def _bn_train_fwd(a, w, b, axes, epsilon):
    """Train-mode BatchNorm forward -> (y, residuals). Half-precision
    inputs: single-pass f32 statistics; fp32: two-pass in the input
    dtype."""
    if a.dtype in (torch.bfloat16, torch.float16):
        af = a.float()
        m = af.mean(axes, keepdim=True)
        ex2 = (af * af).mean(axes, keepdim=True)
        v = torch.clamp(ex2 - m * m, min=0.0)
    else:
        af = a
        m = af.mean(axes, keepdim=True)
        v = af.var(axes, unbiased=False, keepdim=True)
    r = torch.rsqrt(v + epsilon)
    cdt = af.dtype
    g = r if w is None else r * w.to(cdt)
    shift = -m * g if b is None else b.to(cdt) - m * g
    y = (af * g + shift).to(a.dtype)
    return y, (a, m, r, w, b)


def _bn_train_bwd(axes, epsilon, res, dy):
    """The fused BatchNorm backward: dx in one elementwise pass beside two
    reductions of (dy, x-hat); returns (dx, dw, db)."""
    del epsilon
    a, m, r, w, b = res
    cdt = m.dtype
    af = a.to(cdt)
    dyf = dy.to(cdt)
    xhat = (af - m) * r
    s1 = dyf.mean(axes, keepdim=True)
    s2 = (dyf * xhat).mean(axes, keepdim=True)
    g = r if w is None else r * w.to(cdt)
    dx = (g * (dyf - s1 - xhat * s2)).to(a.dtype)
    n = 1
    for i in axes:
        n *= a.shape[i]
    dw = None if w is None else (s2 * n).to(w.dtype)
    db = None if b is None else (s1 * n).to(b.dtype)
    return dx, dw, db


def _update_running(rm, rv, batch_mean, batch_var, momentum):
    with torch.no_grad():
        rm.copy_(momentum * rm + (1 - momentum) * batch_mean.to(rm.dtype))
        rv.copy_(momentum * rv + (1 - momentum) * batch_var.to(rv.dtype))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None):
    x = value(x)
    ch = 1 if data_format.startswith("NC") and x.dim() > 1 else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    bshape = [1] * x.dim()
    bshape[ch] = x.shape[ch]

    def view(t):
        return None if t is None else t.reshape(bshape)

    if training and not use_global_stats:
        with torch.no_grad():
            _update_running(running_mean, running_var, x.mean(axes),
                            x.var(axes, unbiased=False), momentum)
        y, _ = _bn_train_fwd(x, view(weight), view(bias), axes,
                             float(epsilon))
        return y
    out = (x - view(running_mean)) * torch.rsqrt(view(running_var) + epsilon)
    if weight is not None:
        out = out * view(weight)
    if bias is not None:
        out = out + view(bias)
    return out


class PendingBN(NamedTuple):
    """A train-mode fused Conv2D -> BatchNorm2D (-> ReLU) unit whose
    normalized output has not been computed: its raw conv output ``co``
    [N, H, W, K], batch statistics ``m``, ``v`` (f32), the BatchNorm's
    ``gamma``, ``beta`` and ``eps``, and whether a ReLU follows."""
    co: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    gamma: torch.Tensor
    beta: torch.Tensor
    eps: float
    relu: bool

    def value(self) -> torch.Tensor:
        y = fc.bn_apply(self.co, self.m, self.v, self.gamma, self.beta,
                        self.eps)
        return torch.relu(y) if self.relu else y


def value(x):
    """The tensor ``x`` stands for (a ``PendingBN`` is normalized)."""
    return x.value() if isinstance(x, PendingBN) else x


def fused_conv_bn(x, conv_weight, running_mean, running_var, weight, bias,
                  training=False, momentum=0.9, epsilon=1e-05,
                  use_global_stats=None, relu=False):
    """Conv2D + BatchNorm(+ReLU) through the fused kernels. NHWC only; the
    conv must be a dense stride-1 3x3 (pad 1) or 1x1 (pad 0) with no bias
    (callers qualify it first: ``nn.layers_conv_norm.conv_bn``).

    Eval (or ``use_global_stats``): ``fused_conv_bn_eval`` with the
    running statistics folded in f32 -> the output tensor. Training:
    ``conv_stats`` (or ``conv_stats_pre`` when ``x`` is a ``PendingBN``,
    whose normalize(+ReLU) becomes the prologue) -> a ``PendingBN``; the
    running statistics are updated from the batch statistics."""
    if training and not use_global_stats:
        eps = float(epsilon)
        if isinstance(x, PendingBN):
            co, m, v = fc.conv_stats_pre(x.co, x.m, x.v, x.gamma, x.beta,
                                         conv_weight, x.relu, x.eps)
        else:
            co, m, v = fc.conv_stats(x, conv_weight)
        _update_running(running_mean, running_var, m.detach(), v.detach(),
                        momentum)
        return PendingBN(co, m, v, weight, bias, eps, bool(relu))
    x = value(x)
    vconst = running_var.float()
    scale = weight.float() * torch.rsqrt(vconst + epsilon)
    shift = bias.float() - running_mean.float() * scale
    return fc.fused_conv_bn_eval(x, conv_weight, scale, shift, relu)
