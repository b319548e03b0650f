"""Fused conv2d + BatchNorm (+ReLU) kernels (counterpart of
``paddle_tpu/pallas_kernels/fused_conv.py``).

NHWC activations, OIHW weights, dense stride-1 3x3 (pad 1) and 1x1 (pad 0)
convs: the shapes ``conv_qualifies`` admits, ResNet's FLOP bulk.

- ``fused_conv_bn_eval(x, w, scale, shift, relu)`` (K10): ``relu?(conv(x,
  w) * scale + shift)`` with the folded BatchNorm applied to the f32
  accumulator before the tile is stored: conv+BN+ReLU is one read of x
  and one write of y.
- ``conv_stats(x, w)`` (K11): the conv output plus its per-channel batch
  mean and (biased) variance, reduced from the f32 accumulator in the same
  kernel, so the statistics pass costs no extra read of the output.
- ``conv_stats_pre(co_p, m_p, v_p, gp, bp, w, relu_in, eps_p)`` (K11 with
  its prologue): ``conv_stats`` over the PREVIOUS unit's normalize(+ReLU)
  of its raw conv output ``co_p``, applied as x is loaded, so the
  normalized activation never exists in device memory.
- ``bn_apply(co, m, v, gamma, beta)``: the normalize the model consumes.

Gradient contract (as in the JAX package): ``bn_apply``'s backward is the
full batch-norm backward (``nn.functional._bn_train_bwd``) and returns no
gradient for m and v; the m and v outputs of ``conv_stats*`` carry
gradients only from their other consumer, the next unit's prologue, which
``conv_stats*``'s backward takes through the plain composition. The
convolution gradients are cuDNN's (no TPU kernel computes them either:
the JAX package takes ``jax.vjp`` over the XLA composition).

Each kernel function has its plain PyTorch version beside it
(``_eval_ref``, ``_conv_stats_ref``, ``_conv_stats_pre_ref``), computing
the kernel's math: the convolution summed in f32 from the inputs widened
to f32, the epilogue (or the statistics) on that f32 sum, one rounding to
x's dtype at the end. For fp32 inputs these are the JAX package's
references (``fused_conv.py:292-295, :357-359, :392-398``); for bf16 the
JAX references round the conv to bf16 first, while its TPU kernels, like
these, do not. A wrapper takes the plain version only for CPU tensors;
for CUDA tensors it launches the kernel of ``csrc/fused_conv.cu`` or
raises, and counts the launch in ``LAUNCHES`` (K10 with and without its
ReLU, K11 with and without its prologue). ``conv_plan`` gives each
launch's geometry (the tensor-core body for bf16 with C % 8 == 0, the
plain-FMA body otherwise); the C side checks it and refuses a plan it
cannot run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import load_library

__all__ = ["conv_qualifies", "conv_plan", "ConvPlan", "fused_conv_bn_eval",
           "conv_stats", "conv_stats_pre", "bn_apply", "fused_conv_bn_train",
           "LAUNCHES", "reset_counters"]

LAUNCHES = {"fused_conv_bn_eval": 0, "fused_conv_bn_eval_relu": 0,
            "conv_stats": 0, "conv_stats_pre": 0}


def reset_counters() -> None:
    """Zero the launch counts."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def conv_qualifies(kernel, stride, padding, dilation, groups) -> bool:
    """The shapes this kernel family covers: dense stride-1 NHWC 3x3
    (pad 1) and 1x1 (pad 0) convs. Everything else takes ``F.conv2d``."""
    if groups != 1 or tuple(dilation) != (1, 1) or tuple(stride) != (1, 1):
        return False
    k, p = tuple(kernel), tuple(padding)
    return (k == (3, 3) and p == (1, 1)) or (k == (1, 1) and p == (0, 0))


def _conv(x, w):
    """NHWC stride-1 'same' conv of an OIHW weight, in x's dtype (cuDNN in
    channels_last on the card)."""
    pad = (w.shape[2] - 1) // 2
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=pad).permute(0, 2, 3, 1)


def _conv_bwd(g, x, w, need_x: bool, need_w: bool):
    """Gradients of ``_conv(x, w)`` for the output cotangent ``g``."""
    if not (need_x or need_w):
        return None, None
    pad = (w.shape[2] - 1) // 2
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, None, [1, 1],
        [pad, pad], [1, 1], False, [0, 0], 1, [need_x, need_w, False])
    return (dx.permute(0, 2, 3, 1) if dx is not None else None), dw


def _moments_ref(co):
    """Per-channel mean and biased variance in f32, single pass:
    ``max(E[x^2] - E[x]^2, 0)``."""
    cof = co.float()
    m = cof.mean((0, 1, 2))
    v = torch.maximum((cof * cof).mean((0, 1, 2)) - m * m, m.new_zeros(()))
    return m, v


def _fold_bn(m, v, gamma, beta, eps):
    """BatchNorm as a per-channel f32 scale and shift."""
    scale = gamma.float() * torch.rsqrt(v.float() + eps)
    return scale, beta.float() - m.float() * scale


def _prologue(x, ps, pb, relu_in):
    xf = x.float() * ps + pb
    if relu_in:
        # jnp.maximum's rule: a tie at 0 takes half the gradient
        xf = torch.maximum(xf, xf.new_zeros(()))
    return xf.to(x.dtype)


def _eval_ref(x, w, scale, shift, relu):
    y = _conv(x.float(), w.float()) * scale + shift
    return (torch.relu(y) if relu else y).to(x.dtype)


def _conv_stats_ref(x, w):
    acc = _conv(x.float(), w.float())
    return (acc.to(x.dtype),) + _moments_ref(acc)


def _conv_stats_pre_ref(co_p, m_p, v_p, gp, bp, w, relu_in, eps_p):
    ps, pb = _fold_bn(m_p, v_p, gp, bp, eps_p)
    return _conv_stats_ref(_prologue(co_p, ps, pb, relu_in), w)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

# csrc/fused_conv.cu's geometry: the tensor-core body's tile rows, shared
# bytes a block may take on sm_90 and rows of one TMA box; the plain-FMA
# body's tile
_TM, _SMEM_MAX, _MAX_BOX = 128, 232448, 256
_SIMT_TILE = 64
_STATS_SPAN = 64    # tiles a block of the statistics' first pass sums
# (x ring, weight ring) depths, the deepest that fits first
_STAGES = ((4, 4), (3, 4), (2, 4), (3, 3), (2, 3), (2, 2))


class ConvPlan(NamedTuple):
    """How one launch of csrc/fused_conv.cu covers its conv."""
    body: str        # "tc" (TMA ring, wgmma) or "simt" (plain fp32 FMA)
    tile_rows: int   # output rows a tile (and a statistics partial)
    tn: int          # output channels a tile
    mode: str        # "slab": one halo slab a channel step; "tap": a window
    a_rows: int      # rows of one staged x block (the TMA box; tc only)
    a_stages: int    # depth of the x ring (tc only)
    w_stages: int    # depth of the weight ring (tc only)
    smem: int        # dynamic shared bytes (tc only)
    grid: tuple      # work items: (column blocks, row tiles), tile-major;
    # the tc body walks them with one persistent block per SM
    tiles: int       # rows of the [tiles, K] statistics partials


def _tc_smem(a_rows, a_stages, w_stages, tn):
    """The tensor-core body's shared bytes: 1024 for alignment, the x ring
    (stages of a_rows rounded up to 8 rows of 128 bytes), the weight ring
    (tiles of tn rows of 128 bytes), the epilogue's bf16 tile and f32
    partials, then 8 bytes per mbarrier."""
    x_ring = a_stages * (-(-a_rows // 8) * 8 * 128)
    return (1024 + x_ring + w_stages * tn * 128 + _TM * tn * 2
            + 2 * 8 * tn * 4 + 8 * (3 * a_stages + 2 * w_stages))


def conv_plan(n, h, w, c, k, ks, bf16=True) -> ConvPlan:
    """The launch plan of an NHWC [n, h, w, c] conv to k channels with a
    ks x ks kernel (3: pad 1; 1). bf16 with c % 8 == 0 takes the
    tensor-core body: 128-row tiles; 256 output channels a tile where
    k >= 256, 128 where k > 64, else 64; x staged 64 channels at a time as
    one halo slab of rows [m0 - w - 1, m0 + 128 + w + 1) that every tap
    reads shifted or, where that slab is taller than one TMA box
    (w > 63), as one 128-row window per tap; the x and weight rings as
    deep (4 to 2 stages each) as a block's shared memory allows. The
    body walks the (column block, row tile) items with one persistent
    block per SM. Everything else takes the plain-FMA body."""
    m = n * h * w
    if not (bf16 and c % 8 == 0):
        tiles = -(-m // _SIMT_TILE)
        return ConvPlan("simt", _SIMT_TILE, _SIMT_TILE, "tap", 0, 0, 0, 0,
                        (-(-k // _SIMT_TILE), tiles), tiles)
    tn = 256 if k >= 256 else 128 if k > 64 else 64
    halo = w + 1 if ks == 3 else 0
    slab_rows = _TM + 2 * halo
    mode = "slab" if slab_rows <= _MAX_BOX else "tap"
    a_rows = slab_rows if mode == "slab" else _TM
    a_st, w_st = next(d for d in _STAGES
                      if _tc_smem(a_rows, *d, tn) <= _SMEM_MAX)
    tiles = -(-m // _TM)
    return ConvPlan("tc", _TM, tn, mode, a_rows, a_st, w_st,
                    _tc_smem(a_rows, a_st, w_st, tn), (-(-k // tn), tiles),
                    tiles)


# ---------------------------------------------------------------------------
# the kernel launch (CUDA tensors only)
# ---------------------------------------------------------------------------

def _on_card(x, what):
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return False


def _f32_vec(t, n, name, dev):
    if t.dtype != torch.float32 or tuple(t.shape) != (n,) \
            or t.device != dev:
        raise ValueError(f"fused conv: {name} must be float32 [{n}] on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _fold_bn_card(m, v, gamma, beta, eps):
    """``_fold_bn`` on the card in one launch (csrc/fused_conv.cu
    ``bn_fold``, with the same f32 roundings)."""
    c = m.shape[0]
    dev = m.device
    bf16 = gamma.dtype == beta.dtype == torch.bfloat16
    vecs = [t.contiguous() if bf16 and i >= 2 else t.float().contiguous()
            for i, t in enumerate((m, v, gamma, beta))]
    for name, t in zip(("mean", "var", "gamma", "beta"), vecs):
        if tuple(t.shape) != (c,) or t.device != dev:
            raise ValueError(f"conv_stats_pre: {name} must be [{c}] on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    ps = torch.empty(c, dtype=torch.float32, device=dev)
    pb = torch.empty_like(ps)
    rc = load_library("fused_conv.cu").paddle_bn_fold(
        *(t.data_ptr() for t in vecs), int(bf16), c, float(eps),
        ps.data_ptr(), pb.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv_stats_pre: fold launch failed "
                           f"(cudaError {rc})")
    return ps, pb


def _launch(x, w, *, scale=None, shift=None, relu=False, pre=None):
    """One launch of csrc/fused_conv.cu. ``scale``/``shift`` given: K10,
    returns y. Otherwise K11 (``pre``: (ps, pb, relu_in) prologue),
    returns (out, mean, var)."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"fused conv: NHWC x and OIHW w required, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, c = x.shape
    k, c_w, kh, kw = w.shape
    if c_w != c or kh != kw or kh not in (1, 3):
        raise ValueError(f"fused conv: weight {tuple(w.shape)} is not a 1x1 "
                         f"or 3x3 OIHW weight over {c} input channels")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"fused conv: x and w must share float32 or bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"fused conv: w on {w.device}, x on {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    # OIHW -> [taps, K, C]: tap-major planes of output-channel rows; the
    # weights change every train step, so nothing is cached
    w_t = w.permute(2, 3, 0, 1).reshape(kh * kw, k, c).contiguous()
    dev = x.device
    stats = scale is None
    out = torch.empty((n, h, wd, k), dtype=x.dtype, device=dev)
    lib = load_library("fused_conv.cu")
    bf16 = int(x.dtype == torch.bfloat16)
    m_rows = n * h * wd
    plan = conv_plan(n, h, wd, c, k, kh, bool(bf16))
    if stats:
        part = torch.empty((2, plan.tiles, k), dtype=torch.float32, device=dev)
        part1, part2 = part[0], part[1]
        scale = shift = None
    else:
        scale = _f32_vec(scale, k, "scale", dev)
        shift = _f32_vec(shift, k, "shift", dev)
        part1 = part2 = None
    ps = pb = None
    relu_in = False
    if pre is not None:
        ps, pb, relu_in = pre
        ps = _f32_vec(ps, c, "prologue scale", dev)
        pb = _f32_vec(pb, c, "prologue shift", dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    if m_rows:
        rc = lib.paddle_fused_conv(
            x.data_ptr(), w_t.data_ptr(), ptr(scale), ptr(shift), ptr(ps),
            ptr(pb), out.data_ptr(), ptr(part1), ptr(part2), bf16,
            int(stats), int(bool(relu)), int(pre is not None),
            int(bool(relu_in)), n, h, wd, c, k, kh, int(plan.body == "tc"),
            plan.tile_rows, plan.tn, int(plan.mode == "slab"), plan.a_rows,
            plan.a_stages, plan.w_stages, plan.smem, plan.tiles, stream)
        if rc != 0:
            raise RuntimeError(f"fused conv: kernel launch failed "
                               f"(cudaError {rc})")
        if not stats:
            LAUNCHES["fused_conv_bn_eval_relu" if relu
                     else "fused_conv_bn_eval"] += 1
        else:
            LAUNCHES["conv_stats_pre" if pre is not None
                     else "conv_stats"] += 1
    if not stats:
        return out
    if not m_rows:
        raise ValueError("conv_stats: the batch statistics of an empty batch "
                         "are undefined")
    # the tiles' partials summed in a fixed order: the same result every run
    m = torch.empty(k, dtype=torch.float32, device=dev)
    v = torch.empty_like(m)
    spans = -(-plan.tiles // _STATS_SPAN)
    rows = spans if spans > 1 else 0
    scratch = torch.empty((2, rows, k), dtype=torch.float32, device=dev) \
        if rows else None
    rc = lib.paddle_conv_stats_finish(part.data_ptr(), plan.tiles, k, m_rows,
                                      _STATS_SPAN, rows, ptr(scratch),
                                      m.data_ptr(), v.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"conv_stats: statistics launch failed "
                           f"(cudaError {rc})")
    return out, m, v


# ---------------------------------------------------------------------------
# inference: conv + folded BN scale/shift (+ReLU) in one kernel (K10)
# ---------------------------------------------------------------------------


class _EvalFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, shift, relu):
        ctx.relu = relu
        ctx.save_for_backward(x, w, scale, shift)
        if _on_card(x, "fused_conv_bn_eval"):
            return _launch(x, w, scale=scale, shift=shift, relu=relu)
        return _eval_ref(x, w, scale, shift, relu)

    @staticmethod
    def backward(ctx, dy):
        # rare path (gradients through frozen-stats BN): the plain
        # composition's backward is the fused forward's derivative
        x, w, scale, shift = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_(need)
                    for t, need in zip((x, w, scale, shift),
                                       ctx.needs_input_grad)]
            y = _eval_ref(*args, ctx.relu)
            want = [a for a in args if a.requires_grad]
            got = iter(torch.autograd.grad(y, want, dy))
        return tuple(next(got) if a.requires_grad else None
                     for a in args) + (None,)


def fused_conv_bn_eval(x, w, scale, shift, relu=False):
    """``relu(conv2d(x, w) * scale + shift)``: x [N, H, W, C]; w OIHW (3x3
    pad 1 or 1x1 pad 0, stride 1); scale/shift f32 [K] (the BatchNorm
    running statistics folded by the caller). Output in x's dtype."""
    return _EvalFn.apply(x, w, scale, shift, bool(relu))


# ---------------------------------------------------------------------------
# training: conv + channel statistics (K11), with an optional prologue
# ---------------------------------------------------------------------------


def _moments_vjp(co, dco, dm, dv):
    """The cotangent of ``co`` given those of ``(co, m, v)`` with ``m, v =
    _moments_ref(co)``: dco plus the statistics' share, summed in co's
    dtype as the JAX composition sums it."""
    if dm is None and dv is None:
        return dco if dco is not None else torch.zeros_like(co)
    with torch.enable_grad():
        c = co.detach().requires_grad_(True)
        m, v = _moments_ref(c)
        outs, cts = zip(*[(o, ct) for o, ct in ((m, dm), (v, dv))
                          if ct is not None])
        (g,) = torch.autograd.grad(outs, c, cts)
    return g if dco is None else dco + g


class _ConvStatsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.set_materialize_grads(False)
        if _on_card(x, "conv_stats"):
            co, m, v = _launch(x, w)
        else:
            co, m, v = _conv_stats_ref(x, w)
        ctx.save_for_backward(x, w, co)
        return co, m, v

    @staticmethod
    def backward(ctx, dco, dm, dv):
        x, w, co = ctx.saved_tensors
        g = _moments_vjp(co, dco, dm, dv)
        return _conv_bwd(g, x, w, *ctx.needs_input_grad[:2])


def conv_stats(x, w):
    """(conv output in x's dtype, its per-channel mean, its biased
    variance), the statistics in f32 from the f32 accumulator."""
    return _ConvStatsFn.apply(x, w)


class _ConvStatsPreFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, co_p, m_p, v_p, gp, bp, w, relu_in, eps_p):
        ctx.set_materialize_grads(False)
        ctx.relu_in, ctx.eps_p = relu_in, eps_p
        if _on_card(co_p, "conv_stats_pre"):
            ps, pb = _fold_bn_card(m_p, v_p, gp, bp, eps_p)
            co, m, v = _launch(co_p, w, pre=(ps, pb, relu_in))
        else:
            co, m, v = _conv_stats_pre_ref(co_p, m_p, v_p, gp, bp, w,
                                           relu_in, eps_p)
        ctx.save_for_backward(co_p, m_p, v_p, gp, bp, w, co)
        return co, m, v

    @staticmethod
    def backward(ctx, dco, dm, dv):
        *ins, w, co = ctx.saved_tensors
        g = _moments_vjp(co, dco, dm, dv)
        needs = ctx.needs_input_grad
        # the normalized input is rebuilt here (it never existed in the
        # forward) and the prologue differentiated by autograd
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ins, needs[:5])]
            ps, pb = _fold_bn(*leaves[1:5], ctx.eps_p)
            xn = _prologue(leaves[0], ps, pb, ctx.relu_in)
        dxn, dw = _conv_bwd(g, xn.detach(), w, any(needs[:5]), needs[5])
        out = [None] * 5
        want = [i for i, leaf in enumerate(leaves) if leaf.requires_grad]
        if want:
            got = torch.autograd.grad(xn, [leaves[i] for i in want], dxn)
            for i, gi in zip(want, got):
                out[i] = gi
        return (*out, dw, None, None)


def conv_stats_pre(co_p, m_p, v_p, gp, bp, w, relu_in=True, eps_p=1e-5):
    """``conv_stats`` over ``relu?(normalize(co_p; m_p, v_p, gp, bp))``,
    the normalize applied as the kernel loads ``co_p`` (the upstream
    conv's raw output)."""
    return _ConvStatsPreFn.apply(co_p, m_p, v_p, gp, bp, w, bool(relu_in),
                                 float(eps_p))


class _BnApplyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, co, m, v, gamma, beta, epsilon):
        r = torch.rsqrt(v.float() + epsilon)
        g = r * gamma.float()
        shift = beta.float() - m.float() * g
        ctx.save_for_backward(co, m, r, gamma, beta)
        return (co.float() * g + shift).to(co.dtype)

    @staticmethod
    def backward(ctx, dy):
        from ..nn.functional import _bn_train_bwd  # lazy: import cycle

        co, m, r, gamma, beta = ctx.saved_tensors
        k = co.shape[-1]
        b = (1, 1, 1, k)
        dco, dgamma, dbeta = _bn_train_bwd(
            (0, 1, 2), None,
            (co, m.float().reshape(b), r.reshape(b), gamma.reshape(b),
             beta.reshape(b)), dy)
        return (dco, None, None, dgamma.reshape(k), dbeta.reshape(k), None)


def bn_apply(co, m, v, gamma, beta, epsilon=1e-5):
    """BatchNorm normalize of a conv output given its batch statistics
    (computed already); no gradient flows to m and v from here."""
    return _BnApplyFn.apply(co, m, v, gamma, beta, float(epsilon))


def fused_conv_bn_train(x, w, gamma, beta, epsilon=1e-5):
    """(y, batch_mean, batch_var) of one unchained conv+BN unit."""
    co, m, v = conv_stats(x, w)
    return bn_apply(co, m, v, gamma, beta, epsilon), m, v
