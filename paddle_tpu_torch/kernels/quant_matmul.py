"""Weight-only quantized matmul with the dequant fused into the weight
load (counterpart of ``paddle_tpu/pallas_kernels/quant_matmul.py``).

``quant_matmul(x [..., K], qweight [N, K] int8/fp8, scale [N] f32)``
computes ``x @ qweight.to(x.dtype).T`` with fp32 accumulation, multiplies
the fp32 sum by the per-output-channel ``scale`` and casts the result to
x's dtype: the TPU kernel's math, whose per-channel scale moves from the
weight to the accumulator. Widening int8 or e4m3 to bf16 is exact, so
kernel and plain version differ only by summation order.

The wrapper takes its plain version (``quant_matmul_ref``) only for
tensors on the CPU. For CUDA tensors it launches the hand-written kernel
of ``csrc/quant_matmul.cu`` or raises; launches are counted in
``LAUNCHES`` and, by kernel body (``qmm_body``), in ``BODY_LAUNCHES``:
``gemv`` (M <= 16; in bf16 its launch geometry is ``gemv_plan``),
``wgmma`` (bf16, M > 16; its launch geometry is ``qmm_plan``) and
``simt`` (fp32, M > 16). ``quant_matmul_dispatch``
keeps the JAX package's gates (dtype, grad mode) with hits counted by
format and fallbacks by reason.
"""

from __future__ import annotations

import functools
from collections import Counter

import torch

from ..quantization.intx import format_of_dtype
from ._build import load_library
from ._counts import COUNT_LOCK, count as _count

__all__ = ["quant_matmul", "quant_matmul_ref", "quant_matmul_dispatch",
           "qmm_body", "qmm_plan", "qmm_items", "gemv_plan", "gemv_items",
           "LAUNCHES", "BODY_LAUNCHES",
           "DISPATCH_HITS", "DISPATCH_FALLBACKS", "reset_counters"]

LAUNCHES = {"quant_matmul": 0}
# launches by body: "quant_matmul/gemv", "quant_matmul/wgmma",
# "quant_matmul/simt"
BODY_LAUNCHES: Counter = Counter()
DISPATCH_HITS: Counter = Counter()
DISPATCH_FALLBACKS: Counter = Counter()
def reset_counters() -> None:
    """Zero the launch counts and the dispatch hit/fallback counters."""
    with COUNT_LOCK:
        LAUNCHES["quant_matmul"] = 0
        BODY_LAUNCHES.clear()
        DISPATCH_HITS.clear()
        DISPATCH_FALLBACKS.clear()


# ---------------------------------------------------------------------------
# kernel bodies and the wgmma body's launch plan (mirrored and checked by
# csrc/quant_matmul.cu)
# ---------------------------------------------------------------------------

SMALL_M = 16           # rows up to which the GEMV body runs
BODIES = ("gemv", "wgmma", "simt")   # body codes 0, 1, 2 of the C entry
ROWS = 128             # weight rows per item: two consumer warpgroups
KSTEP = 64             # k per ring slot
MAX_STAGES = 8
MAX_SPLITS = 8
SMEM_MAX = 232448      # shared bytes a block can use on sm_90


def qmm_body(M: int, dtype) -> str:
    """The kernel body a launch of ``M`` rows of ``dtype`` takes."""
    if M <= SMALL_M:
        return "gemv"
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def _smem_bytes(tn: int, stages: int) -> int:
    # 1024 alignment slack, the x and weight rings, the epilogue's two
    # 64-column panels of tn rows, two mbarriers a stage
    return 1024 + stages * (tn * 128 + ROWS * KSTEP) + 2 * tn * 128 \
        + 16 * stages


_PLAN_KEYS = ("tn", "token_tiles", "row_tiles", "splits", "per", "stages",
              "smem", "items", "grid")


@functools.lru_cache(maxsize=4096)
def _plan_args(M: int, N: int, K: int, sms: int) -> tuple:
    # qmm_plan's values in _PLAN_KEYS order, the C entry's argument order;
    # cached, since a serving forward asks for the same few shapes
    # hundreds of times
    tn = 64 if M <= 64 else 128 if M <= 128 else 256
    token_tiles, row_tiles = -(-M // tn), -(-N // ROWS)
    steps = -(-K // KSTEP)
    tiles = token_tiles * row_tiles
    splits = 1 if 2 * tiles >= sms else min(sms // tiles, MAX_SPLITS)
    per = -(-steps // min(splits, steps))
    splits = -(-steps // per)
    slot = tn * 128 + ROWS * KSTEP
    stages = min(MAX_STAGES,
                 (SMEM_MAX - _smem_bytes(tn, 0)) // (slot + 16))
    items = tiles * splits
    return (tn, token_tiles, row_tiles, splits, per, stages,
            _smem_bytes(tn, stages), items, min(items, sms))


def qmm_plan(M: int, N: int, K: int, sms: int) -> dict:
    """Launch geometry of the wgmma body for x [M, K] against w [N, K]
    on a card of ``sms`` SMs. A work item is (128 weight rows, ``tn``
    tokens, one K split of ``per`` 64-k steps); ``tn`` is 64, 128 or 256
    from M, and M past 256 walks 256-token tiles. K is split only while
    the output tiles alone leave the SMs less than half busy, and no
    further than one item per SM (at most ``MAX_SPLITS``): each split
    adds its [M, N] f32 partial to the device memory traffic, and a
    second launch (``qmm_reduce``) sums them in split order. The splits
    made are ceil(steps / per), so none is empty. The ring takes as many
    stages as shared memory holds."""
    return dict(zip(_PLAN_KEYS, _plan_args(M, N, K, sms)))


# the bf16 GEMV (body "gemv" in bf16, csrc/quant_matmul.cu qmm_gemv_stream)
GEMV_WARPS = 8         # warps a block, each a run of a tile's k steps
_GEMV_KEYS = ("step_round", "x_tiles", "groups", "splits", "per", "rounds",
              "smem", "block_groups", "grid")


@functools.lru_cache(maxsize=4096)
def _gemv_args(M: int, N: int, K: int, sms: int) -> tuple:
    # gemv_plan's values in _GEMV_KEYS order, the C entry's argument order
    mt = -(-M // 8)
    u = 4 if mt == 1 else 2
    per = -(-(-(-K // KSTEP)) // GEMV_WARPS)
    groups = -(-N // 8)
    grid = min(sms, groups)
    return (u, mt, groups, 1, per, -(-per // u), 0, -(-groups // grid), grid)


def gemv_plan(M: int, N: int, K: int, sms: int) -> dict:
    """Launch geometry of the bf16 GEMV (M <= 16) for x [M, K] against
    w [N, K] on a card of ``sms`` SMs: one block of ``GEMV_WARPS`` warps
    a SM (``grid``); block b owns weight rows [8 (b G // grid), 8 ((b +
    1) G // grid)) of the G = ``groups`` 8-row groups, in 16-row tiles
    (the last maybe half full), so the blocks' rows differ by at most 8.
    A tile's K is split in runs of ``per`` 64-column steps, one a warp,
    walked in ``rounds`` rounds of ``step_round`` steps (4 at M <= 8, 2
    above: two rounds of loads fit the registers)."""
    return dict(zip(_GEMV_KEYS, _gemv_args(M, N, K, sms)))


def gemv_items(plan: dict, N: int, K: int):
    """The GEMV plan's work in launch order, as its warps walk it:
    (block, warp, rows n0..n1, k0..k1) for every tile of the block and
    the warp's run of k steps, clipped at the block's rows, N and K
    (empty runs left out)."""
    per, grid, groups = plan["per"], plan["grid"], plan["groups"]
    steps = -(-K // KSTEP)
    out = []
    for blk in range(grid):
        r0 = blk * groups // grid * 8
        r1 = min((blk + 1) * groups // grid * 8, N)
        for n0 in range(r0, r1, 16):
            for warp in range(GEMV_WARPS):
                s0, s1 = warp * per, min(steps, (warp + 1) * per)
                if s0 < s1:
                    out.append((blk, warp, n0, min(n0 + 16, r1),
                                s0 * KSTEP, min(s1 * KSTEP, K)))
    return out


_NO_PLAN = (0, 0, 0, 1, 0, 0, 0, 0, 0)   # the fp32 bodies


def qmm_items(plan: dict, M: int, N: int, K: int):
    """The plan's work items in launch order, as the body walks them:
    (rows n0..n1 of the weight, tokens m0..m1, k0..k1), clipped at N, M
    and K."""
    tn, per = plan["tn"], plan["per"]
    out = []
    for item in range(plan["items"]):
        sp, tile = item % plan["splits"], item // plan["splits"]
        n0 = tile // plan["token_tiles"] * ROWS
        m0 = tile % plan["token_tiles"] * tn
        k0 = sp * per * KSTEP
        out.append((n0, min(n0 + ROWS, N), m0, min(m0 + tn, M), k0,
                    min(k0 + per * KSTEP, K)))
    return out


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device) -> int:
    return _sms_of(device.index if device.index is not None
                   else torch.cuda.current_device())


# per (device, stream): the split partials' f32 scratch, grown to the
# largest split launch. Launches on one stream run one after another and
# each writes the partials before it reads them, so they share it: a
# split product allocates nothing.
_SCRATCH: dict = {}


def _split_scratch(device, stream: int, n: int) -> int:
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[key] = torch.empty(n, dtype=torch.float32,
                                          device=device)
    return buf.data_ptr()


def quant_matmul_dispatch(*, dtype, fmt: str) -> bool:
    """True -> run ``quant_matmul``; False -> the plain weight-only
    linear (``nn.quant.weight_only_linear``), with the reason counted."""
    reason = None
    if dtype not in (torch.float32, torch.bfloat16):
        reason = "dtype"
    elif torch.is_grad_enabled():
        # forward-only kernel: quantized weights are a serving artifact
        reason = "grad_mode"
    if reason is None:
        _count(DISPATCH_HITS, fmt)
        return True
    _count(DISPATCH_FALLBACKS, reason)
    return False


def quant_matmul_ref(x, qweight, scale):
    """Plain PyTorch version of ``quant_matmul`` (the kernel's math):
    fp32 product of x and the widened weight, times the scale, cast."""
    w = qweight.to(x.dtype).float()
    out = torch.matmul(x.float(), w.t()) * scale.float()
    return out.to(x.dtype)


def _check(x2, qweight, scale):
    M, K = x2.shape
    N = qweight.shape[0]
    if qweight.dim() != 2 or qweight.shape[1] != K:
        raise ValueError(f"quant_matmul: qweight must be [N, K={K}], got "
                         f"{tuple(qweight.shape)}")
    if tuple(scale.shape) != (N,) or scale.dtype != torch.float32:
        raise ValueError(f"quant_matmul: scale must be float32 [N={N}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_matmul: x must be float32 or bfloat16, got "
                        f"{x2.dtype}")
    if format_of_dtype(qweight.dtype) == "bf16":
        raise TypeError(f"quant_matmul: qweight must be int8 or "
                        f"float8_e4m3fn, got {qweight.dtype}")
    if K % 16:
        raise ValueError(f"quant_matmul: K ({K}) must be a multiple of 16")
    if any(t.device != x2.device for t in (qweight, scale)):
        raise ValueError(f"quant_matmul: all inputs must be on {x2.device}")
    if not all(t.is_contiguous() for t in (x2, qweight, scale)):
        raise ValueError("quant_matmul: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (x2, qweight)):
        raise ValueError("quant_matmul: x and qweight must be 16-byte "
                         "aligned")


def quant_matmul(x, qweight, scale):
    """``x [..., K] @ dequant(qweight [N, K]).T`` -> [..., N] in x's
    dtype; ``scale`` [N] f32 is the per-output-channel dequant multiplier
    (``nn.quant.weight_quantize``'s convention)."""
    if x.device.type == "cpu":
        return quant_matmul_ref(x, qweight, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    lead = tuple(x.shape[:-1])
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    _check(x2, qweight, scale)
    M, N = x2.shape[0], qweight.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M:
        body = qmm_body(M, x.dtype)
        if body == "wgmma":
            plan = _plan_args(M, N, K, _sm_count(x.device))
        elif x.dtype == torch.bfloat16:
            plan = _gemv_args(M, N, K, _sm_count(x.device))
        else:
            plan = _NO_PLAN
        stream = torch.cuda.current_stream(x.device).cuda_stream
        part = _split_scratch(x.device, stream, plan[3] * M * N) \
            if plan[3] > 1 else None   # split K: the f32 partials
        lib = load_library("quant_matmul.cu")
        rc = lib.paddle_quant_matmul(
            x2.data_ptr(), qweight.data_ptr(), scale.data_ptr(),
            out.data_ptr(), part, int(x.dtype == torch.bfloat16),
            int(qweight.dtype != torch.int8), M, N, K,
            BODIES.index(body), *plan, stream)
        if rc != 0:
            raise RuntimeError(f"quant_matmul: kernel launch failed "
                               f"(cudaError {rc})")
        _count(LAUNCHES, "quant_matmul")
        _count(BODY_LAUNCHES, f"quant_matmul/{body}")
    return out.reshape(lead + (N,))
