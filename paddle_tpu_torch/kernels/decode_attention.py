"""Flash-decode attention: split-K, GQA-native, per-row length masking
(counterpart of ``paddle_tpu/pallas_kernels/decode_attention.py``).

Two entry points, each a thin wrapper over one hand-written CUDA
kernel (``csrc/decode_attention.cu``) with a plain PyTorch version
beside it:

- ``flash_decode_attention`` over the contiguous [B, max_len, KV, d]
  caches (the ``generate`` decode step, q_len <= ``MAX_DECODE_Q_LEN``);
- ``paged_flash_decode_attention`` over [num_blocks, bs, KV, d] pools
  addressed through per-row block tables (the serving engine's decode
  step, every chunked-prefill bundle and every speculative verify
  bundle, q_len <= ``MAX_PAGED_Q_LEN``). With ``ancestor_mask`` it
  scores a BFS-flattened draft tree (K8): each bundle node sees every
  committed position and, inside the bundle, only its ancestors and
  itself.

Both take QUANTIZED caches too: int8 / float8_e4m3 K/V with their
per-token-per-head f32 absmax scales (``k_scale``/``v_scale``, shaped
like the cache without the head dimension). The kernel dequantizes
``q * s / bound`` rounded to q's dtype (the prologue of the TPU kernel's
``_decode_kernel_quant``): the bf16 decode step's body each value in
registers once for all its rows, the fp32 SIMT bodies each value where
they load it, the tensor-core body each K/V tile once in shared memory.
Only the narrow bytes cross device memory.

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; there is no fallback. Each
wrapper counts its launches in ``LAUNCHES``, quantized launches under
their own ``*_quant`` keys and tree bundles under ``*_tree`` /
``*_tree_quant``; ``BODY_LAUNCHES`` splits the same launches by the
kernel body that ran (``"<name>/<body>"``).

Which body runs is a pure function of the bundle and the storage
(``bundle_body``):

| q dtype | K/V | bundle | body |
|---|---|---|---|
| bf16 | any | q_len 1 (the decode step), at most 8 rows | ``qrows``: 16-byte rows, the narrow dequant in integer and fma ops, the next keys in flight |
| bf16 | any | q_len >= 2 (chunks, verify bundles, draft levels); q_len 1 over more than 8 rows | ``mma``: bf16 tensor cores |
| fp32 | any | at most 8 rows | ``rows`` |
| fp32 | any | more rows | ``tiled``: fp32 FMA (the card-against-CPU parity path) |

The mask never enters the choice, so a causal ancestor mask and the
maskless launch take the same body. ``launch_plan`` adds the row tile
and the split of the key range.

``decode_dispatch`` / ``paged_decode_dispatch`` keep the JAX package's
gates (external mask, q_len, dtype, grad mode): a declined call runs
the plain attention math exactly where the JAX package runs XLA, and
the reason is counted in ``DISPATCH_FALLBACKS``. With ``quantized=True``
hits count under ``<model>_quant`` / ``<model>_paged_quant`` and
fallbacks under ``quant_<reason>`` / ``paged_quant_<reason>``.
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from ..quantization.intx import format_of_dtype, unpack_absmax
from ._blocks import pick_block
from ._build import load_library
from ._counts import COUNT_LOCK, count as _count

__all__ = ["flash_decode_attention", "flash_decode_attention_ref",
           "paged_flash_decode_attention", "paged_flash_decode_attention_ref",
           "decode_dispatch", "paged_decode_dispatch", "MAX_DECODE_Q_LEN",
           "MAX_PAGED_Q_LEN", "MAX_SPEC_K", "spec_tree_width",
           "spec_verify_eligibility", "ancestor_visibility", "LAUNCHES",
           "BODY_LAUNCHES", "DISPATCH_HITS", "DISPATCH_FALLBACKS",
           "reset_counters", "bundle_body", "launch_plan", "MMA_ROWS"]

# the contiguous kernel serves the short-query decode window; longer
# prompts go to the plain attention (XLA in the JAX package)
MAX_DECODE_Q_LEN = 8

# the paged kernel also serves chunked-prefill bundles and speculative
# verify bundles (q_len = spec_k + 1, or a draft tree's node count)
MAX_PAGED_Q_LEN = 256

# largest per-round draft count the serving engine accepts: the verify
# bundle must fit the paged kernel's query window
MAX_SPEC_K = MAX_PAGED_Q_LEN - 1

NEG_INF = -1e30

# the block bodies of csrc/decode_attention.cu and their codes there
_BODY_CODES = {"rows": 0, "tiled": 1, "mma": 2, "qrows": 3}

# keys per unit of the split: the SIMT bodies' shared-memory chunk (csrc
# KB), the tensor-core body's K/V tile (csrc MMA_KEYS) and, for qrows,
# four 16-key pages (a whole number of its block's steps of 16-64 keys)
_SPLIT_UNIT = {"rows": 32, "tiled": 32, "mma": 64, "qrows": 64}

# qrows: no split longer than this many keys, however many blocks the
# grid holds. On an H100 (chip_smoke.py's split_sweep rows "decode
# engine", which hold the served traffic's decode iteration, and the int8
# engine's profile line; PERF.md) Llama-2-7B's decode step (B 8, group 1)
# is fastest in 8 splits of 256 keys, in the sweep and in the engine.
# With _FILL's 2 blocks a SM, groups 2 and 4 take 8 splits as well and
# group 8 takes 16.
_QROWS_SPLIT_KEYS = 256

# rows per block of a wide bundle (more than 16 rows) in the mma body:
# four warps of 16 (csrc MMA_ROWS)
MMA_ROWS = 64

# blocks per SM the split aims at, and for the mma body a cap: its fp32
# partials (written, then read back by the merge) stay within
# 1 / _MMA_PART_SHARE of the bf16 K/V bytes the body streams. More blocks
# hide the MMA's latency and even out rows of unequal length. On an H100
# (chip_smoke.py's split_sweep and profile lines, PERF.md) 8-row verify
# bundles gain up to four splits, and a 256-token chunk at the end of a
# 2048-token table is fastest in two (four: +4%); but splits are cut
# from max_len, so a chunk early in its prompt reaches only the first:
# a prefill iteration's attention took 16.2 ms with four splits and 21.1
# with two. Eight blocks a SM and partials up to half the K/V give both
# four.
_FILL = {"rows": 4, "tiled": 2, "mma": 8, "qrows": 2}
_MMA_PART_SHARE = 2

# the qrows body over bf16 K/V (twice int8's bytes a key, so a split takes
# twice as long) aims at the rows body's 4 blocks a SM: Llama-2-7B's decode
# step keeps 8 splits (group 1, 2), group 4 takes 16 and group 8 32. On an
# H100 (chip_smoke.py's kernel and split_sweep rows, PERF.md) 16 splits at
# group 8 made K4's kernel row, whose longest row holds 2048 keys and most
# others few, 22% slower than the rows body's 32.
_QROWS_BF16_FILL = 4

LAUNCHES = {"flash_decode_attention": 0, "paged_flash_decode_attention": 0,
            "flash_decode_attention_quant": 0,
            "paged_flash_decode_attention_quant": 0,
            "paged_flash_decode_attention_tree": 0,
            "paged_flash_decode_attention_tree_quant": 0}
BODY_LAUNCHES: Counter = Counter()
DISPATCH_HITS: Counter = Counter()
DISPATCH_FALLBACKS: Counter = Counter()
def reset_counters() -> None:
    """Zero the launch counts and the dispatch hit/fallback counters."""
    with COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        BODY_LAUNCHES.clear()
        DISPATCH_HITS.clear()
        DISPATCH_FALLBACKS.clear()


def bundle_body(q_len: int, group: int, dtype,
                kv_format: str = "bf16") -> str:
    """The kernel body a bundle of ``q_len`` query tokens per row takes,
    with ``group`` query heads per kv head, queries of ``dtype`` and K/V
    stored as ``kv_format`` (``"bf16"``: q's dtype; ``"int8"``,
    ``"fp8"``): ``"rows"``, ``"qrows"``, ``"mma"`` or ``"tiled"`` (the
    table in the module docstring). The rows bodies hold at most 8 rows
    (q_len x group)."""
    gq = q_len * group
    if dtype == torch.bfloat16:
        return "qrows" if q_len == 1 and gq <= 8 else "mma"
    if dtype == torch.float32:
        return "rows" if gq <= 8 else "tiled"
    raise TypeError(f"no kernel body for {dtype} queries")


def launch_plan(q_len: int, group: int, dtype, B: int, KV: int,
                max_len: int, sm_count: int, kv_format: str = "bf16") -> dict:
    """The body, its row tile and the split of the key range for one
    launch: ``body``, ``rows`` (rows per block), ``tiles`` (row tiles per
    kv head), ``n_split`` and ``split_keys``. Splits tile [0, max_len)
    exactly in whole units of ``_SPLIT_UNIT[body]`` keys (the last split
    may run past max_len, none is empty). Every body aims at ``_FILL``
    blocks per SM (the qrows body over bf16 K/V at ``_QROWS_BF16_FILL``);
    the qrows body's splits hold at most ``_QROWS_SPLIT_KEYS`` keys (the
    unit's multiple below); the mma body keeps its fp32 partials (which
    the merge reads back) within 1 / ``_MMA_PART_SHARE`` of the bf16 K/V
    bytes it streams (whatever the storage)."""
    body = bundle_body(q_len, group, dtype, kv_format)
    gq = q_len * group
    if body in ("rows", "qrows"):
        rows = 1 << (gq - 1).bit_length()
    elif body == "tiled":
        rows = 64
    else:
        rows = 16 if gq <= 16 else MMA_ROWS
    tiles = -(-gq // rows)
    unit = _SPLIT_UNIT[body]
    n_chunks = -(-max_len // unit)
    base = B * KV * tiles
    if body == "mma":
        # partial bytes n * gq * d * 4 against K/V bytes max_len * 2 * d * 2
        cap = max(1, max_len // (_MMA_PART_SHARE * gq))
        want = max(1, min(_FILL[body] * sm_count // base, cap))
        per = -(-n_chunks // want)      # at most `want` splits
    else:
        fill = _QROWS_BF16_FILL if body == "qrows" and kv_format == "bf16" \
            else _FILL[body]
        want = max(1, -(-fill * sm_count // base))
        if body == "qrows":
            want = max(want, -(-max_len // _QROWS_SPLIT_KEYS))
        per = max(1, n_chunks // want)
        per = pick_block(n_chunks, 1 << (per.bit_length() - 1))
    n_split = -(-n_chunks // per)
    return {"body": body, "rows": rows, "tiles": tiles, "n_split": n_split,
            "split_keys": per * unit}


def _decline_reason(q_len: int, limit: int, has_mask: bool, dtype):
    if has_mask:
        # the caller brought its own attention mask: the kernel's
        # masking is position-derived only
        return "external_mask"
    if q_len > limit:
        return "q_len"
    if dtype not in (torch.float32, torch.bfloat16):
        return "dtype"
    if torch.is_grad_enabled():
        # forward-only kernel (decode is inference)
        return "grad_mode"
    return None


def decode_dispatch(model: str, *, q_len: int, has_mask: bool,
                    dtype, quantized: bool = False) -> bool:
    """True -> run ``flash_decode_attention``; False -> the plain
    attention, with the reason counted (``quantized``: the cache is an
    int8/fp8 store, counted under ``<model>_quant`` / ``quant_<reason>``)."""
    reason = _decline_reason(q_len, MAX_DECODE_Q_LEN, has_mask, dtype)
    if reason is None:
        _count(DISPATCH_HITS, model + ("_quant" if quantized else ""))
        return True
    _count(DISPATCH_FALLBACKS, ("quant_" if quantized else "") + reason)
    return False


def paged_decode_dispatch(model: str, *, q_len: int, has_mask: bool,
                          dtype, quantized: bool = False) -> bool:
    """``decode_dispatch`` for the paged decode / chunk-prefill path: the
    query window covers the prefill chunk (``MAX_PAGED_Q_LEN``), and
    outcomes count under ``<model>_paged[_quant]`` /
    ``paged_[quant_]<reason>``."""
    reason = _decline_reason(q_len, MAX_PAGED_Q_LEN, has_mask, dtype)
    if reason is None:
        _count(DISPATCH_HITS,
               model + "_paged" + ("_quant" if quantized else ""))
        return True
    _count(DISPATCH_FALLBACKS,
           ("paged_quant_" if quantized else "paged_") + reason)
    return False


def spec_tree_width(spec_tree) -> int:
    """Node count of a draft token tree with per-depth branching factors
    ``spec_tree`` (root + every level): ``[4, 2, 2]`` -> 1 + 4 + 8 + 16
    = 29, the tree verify bundle's q_len."""
    w = wl = 1
    for f in spec_tree:
        wl *= int(f)
        w += wl
    return w


def spec_verify_eligibility(spec_k: int, dtype, spec_tree=None):
    """Will a speculative verify bundle (q_len = spec_k + 1 for a chain,
    the flattened node count for a ``spec_tree``) take the paged kernel,
    and if not, why? Called once per engine at construction; a decline
    is counted in ``DISPATCH_FALLBACKS`` under ``spec_<reason>`` /
    ``spec_tree_<reason>``. Returns (ok, reason)."""
    if spec_tree is not None:
        prefix, width = "spec_tree_", spec_tree_width(spec_tree)
    else:
        prefix, width = "spec_", spec_k + 1
    reason = None
    if width > MAX_PAGED_Q_LEN:
        reason = "q_len"
    elif str(dtype).split(".")[-1] not in ("float32", "bfloat16"):
        reason = "dtype"
    if reason is None:
        return True, None
    _count(DISPATCH_FALLBACKS, prefix + reason)
    return False, reason


def ancestor_visibility(start, mask, T: int):
    """[B, q_len, T] bool: which of T cache positions bundle token i of
    row b sees when the bundle sits at positions start[b] .. start[b] +
    q_len - 1 under the ancestor ``mask`` [B, q_len, q_len] (True =
    visible): every position before the bundle, and bundle node j where
    mask[b, i, j]; nothing past the bundle."""
    B, q_len = mask.shape[0], mask.shape[1]
    rel = torch.arange(T, device=mask.device)[None, :] \
        - start.to(mask.device).long()[:, None]              # [B, T]
    in_bundle = (rel >= 0) & (rel < q_len)
    anc = torch.gather(mask, 2, rel.clamp(0, q_len - 1)[:, None, :]
                       .expand(B, q_len, T))
    return (rel < 0)[:, None, :] | (in_bundle[:, None, :] & anc)


def _positions(positions, B: int, device) -> torch.Tensor:
    """Per-row int32 [B] positions from an int, a 0-d or a [B] tensor."""
    if isinstance(positions, torch.Tensor):
        p = positions.to(device=device, dtype=torch.int32)
        if p.dim() == 0:
            p = p.expand(B)
        return p.contiguous()
    return torch.full((B,), int(positions), dtype=torch.int32, device=device)


def _check_heads(q, kv_heads: int) -> int:
    H = q.shape[2]
    if H % kv_heads:
        raise ValueError(f"heads ({H}) not a multiple of kv_heads ({kv_heads})")
    return H // kv_heads


def _attend_ref(q, kc, vc, lens, scale: float, mask=None):
    """Plain masked softmax attention of the query bundle over a
    contiguous view [B, T, KV, d]; row r = i*group + g of kv head h sits
    at position (len - q_len) + r // group and sees keys kpos <= it.
    With ``mask`` [B, q_len, q_len] (bool, True = visible), token i sees
    every key before the bundle and bundle node j where mask[b, i, j]."""
    B, q_len, H, d = q.shape
    T, KV = kc.shape[1], kc.shape[2]
    group = H // KV
    gq = q_len * group
    qf = q.float().reshape(B, q_len, KV, group, d).permute(0, 2, 1, 3, 4) \
        .reshape(B, KV, gq, d)
    kf = kc.float().permute(0, 2, 1, 3)
    vf = vc.float().permute(0, 2, 1, 3)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale      # [B, KV, gq, T]
    rows = torch.arange(gq, device=q.device) // group
    kpos = torch.arange(T, device=q.device)
    qbase = lens.long() - q_len                              # [B]
    if mask is None:
        qpos = qbase[:, None] + rows[None, :]                # [B, gq]
        vis = kpos[None, None, :] <= qpos[:, :, None]        # [B, gq, T]
    else:
        vis = ancestor_visibility(qbase, mask, T)[:, rows]   # [B, gq, T]
    vis = vis[:, None]                                       # [B, 1, gq, T]
    s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, vf) / l.clamp_min(1e-30)
    o = o.reshape(B, KV, q_len, group, d).permute(0, 2, 1, 3, 4) \
        .reshape(B, q_len, H, d)
    return o.to(q.dtype)


def _scales(k_scale, v_scale):
    """True for a quantized call; raises when only one scale is given."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    return k_scale is not None


def _dequant(c, s, dtype):
    """A quantized cache or pool widened to ``dtype`` through
    ``unpack_absmax`` (values and [.., KV] scales of the same layout)."""
    return unpack_absmax(c, s[..., None], format_of_dtype(c.dtype), dtype)


def _take_blocks(pool, bt):
    """``pool[bt]`` reshaped to [B, nb * bs, ...]; narrow pools are
    indexed through their bytes (some builds lack fp8 indexing)."""
    B, nb = bt.shape
    src = pool.view(torch.uint8) if pool.element_size() == 1 \
        and pool.is_floating_point() else pool
    out = src[bt].reshape((B, nb * pool.shape[1]) + tuple(pool.shape[2:]))
    return out.view(pool.dtype)


def flash_decode_attention_ref(q, k_cache, v_cache, positions,
                               sm_scale=None, k_scale=None, v_scale=None):
    """Plain PyTorch version of ``flash_decode_attention``; a quantized
    cache is dequantized into q's dtype first."""
    B, q_len, _, d = q.shape
    _check_heads(q, k_cache.shape[2])
    if _scales(k_scale, v_scale):
        k_cache = _dequant(k_cache, k_scale, q.dtype)
        v_cache = _dequant(v_cache, v_scale, q.dtype)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    pos = _positions(positions, B, q.device)
    lens = torch.clamp(pos + q_len, max=k_cache.shape[1])
    return _attend_ref(q, k_cache, v_cache, lens, scale)


def paged_flash_decode_attention_ref(q, k_pool, v_pool, block_table,
                                     positions, sm_scale=None, k_scale=None,
                                     v_scale=None, ancestor_mask=None):
    """Plain PyTorch version of ``paged_flash_decode_attention``: gather
    the rows' blocks into a contiguous view (dequantized into q's dtype
    for a quantized pool), then attend (under the ancestor mask of a
    tree bundle)."""
    B, q_len, _, d = q.shape
    _check_heads(q, k_pool.shape[2])
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    bt = block_table.to(device=q.device).long()
    nb, bs = bt.shape[1], k_pool.shape[1]
    kc, vc = _take_blocks(k_pool, bt), _take_blocks(v_pool, bt)
    if _scales(k_scale, v_scale):
        kc = _dequant(kc, _take_blocks(k_scale, bt), q.dtype)
        vc = _dequant(vc, _take_blocks(v_scale, bt), q.dtype)
    pos = _positions(positions, B, q.device)
    lens = torch.clamp(pos + q_len, max=nb * bs)
    mask = _check_mask(ancestor_mask, B, q_len, q.device)
    return _attend_ref(q, kc, vc, lens, scale, mask)


_SM_COUNT: dict = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _SM_COUNT[idx]


# storage codes of the C entry: 0 = q's dtype, 1 = int8, 2 = fp8 e4m3
_KV_CODES = {"int8": 1, "fp8": 2}


def _check_inputs(name, q, k, v, ks, vs, scale_shape, tensors):
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    if ks is None:
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"{name}: q/k/v must share float32 or bfloat16, "
                            f"got {q.dtype}/{k.dtype}/{v.dtype}")
        return 0
    fmt = format_of_dtype(k.dtype)
    if fmt == "bf16" or v.dtype != k.dtype:
        raise TypeError(f"{name}: quantized k/v must both be int8 or "
                        f"float8_e4m3fn, got {k.dtype}/{v.dtype}")
    for s in (ks, vs):
        if s.dtype != torch.float32 or tuple(s.shape) != scale_shape:
            raise ValueError(f"{name}: k_scale/v_scale must be float32 "
                             f"{scale_shape}, got {s.dtype} "
                             f"{tuple(s.shape)}")
    return _KV_CODES[fmt]


def _check_mask(ancestor_mask, B: int, q_len: int, device):
    """The [B, q_len, q_len] ancestor mask as a contiguous bool tensor on
    ``device`` (None stays None)."""
    if ancestor_mask is None:
        return None
    if tuple(ancestor_mask.shape) != (B, q_len, q_len):
        raise ValueError(f"ancestor_mask must be [B={B}, q_len={q_len}, "
                         f"q_len={q_len}], got "
                         f"{tuple(ancestor_mask.shape)}")
    return ancestor_mask.to(device=device, dtype=torch.bool).contiguous()


def _launch(name: str, q, k, v, ks, vs, pos, bt, max_len: int, bs: int,
            nb: int, scale: float, mask=None):
    """Validate, plan (``launch_plan``), allocate the partials and launch
    the CUDA body and its merge on the current stream."""
    B, q_len, H, d = q.shape
    KV = k.shape[2]
    group = _check_heads(q, KV)
    tensors = [q, k, v, pos] + ([bt] if bt is not None else []) \
        + ([ks, vs] if ks is not None else []) \
        + ([mask] if mask is not None else [])
    kv_code = _check_inputs(name, q, k, v, ks, vs, tuple(k.shape[:3]),
                            tensors)
    if d not in (64, 128):
        raise ValueError(f"{name}: head_dim {d} not built (64 or 128)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any((t.data_ptr() % 16) for t in (q, k, v)):
        raise ValueError(f"{name}: q/k/v must be 16-byte aligned")
    if pos.dtype != torch.int32 or (bt is not None
                                    and bt.dtype != torch.int32):
        raise TypeError(f"{name}: positions and block table must be int32")
    if mask is not None and (bt is None or q_len > MAX_PAGED_Q_LEN):
        raise ValueError(f"{name}: an ancestor mask needs a paged pool and "
                         f"q_len <= {MAX_PAGED_Q_LEN}, got q_len {q_len}")
    plan = launch_plan(q_len, group, q.dtype, B, KV, max_len,
                       _sm_count(q.device),
                       format_of_dtype(k.dtype) if kv_code else "bf16")
    n_split = plan["n_split"]
    gq = q_len * group
    o_part = torch.empty((B * KV, n_split, gq, d), dtype=torch.float32,
                         device=q.device)
    m_part = torch.empty((B * KV, n_split, gq), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    out = torch.empty_like(q)
    lib = load_library("decode_attention.cu")
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    rc = lib.paddle_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ks), ptr(vs),
        pos.data_ptr(), ptr(bt), ptr(mask), o_part.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16),
        kv_code, B, q_len, H, KV, d, max_len, bs, nb, n_split,
        plan["split_keys"], _BODY_CODES[plan["body"]], plan["rows"],
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    _count(LAUNCHES, name)
    _count(BODY_LAUNCHES, f"{name}/{plan['body']}")
    return out


def flash_decode_attention(q, k_cache, v_cache, positions, sm_scale=None,
                           k_scale=None, v_scale=None):
    """Flash-decode attention over the contiguous KV caches.

    q: [B, q_len, heads, d]; k_cache/v_cache: [B, max_len, kv_heads, d]
    with this step's tokens ALREADY written at [pos, pos + q_len);
    ``positions``: int or per-row [B] tensor. Query i of row b sits at
    position positions[b] + i and attends cache positions <= it; query
    head j reads kv head j // (heads // kv_heads). Returns
    [B, q_len, heads, d] in q's dtype.

    Quantized caches: int8/fp8 k/v with ``k_scale``/``v_scale``
    [B, max_len, kv_heads] f32 (``make_kv_caches(kv_format=...)``'s
    ``ks``/``vs``), dequantized in the kernel; counted under
    ``flash_decode_attention_quant``."""
    quant = _scales(k_scale, v_scale)
    if q.device.type == "cpu":
        return flash_decode_attention_ref(q, k_cache, v_cache, positions,
                                          sm_scale, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device "
                         f"{q.device}")
    B, _, _, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    pos = _positions(positions, B, q.device)
    max_len = k_cache.shape[1]
    name = "flash_decode_attention" + ("_quant" if quant else "")
    return _launch(name, q, k_cache, v_cache, k_scale, v_scale, pos, None,
                   max_len, 1, 1, scale)


def paged_flash_decode_attention(q, k_pool, v_pool, block_table, positions,
                                 sm_scale=None, k_scale=None, v_scale=None,
                                 ancestor_mask=None):
    """Flash-decode attention over PAGED KV pools.

    q: [B, q_len, heads, d] (a decode step or one chunked-prefill
    bundle); k_pool/v_pool: [num_blocks, block_size, kv_heads, d] with
    this step's tokens already scattered (``paged_kv_cache_write``);
    ``block_table``: [B, nb] int32, row b's logical block j lives in pool
    block ``block_table[b, j]``; ``positions`` as in
    ``flash_decode_attention``, with max_len = nb * block_size.

    Quantized pools: int8/fp8 k/v with ``k_scale``/``v_scale``
    [num_blocks, block_size, kv_heads] f32 (``make_paged_kv_pools``'
    ``ks``/``vs``), read through the same table and dequantized in the
    kernel; counted under ``paged_flash_decode_attention_quant``.

    Tree-speculative bundles (K8): ``ancestor_mask`` [B, q_len, q_len]
    bool (True = bundle node i may attend bundle node j) replaces only
    the in-bundle causal mask; every query still attends all of its
    row's past KV. A causal lower-triangular mask gives the maskless
    output bit for bit. Counted under ``paged_flash_decode_attention_tree``
    (``_tree_quant`` over quantized pools)."""
    quant = _scales(k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_flash_decode_attention_ref(q, k_pool, v_pool,
                                                block_table, positions,
                                                sm_scale, k_scale, v_scale,
                                                ancestor_mask)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_attention: unsupported device "
                         f"{q.device}")
    B, _, _, d = q.shape
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be [B={B}, nb], got "
                         f"{tuple(block_table.shape)}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    pos = _positions(positions, B, q.device)
    bt = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    nb, bs = bt.shape[1], k_pool.shape[1]
    mask = _check_mask(ancestor_mask, B, q.shape[1], q.device)
    name = "paged_flash_decode_attention" + (
        "_tree" if mask is not None else "") + ("_quant" if quant else "")
    # the kernel reads the mask as bytes, nonzero = visible
    return _launch(name, q, k_pool, v_pool, k_scale, v_scale, pos, bt,
                   nb * bs, bs, nb, scale,
                   mask.view(torch.uint8) if mask is not None else None)
