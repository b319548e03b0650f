"""Counter-based random numbers: the port's copy of the part of
``jax.random`` (threefry2x32, the default PRNG) that the JAX package's
sampling uses, bit for bit.

A key is a ``[..., 2]`` int64 tensor holding the two uint32 words of a
JAX key (``jax.random.PRNGKey(0)`` is ``[0, 0]``). int64 carries the
uint32 arithmetic: every add and rotate is masked back to 32 bits, which
works the same on the CPU and on the card (most torch ops lack
``uint32``). There is no global generator: every function takes its
key, so the same code gives the same bits on either device.

The semantics are those of jax with ``jax_threefry_partitionable`` on
(its default): ``split(key)[i]`` and ``fold_in(key, i)`` are both
``threefry(key, (0, i))``, and ``random_bits`` over a shape hashes the
flat element index ``(0, i)`` and takes ``y1 ^ y2``, its low byte or half
word for narrower draws. ``uniform`` sets the mantissa bits of a float
in [1, 2) and subtracts 1; a bfloat16 draw takes 8 random bits (jax
draws 8 bits for any float with fewer than 8 mantissa bits), float32
takes 32. ``gumbel`` is the "low" mode, ``-log(-log(u))`` with u in
[tiny, 1), each log taken in float64 and rounded; ``categorical`` is
``argmax(gumbel + logits)``, first index on ties.
"""

from __future__ import annotations

import torch

__all__ = ["MASK32", "threefry2x32", "PRNGKey", "split", "fold_in",
           "chain_key", "random_bits", "uniform", "gumbel", "categorical"]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds (Random123's rotations and key
    schedule): key words ``k1, k2`` and counter words ``x1, x2`` (int64
    tensors of uint32 values, broadcast together, or Python ints) -> the
    two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x1, x2


def PRNGKey(seed: int, device=None):
    """``jax.random.PRNGKey(seed)``: the [2] key ``[0, seed mod 2^32]``
    (jax truncates an int seed to 32 bits)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _hash(key, counter):
    """threefry(key, (0, counter)) -> [..., 2]; ``key`` [..., 2] and
    ``counter`` broadcast against ``key[..., 0]``."""
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(counter),
                          counter)
    return torch.stack([y1, y2], dim=-1)


def split(key, num: int = 2):
    """``jax.random.split``: [..., 2] keys -> [..., num, 2]."""
    cnt = torch.arange(num, dtype=torch.int64, device=key.device)
    return _hash(key[..., None, :], cnt)


def fold_in(key, data):
    """``jax.random.fold_in``: mix ``data`` (an int or an integer tensor,
    taken mod 2^32 and broadcast against ``key[..., 0]``) into the
    [..., 2] keys."""
    if isinstance(data, int):      # a fill, not a host-to-device copy
        d = torch.full((), data & MASK32, dtype=torch.int64,
                       device=key.device)
    else:
        d = torch.as_tensor(data, dtype=torch.int64,
                            device=key.device) & MASK32
    d = torch.broadcast_to(d, torch.broadcast_shapes(d.shape,
                                                     key.shape[:-1]))
    return _hash(key.expand(d.shape + (2,)), d)


def chain_key(seed: int, n: int, device=None):
    """``PRNGKey(seed)`` after ``n`` links of ``key = split(key)[0]``,
    walked on the host in Python ints (one small copy to ``device`` at
    the end, instead of n launches of ``split``): the [2] key."""
    k1, k2 = 0, int(seed) & MASK32
    for _ in range(n):
        k1, k2 = threefry2x32(k1, k2, 0, 0)
    return torch.tensor([k1, k2], dtype=torch.int64, device=device)


def random_bits(key, bit_width: int, shape):
    """``jax.random.bits``: ``bit_width`` (8, 16 or 32) random bits over
    ``shape`` per key, as int64 values; [..., 2] keys give
    [..., *shape] (each key draws its own ``shape``)."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    cnt = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k = key.reshape(lead + (1,) * len(shape) + (2,))
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(cnt), cnt)
    bits = y1 ^ y2
    return bits if bit_width == 32 else bits & ((1 << bit_width) - 1)


# float layout per dtype: (bits, mantissa bits, integer view dtype)
_LAYOUT = {torch.float32: (32, 23, torch.int32),
           torch.bfloat16: (16, 7, torch.int16),
           torch.float16: (16, 10, torch.int16)}


def uniform(key, shape, dtype=torch.float32, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in ``dtype`` over [minval, maxval): the
    random bits shifted into the mantissa of a float in [1, 2), minus 1,
    scaled, then clamped below at minval (all in ``dtype``)."""
    if dtype not in _LAYOUT:
        raise TypeError(f"uniform supports {sorted(map(str, _LAYOUT))}, "
                        f"got {dtype}")
    nbits, nmant, idt = _LAYOUT[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, rng_bits, shape)
    one = torch.tensor(1.0, dtype=dtype).view(idt).item() & ((1 << nbits) - 1)
    fbits = (bits >> (rng_bits - nmant)) | one
    floats = fbits.to(idt).view(dtype) - torch.ones((), dtype=dtype,
                                                    device=key.device)
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, shape, dtype=torch.float32):
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))`` with u
    uniform over [tiny, 1) in ``dtype``, each log rounded to ``dtype`` as
    the reference rounds each op. The logs are taken in float64, so each
    is the correctly rounded value on any device: float32 log
    implementations differ in their last bits and, for u near 1, in
    relative accuracy, which the outer log turns into a large error of
    the largest draws."""
    u = uniform(key, shape, dtype, minval=torch.finfo(dtype).tiny)
    y = (-torch.log(u.double())).to(dtype)
    return (-torch.log(y.double())).to(dtype)


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis: the
    index of the largest ``gumbel + logits`` (the first on ties). A [2]
    key draws the whole of ``logits`` from one counter range (jax's
    draw for one key over a [B, V] array); [B, 2] keys draw each row of
    a [B, V] ``logits`` with its own key (``vmap`` over rows)."""
    if key.dim() == 1:
        g = gumbel(key, logits.shape, logits.dtype)
    else:
        g = gumbel(key, logits.shape[key.dim() - 1:], logits.dtype)
    return torch.argmax(g + logits, dim=-1)
