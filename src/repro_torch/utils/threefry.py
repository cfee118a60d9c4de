"""The reference's counter-based random streams: threefry2x32 as
``jax.random`` runs it (``jax_threefry_partitionable=True``, the default of
jax 0.9), in torch tensor ops.

A key is a pair of uint32 words held as a tuple of Python ints. Key
derivation (``PRNGKey``, ``fold_in``, ``split``) and the samplers
(``random_bits``, ``uniform``, ``randint``, ``bernoulli``, ``permutation``)
reproduce ``jax.random`` bit for bit; ``normal`` follows ``_normal_real``
(a uniform draw over ``(nextafter(-1, 0), 1)``, then ``sqrt(2)·erfinv``),
whose ``erfinv`` is float maths and agrees to a few ulp.

Words are carried in int64 masked to 32 bits: torch has no shifts on
``uint32`` and its ``uint32`` arithmetic does not wrap everywhere. Integer
ops are exact, so a draw gives the same bits on the CPU and on the card and
can run on the device that will hold the result. Samplers work through the
flat index in chunks, so a draw of a few hundred million words needs a few
GB of temporaries, not tens.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

Key = tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 24  # flat elements per pass of the hash


def PRNGKey(seed: int) -> Key:  # noqa: N802 - jax.random's name
    """``jax.random.PRNGKey(seed)``: the low 32 bits of the seed, high word 0
    (the reference runs with 32-bit integers)."""
    return (0, int(seed) & _M32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the counter pairs ``(x0, x1)`` (int64 tensors
    of uint32 values) under ``key``: 20 rounds, a key injection every 4."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _hash_words(key: Key, words: list[int]) -> list[int]:
    """``threefry_2x32(key, words)`` on a few words: split in halves, hashed
    pairwise (an odd count padded with a zero), concatenated."""
    n = len(words)
    padded = words + [0] * (n % 2)
    half = len(padded) // 2
    t = torch.tensor(padded, dtype=torch.int64)
    y0, y1 = threefry2x32(key, t[:half], t[half:])
    return torch.cat([y0, y1]).tolist()[:n]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the key hashed with ``(0, data)``."""
    a, b = _hash_words(key, [0, int(data) & _M32])
    return (a, b)


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split`` (partitionable): key ``i`` is the hash of the
    counter pair ``(0, i)``."""
    i = torch.arange(num, dtype=torch.int64)
    y0, y1 = threefry2x32(key, i >> 32, i & _M32)
    return list(zip(y0.tolist(), y1.tolist()))


def _bits(key: Key, lo: int, hi: int, device: Any) -> torch.Tensor:
    """The words of flat elements ``[lo, hi)``: element ``i`` is ``y0 ^ y1``
    of the hash of the counter pair ``(i >> 32, i & 0xFFFFFFFF)``."""
    i = torch.arange(lo, hi, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, i >> 32, i & _M32)
    return y0 ^ y1


def _filled(shape, dtype, device, fill) -> torch.Tensor:
    """A tensor of ``shape`` whose flat elements ``[lo, hi)`` are
    ``fill(lo, hi)``, computed a chunk at a time."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    for lo in range(0, n, _CHUNK):
        hi = min(lo + _CHUNK, n)
        out[lo:hi] = fill(lo, hi)
    return out.reshape(shape)


def random_bits(key: Key, shape, device: Any = "cpu") -> torch.Tensor:
    """``jax.random.bits`` of 32 bits per element, as int64 uint32 values."""
    return _filled(shape, torch.int64, device, lambda lo, hi: _bits(key, lo, hi, device))


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) from 32-bit words: the top 23 bits as the mantissa of a
    number in [1, 2), less 1 (exact)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 rounded once, as the reference's compiler
    contracts it: the product of two float32 values is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _uniform_chunk(key: Key, lo: int, hi: int, minval: float, maxval: float, device: Any) -> torch.Tensor:
    f = _unit_floats(_bits(key, lo, hi, device))
    if minval == 0.0 and maxval == 1.0:
        return f
    low = torch.tensor(minval, dtype=torch.float32, device=device)
    scale = torch.tensor(maxval, dtype=torch.float32, device=device) - low
    return torch.maximum(low, _fma(f, scale, low))


def uniform(key: Key, shape, minval: float = 0.0, maxval: float = 1.0, device: Any = "cpu") -> torch.Tensor:
    """``jax.random.uniform`` in float32 over ``[minval, maxval)``."""
    return _filled(shape, torch.float32, device,
                   lambda lo, hi: _uniform_chunk(key, lo, hi, minval, maxval, device))


def bernoulli(key: Key, p: float, shape, device: Any = "cpu") -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low"): a float32 uniform below ``p``."""
    return uniform(key, shape, device=device) < torch.tensor(p, dtype=torch.float32, device=device)


def randint(key: Key, shape, minval: int, maxval: int, device: Any = "cpu") -> torch.Tensor:
    """``jax.random.randint`` into int32 over ``[minval, maxval)`` (both int32
    values): two words per element reduced modulo the span with uint32
    arithmetic, the reference's bias and wrap-arounds included."""
    i32 = np.iinfo(np.int32)
    if not (i32.min <= minval <= i32.max and i32.min <= maxval <= i32.max):
        raise OverflowError(f"randint bounds [{minval}, {maxval}) are not int32 values")
    span = 1 if maxval <= minval else maxval - minval
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape, device), random_bits(k2, shape, device)
    mult = ((((1 << 16) % span) ** 2) & _M32) % span  # uint32 products wrap
    offset = (((higher % span) * mult + lower % span) & _M32) % span
    return (offset + minval).to(torch.int32)


def permutation(key: Key, n: int, device: Any = "cpu") -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` through
    ``ceil(3 ln n / ln(2**32 - 1))`` stable sorts by fresh 32-bit words (ties,
    which occur, keep their order as in the reference's stable sort)."""
    x = torch.arange(n, dtype=torch.int32, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), device), stable=True).indices
        x = x[order]
    return x


_NEXT_BELOW_ONE = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# Giles' single-precision erfinv, the polynomial the reference's compiler
# expands ``erf_inv`` into: for w = -log1p(-x²) below 5 and at or above it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """erfinv of float32 ``x`` in (-1, 1) as the reference evaluates it:
    Giles' polynomial in Horner form, each step one rounded multiply-add."""
    # log1p and sqrt in float64, rounded once: the same float32 on every
    # device and however the work is split between vectorized and scalar
    # loops. (The CPU's float32 sqrt is MKL's vector sqrt, within 1 ulp but
    # not correctly rounded, and on a loaded thread pool its result for the
    # same input varied from call to call.)
    w = torch.log1p((-x * x).double()).neg_().float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    coef = [torch.where(small, torch.tensor(a, dtype=torch.float32, device=x.device),
                        torch.tensor(b, dtype=torch.float32, device=x.device))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = _fma(p, w, c)
    return p * x


def normal(key: Key, shape, device: Any = "cpu") -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2)·erfinv(u)`` of a uniform
    ``u`` over ``(nextafter(-1, 0), 1)``. The uniform is bit-exact; the
    erfinv polynomial is the reference's, its ``log1p`` a correctly rounded
    one, so a value may differ from the reference's by a few ulp."""
    sqrt2 = torch.tensor(np.sqrt(2), dtype=torch.float32, device=device)

    def fill(lo: int, hi: int) -> torch.Tensor:
        return _erfinv(_uniform_chunk(key, lo, hi, _NEXT_BELOW_ONE, 1.0, device)) * sqrt2

    return _filled(shape, torch.float32, device, fill)
