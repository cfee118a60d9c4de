"""Plain PyTorch versions of the four device-tier kernels.

Each function repeats its CUDA kernel's arithmetic with no tiling. The
wrappers take them for CPU tensors only; ``chip_smoke.py`` holds each
kernel against them on the card.

This CPU build of PyTorch has no ``<<``/``>>`` for ``uint32`` and widens
``uint32`` sums to int64 without wrapping, so the SWAR maths runs on int32
views of the same words: the arithmetic ``>> 7`` is exact under the
``& 0x01010101`` mask, and every sum keeps only its low 32 bits.
"""

from __future__ import annotations

from typing import Sequence

import torch

_LOW7 = 0x7F7F7F7F
_HIGH = 0x01010101
_POLY_LOW8 = 0x1D  # 0x11D with the (shifted-out) x^8 term dropped
_MASK32 = 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    assert x.dtype == torch.uint32, x.dtype
    return x.view(torch.int32)


def _xtime(x: torch.Tensor) -> torch.Tensor:
    """Multiply 4 packed GF(2^8) bytes (int32 view) by α in one SWAR step."""
    return ((x & _LOW7) << 1) ^ (((x >> 7) & _HIGH) * _POLY_LOW8)


def xor_reduce(stacked: torch.Tensor) -> torch.Tensor:
    """XOR over axis 0. stacked: (k, n) uint32 -> (n,) uint32."""
    x = _i32(stacked)
    acc = x[0].clone()
    for i in range(1, x.shape[0]):
        acc ^= x[i]
    return acc.view(torch.uint32)


def gf256_matmul(stacked: torch.Tensor, coefs: Sequence[Sequence[int]]) -> torch.Tensor:
    """out[j] = ⊕_i coefs[j][i] · x[i] over GF(2^8), 4 bytes per uint32 word.

    stacked: (k, n) uint32, coefs a static (m, k) generator -> (m, n) uint32.
    Multiplication by a constant c is the xtime chain over c's set bits,
    pruned after its highest bit (the encode kernel's form).
    """
    x = _i32(stacked)
    k, n = x.shape
    out = torch.zeros((len(coefs), n), dtype=torch.int32, device=x.device)
    for j, row in enumerate(coefs):
        assert len(row) == k, (row, k)
        for i, c in enumerate(row):
            c = int(c)
            t = x[i]
            for bit in range(8):
                if c >> bit & 1:
                    out[j] ^= t
                if c >> (bit + 1) == 0:
                    break
                t = _xtime(t)
    return out.view(torch.uint32)


def gf256_matmul_dyn(stacked: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """Erasure decode: the same product with a runtime (m, k) uint32
    coefficient matrix. All 8 xtime steps run, each masked by one bit of the
    coefficient (the decode kernel's branch-free form)."""
    x = _i32(stacked)
    k, n = x.shape
    c = coefs.to(torch.int64)
    assert c.ndim == 2 and c.shape[1] == k, (tuple(c.shape), k)
    m = c.shape[0]
    out = torch.zeros((m, n), dtype=torch.int32, device=x.device)
    for i in range(k):
        t = x[i]
        for bit in range(8):
            # per output row: an all-ones or all-zeros int32 mask
            sel = -((c[:, i] >> bit) & 1).to(torch.int32)       # (m,)
            out ^= t[None, :] & sel[:, None]
            if bit < 7:
                t = _xtime(t)
    return out.view(torch.uint32)


def checksum_rows(x: torch.Tensor) -> torch.Tensor:
    """Fletcher dual checksum of each row of a (rows, n) uint32 buffer ->
    (rows, 2) uint32: s1 = Σ x_i, s2 = Σ (i+1)·x_i, both mod 2^32, with i
    the word index inside the row."""
    assert x.ndim == 2
    u = _i32(x).to(torch.int64) & _MASK32
    idx = (torch.arange(1, x.shape[1] + 1, dtype=torch.int64, device=x.device)) & _MASK32
    s1 = u.sum(dim=1) & _MASK32
    # u·idx < 2^64 wraps in int64; the low 32 bits of the wrapped sum are exact
    s2 = (u * idx).sum(dim=1) & _MASK32
    return u32_from_i64(torch.stack([s1, s2], dim=1))


def u32_from_i64(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same values as uint32."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32).view(torch.uint32)
