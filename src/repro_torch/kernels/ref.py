"""Plain PyTorch versions of the kernels: checksum, XOR parity, GF(2^8)
encode/decode, blockwise int8 quantize/dequantize, the reshard row gather
and the run-table copy that carries it on the card.

Each function repeats its CUDA kernel's arithmetic with no tiling. The
wrappers take them for CPU tensors only; ``chip_smoke.py`` holds each
kernel against them on the card.

This CPU build of PyTorch has no ``<<``/``>>`` for ``uint32`` and widens
``uint32`` sums to int64 without wrapping, so the word maths runs on int32
views of the same words (XOR) or on int64 holding them (the GF(2^8)
products, whose plane products reach 2^32 - 1; the checksum sums), keeping
only the low 32 bits.
"""

from __future__ import annotations

from typing import Sequence

import torch

_PLANE = 0x01010101  # bit 0 of each packed byte
_MASK32 = 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    assert x.dtype == torch.uint32, x.dtype
    return x.view(torch.int32)


def xor_reduce(stacked: torch.Tensor) -> torch.Tensor:
    """XOR over axis 0. stacked: (k, n) uint32 -> (n,) uint32."""
    x = _i32(stacked)
    acc = x[0].clone()
    for i in range(1, x.shape[0]):
        acc ^= x[i]
    return acc.view(torch.uint32)


def gf_mul_alpha_pow(c: int, s: int) -> int:
    """c · α^s in GF(2^8) (polynomial 0x11D) for one field element: s
    xtime steps."""
    for _ in range(s):
        c = ((c << 1) ^ ((c >> 7) * 0x11D)) & 0xFF
    return c


def gf_terms(coefs: torch.Tensor) -> torch.Tensor:
    """(m, k) field elements (their low byte) -> the (m, k, 8) int64 per-term
    multipliers c · α^s of the bit-plane product."""
    c = coefs.to(torch.int64) & 0xFF
    terms = [c]
    for _ in range(7):
        c = ((c << 1) ^ ((c >> 7) * 0x11D)) & 0xFF
        terms.append(c)
    return torch.stack(terms, dim=-1)


def _gf_product(stacked: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """The kernels' bit-plane product: out[j] = ⊕_i ⊕_s plane_s(x[i]) ·
    terms[j, i, s], plane_s(x) = (x >> s) & 0x01010101 (a 0/1 byte per
    field byte, so each product is carry-free). Runs on int64 holding the
    uint32 words."""
    x = _i32(stacked).to(torch.int64) & _MASK32
    k = x.shape[0]
    m = terms.shape[0]
    assert tuple(terms.shape) == (m, k, 8), (tuple(terms.shape), k)
    out = torch.zeros((m, x.shape[1]), dtype=torch.int64, device=x.device)
    for i in range(k):
        for s in range(8):
            out ^= ((x[i] >> s) & _PLANE)[None, :] * terms[:, i, s][:, None]
    return u32_from_i64(out)


def gf256_matmul(stacked: torch.Tensor, coefs: Sequence[Sequence[int]]) -> torch.Tensor:
    """out[j] = ⊕_i coefs[j][i] · x[i] over GF(2^8), 4 bytes per uint32 word.

    stacked: (k, n) uint32, coefs a static (m, k) generator -> (m, n) uint32,
    by the encode kernel's bit-plane product (its multipliers expanded on
    the host).
    """
    c = torch.tensor([[int(v) for v in row] for row in coefs], dtype=torch.int64, device=stacked.device)
    return _gf_product(stacked, gf_terms(c))


def gf256_matmul_dyn(stacked: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """Erasure decode: the same product with a runtime (m, k) uint32
    coefficient matrix, expanded into its multipliers on its device (the
    decode kernel's form)."""
    assert coefs.ndim == 2 and coefs.shape[1] == stacked.shape[0], (tuple(coefs.shape), stacked.shape[0])
    return _gf_product(stacked, gf_terms(coefs))


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


#: fl(1/127) in f32 (0x3c010204): the reference's ``max|x| / 127.0`` runs
#: under ``jax.jit``, where XLA rewrites the division by a constant into a
#: multiplication by this reciprocal (the true quotient differs in the last
#: bit on some blocks).
INV_127 = 0.007874015718698502


def quantize_blockwise(x: torch.Tensor, block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with per-block max-abs scales
    (``repro.kernels.ref.quantize_blockwise`` as the reference runs it,
    jitted): x (n,) float with n % block == 0 -> (q (n,) int8, scales
    (n/block,) f32), ``scale = max(max|x| · fl(1/127), 1e-30)``,
    ``q = clamp(round(x / scale), ±127)``.

    The codes are true divisions by a tensor: PyTorch's CUDA division by a
    Python scalar would multiply by its reciprocal instead. ``torch.round``
    rounds half to even, like ``jnp.round``."""
    assert x.ndim == 1 and x.shape[0] % block == 0, (tuple(x.shape), block)
    xb = x.reshape(-1, block).to(torch.float32)
    amax = xb.abs().amax(dim=1)
    scale = torch.clamp_min(amax * INV_127, 1e-30)
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127).to(torch.int8)
    return q.reshape(-1), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q (n,) int8, scales (n/block,) f32) -> (n,) f32: ``q * scale``."""
    block = q.shape[0] // scale.shape[0]
    return (q.reshape(-1, block).to(torch.float32) * scale[:, None]).reshape(-1)


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather for the elastic reshard: out[i] = src[idx[i]] (the
    reference's ``jnp.take(src, idx, axis=0)``)."""
    assert src.ndim == 2 and idx.ndim == 1
    return src.index_select(0, idx.long())


def copy_runs(sources: Sequence[torch.Tensor], out: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The run table's copies one by one: row j of run ``(k, s, d, n, rows,
    s_step, d_step)`` copies bytes ``[s + j * s_step, +n)`` of ``sources[k]``
    to bytes ``[d + j * d_step, +n)`` of ``out`` (contiguous tensors, viewed
    as flat bytes)."""
    dst = out.reshape(-1).view(torch.uint8)
    srcs = [s.reshape(-1).view(torch.uint8) for s in sources]
    for k, s, d, n, rows, s_step, d_step in table.tolist():
        x = srcs[k]
        dst.as_strided((rows, n), (d_step, 1), dst.storage_offset() + d).copy_(
            x.as_strided((rows, n), (s_step, 1), x.storage_offset() + s))
    return out
