"""XOR-parity (erasure-coded) snapshot redundancy (port of
``repro.core.parity``).

Plank-style diskless checkpointing: a parity group of g ranks XORs its g
serialized snapshots into one parity buffer, striped in 1/g chunks across
the *next* group's ranks. Memory per rank drops from the pairwise scheme's
5S to S(3 + 2/g); reconstruction needs the g-1 surviving snapshots and the
parity stripes, and tolerates one failure per adjacent group pair.

Host buffers are ``torch.uint8`` CPU tensors (numpy arrays are taken too),
XORed through numpy views; the device-tier encode runs the XOR kernel B2.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else x


def parity_nbytes(buffers: list) -> int:
    """Blob length ``encode_parity`` produces: the 4-aligned max buffer size."""
    n = max(_np(b).nbytes for b in buffers)
    return n + (-n) % 4


def encode_parity(buffers: list, out: torch.Tensor | None = None) -> torch.Tensor:
    """XOR of byte buffers, implicitly zero-padded to the 4-aligned max: each
    buffer XORs into the accumulator over its own length only, a uint32 pass
    over its 4-aligned prefix plus at most 3 tail bytes. ``out`` (optional)
    is a reusable uint8 accumulator of ``parity_nbytes`` bytes, zeroed
    here."""
    n = parity_nbytes(buffers)
    if out is None:
        out = torch.zeros(n, dtype=torch.uint8)
    else:
        assert out.dtype == torch.uint8 and out.numel() == n, (out.numel(), n)
        out.zero_()
    acc = out.numpy()
    acc32 = acc.view(np.uint32)
    for b in buffers:
        b = _np(b).reshape(-1)
        assert b.dtype == np.uint8, b.dtype
        head = b.nbytes & ~3
        if head:
            try:
                u32 = b[:head].view(np.uint32)
            except ValueError:  # a view numpy refuses: copy the head once
                u32 = np.frombuffer(b[:head].tobytes(), np.uint32)
            acc32[: head // 4] ^= u32
        if b.nbytes > head:
            acc[head : b.nbytes] ^= b[head:]
    return out


def stripe_bounds(nbytes: int, g: int) -> list[tuple[int, int]]:
    """Byte bounds of a blob's g stripes: ceil-width chunks, last one short.
    The single source of the stripe convention: ``split_stripes``,
    ``join_stripes`` and the engine's transfer stage all derive from it."""
    w = -(-nbytes // g)
    return [(i * w, min((i + 1) * w, nbytes)) for i in range(g)]


def split_stripes(parity: torch.Tensor, g: int) -> list[torch.Tensor]:
    """Split a parity buffer into g stripes (last one may be shorter)."""
    return [parity[a:b].clone() for a, b in stripe_bounds(parity.numel(), g)]


def join_stripes(stripes: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([s.reshape(-1) for s in stripes])


def reconstruct(surviving: list, parity: torch.Tensor) -> torch.Tensor:
    """Rebuild the single missing buffer: parity XOR (XOR of survivors).
    Returns the padded buffer; the caller truncates to the manifest length."""
    return encode_parity([parity, *[s.reshape(-1) for s in surviving]])


def device_encode_parity(arrays: list[torch.Tensor]) -> torch.Tensor:
    """Device-tier parity of tensors on the card by the XOR kernel B2
    (``ops.xor_encode_arrays``): uint8, the 4-aligned max length, on the
    arrays' device."""
    from repro_torch.kernels import ops

    return ops.xor_encode_arrays(list(arrays)).view(torch.int32).view(torch.uint8)
