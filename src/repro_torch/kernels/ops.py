"""Public wrappers around the kernels (counterpart of ``repro.kernels.ops``).

They take whole tensors in the JAX package's shapes: ``(k, n)`` uint32
stacks, any-dtype arrays viewed as packed uint32 words. A CPU tensor runs
the plain PyTorch version; a CUDA tensor launches the hand-written kernel or
raises. The kernels mask their own ragged edge, so the only padding left
here is ``as_u32``'s zero tail to a whole word and the equal-length padding
of the ``*_arrays`` helpers.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.kernels import checksum as _checksum_k
from repro_torch.kernels import quantize as _quantize_k
from repro_torch.kernels import ref
from repro_torch.kernels import reshard as _reshard_k
from repro_torch.kernels import rs_decode as _rsd_k
from repro_torch.kernels import rs_encode as _rs_k
from repro_torch.kernels import xor_parity as _xor_k
from repro_torch.utils.pytree import tree_leaves

# kernel name -> (wrapper module, its launch counter)
_COUNTERS = {
    "checksum": (_checksum_k, "launches"),
    "xor_reduce": (_xor_k, "launches"),
    "gf256_matmul": (_rs_k, "launches"),
    "gf256_matmul_dyn": (_rsd_k, "launches"),
    "quantize_blockwise": (_quantize_k, "quantize_launches"),
    "dequantize_blockwise": (_quantize_k, "dequantize_launches"),
    "gather_rows": (_reshard_k, "launches"),
}


def launch_counts() -> dict[str, int]:
    """CUDA launches per kernel since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


# ---------------------------------------------------------------------------
# uint32 viewing helpers
# ---------------------------------------------------------------------------

def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Bitcast any tensor to a flat uint32 vector (pad odd tails with zeros).
    A view when the byte count is already whole words."""
    flat = x.contiguous().reshape(-1)
    if flat.element_size() == 4:
        return flat.view(torch.uint32)
    u8 = flat.view(torch.uint8)
    pad = (-u8.numel()) % 4
    if pad:
        u8 = torch.cat([u8, u8.new_zeros(pad)])
    return u8.view(torch.uint32)


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.numel() == n:
        return x
    out = torch.zeros(n, dtype=torch.int32, device=x.device)
    out[: x.numel()] = x.view(torch.int32)
    return out.view(torch.uint32)


def _stack(views: list[torch.Tensor]) -> torch.Tensor:
    n = max(v.numel() for v in views)
    return torch.stack([_pad_to(v, n).view(torch.int32) for v in views]).view(torch.uint32)


def empty_u32(shape, device) -> torch.Tensor:
    """Uninitialised uint32 storage, allocated as int32: fill and index
    kernels for uint32 are not in every build, and the bytes are the same."""
    return torch.empty(shape, dtype=torch.int32, device=device).view(torch.uint32)


def _check_stacked(stacked: torch.Tensor) -> None:
    if stacked.ndim != 2 or stacked.dtype != torch.uint32:
        raise ValueError(f"expected (k, n) uint32, got {tuple(stacked.shape)} {stacked.dtype}")


# ---------------------------------------------------------------------------
# XOR parity
# ---------------------------------------------------------------------------

def xor_reduce(stacked: torch.Tensor) -> torch.Tensor:
    """XOR over axis 0 of (k, n) uint32. Returns (n,) uint32."""
    _check_stacked(stacked)
    stacked = stacked.contiguous()
    out = empty_u32(stacked.shape[1], stacked.device)
    return _xor_k.xor_reduce_into(list(stacked.unbind(0)), out)


def xor_encode_arrays(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """Parity of arrays of any dtype/length -> (n,) uint32 parity."""
    return xor_reduce(_stack([as_u32(a) for a in arrays]))


# ---------------------------------------------------------------------------
# Reed-Solomon GF(2^8) parity
# ---------------------------------------------------------------------------

def gf256_matmul(stacked: torch.Tensor, coefs: Sequence[Sequence[int]]) -> torch.Tensor:
    """RS parity over axis 0 of (k, n) uint32 (4 packed GF bytes per word)
    with a static (m, k) generator. Returns (m, n) uint32."""
    _check_stacked(stacked)
    stacked = stacked.contiguous()
    out = empty_u32((len(coefs), stacked.shape[1]), stacked.device)
    _rs_k.rs_encode_into(list(stacked.unbind(0)), coefs, list(out.unbind(0)))
    return out


def rs_encode_arrays(arrays: Sequence[torch.Tensor], coefs: Sequence[Sequence[int]]) -> torch.Tensor:
    """RS parity of arrays of any dtype/length -> (m, n) uint32 blobs."""
    return gf256_matmul(_stack([as_u32(a) for a in arrays]), coefs)


def gf256_matmul_dyn(stacked: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """Erasure decode over axis 0 of (k, n) uint32 with a runtime (m, k)
    coefficient matrix. Returns (m, n) uint32."""
    _check_stacked(stacked)
    stacked = stacked.contiguous()
    coefs = torch.as_tensor(coefs).to(device=stacked.device)
    if coefs.dtype != torch.uint32:
        coefs = coefs.to(torch.int64).to(torch.int32).view(torch.uint32)
    out = empty_u32((coefs.shape[0], stacked.shape[1]), stacked.device)
    _rsd_k.rs_decode_into(list(stacked.unbind(0)), coefs, list(out.unbind(0)))
    return out


def rs_decode_arrays(arrays: Sequence[torch.Tensor], coefs: torch.Tensor) -> torch.Tensor:
    """Erasure decode of arrays of any dtype/length -> (m, n) uint32 rebuilt
    shards: stack [survivors ‖ intact blobs] and apply the decode matrix."""
    return gf256_matmul_dyn(_stack([as_u32(a) for a in arrays]), coefs)


# ---------------------------------------------------------------------------
# Reshard row gather (elastic N-to-M recovery)
# ---------------------------------------------------------------------------

def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]] for src (rows, cols) of any dtype, idx (rows_out,)
    int32 (on the CPU or on ``src``'s device).

    The move of the elastic reshard on the card: the repartition plan's row
    segments flatten into ``idx`` and one gather builds the new shard. No
    column padding: the kernel copies each row in the widest units that
    divide it. An index outside ``[0, rows)`` raises."""
    if src.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"gather_rows: expected (rows, cols) and (rows_out,), got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    out = torch.empty((idx.shape[0], src.shape[1]), dtype=src.dtype, device=src.device)
    return _reshard_k.gather_rows_into(src.contiguous(), idx, out)


# ---------------------------------------------------------------------------
# Checksum
# ---------------------------------------------------------------------------

def checksum(x: torch.Tensor) -> torch.Tensor:
    """Fletcher-style dual checksum of any tensor -> (2,) uint32."""
    u = as_u32(x)
    return _checksum_k.checksum_rows(u.view(1, -1))[0]


def mix_checksums(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Order-sensitive mix ``acc = acc·1000003 + c_i·(i+1)`` mod 2^32 of
    (2,) uint32 checksums -> (2,) uint32 (int64 arithmetic on the device)."""
    acc = None
    for i, c in enumerate(parts):
        c64 = c.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        acc = c64 * (i + 1) if acc is None else acc * 1000003 + c64 * (i + 1)
        acc &= 0xFFFFFFFF
    if acc is None:
        return torch.zeros(2, dtype=torch.int32).view(torch.uint32)
    return ref.u32_from_i64(acc)


def tree_checksum(tree: Any) -> torch.Tensor:
    """Combined (2,) uint32 checksum over all leaves (order-dependent mix)."""
    return mix_checksums([checksum(leaf) for leaf in tree_leaves(tree)])


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

def quantize_blockwise(x: torch.Tensor, block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (n,) float -> (q (n_pad,) int8, scales (n_pad/block,) f32).

    As in the reference, n is padded with zeros up to a multiple of
    ``block * ROWS_PER_TILE`` (8192) elements, and ``dequantize_blockwise``
    returns the padded length; callers slice back to the original size.
    f32, bf16 and f16 go to the kernel as they are (it widens on load);
    other float types are cast to f32 first, as the reference's kernel
    does with ``astype(float32)``."""
    if x.ndim != 1:
        raise ValueError(f"quantize_blockwise: expected a 1-D tensor, got {tuple(x.shape)}")
    if block != _quantize_k.QBLOCK:
        raise ValueError(f"quantize_blockwise: the kernel is specialized to block={_quantize_k.QBLOCK}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        x = x.to(torch.float32)
    tile = block * _quantize_k.ROWS_PER_TILE
    n_pad = -(-x.numel() // tile) * tile
    q = torch.empty(n_pad, dtype=torch.int8, device=x.device)
    scale = torch.empty(n_pad // block, dtype=torch.float32, device=x.device)
    _quantize_k.quantize_into(x.contiguous(), q, scale)
    return q, scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q (n,) int8, scales (n/256,) f32) -> (n,) f32."""
    if q.numel() != scale.numel() * _quantize_k.QBLOCK:
        raise ValueError(f"dequantize_blockwise: {q.numel()} codes for {scale.numel()} scales")
    out = torch.empty(q.numel(), dtype=torch.float32, device=q.device)
    _quantize_k.dequantize_into(q.contiguous(), scale.contiguous(), out)
    return out
