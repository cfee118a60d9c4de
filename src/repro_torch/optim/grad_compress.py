"""Snapshot compression for distributed exchange (port of
``repro.optim.grad_compress``).

``compress_tree`` / ``decompress_tree``: blockwise int8 quantization of a
nested dict of tensors through ``kernels.ops.quantize_blockwise`` (the B5a
kernel on the card). The checkpoint engine's compressed mode packs the
result into the partner copy. A quantized leaf becomes the dict
``{"_q": int8 codes, "_scale": f32 scales, "_meta": int64 [*shape, dtype
index, size]}``, byte for byte the reference's, so the packed buffers and
their manifests are the same.

``compressed_psum``: the quantized all-reduce for manual data-parallel
gradient reduction over a ``torch.distributed`` group (the reference's is a
``psum`` inside ``shard_map``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.serialization import dtype_from_name, dtype_name
from repro_torch.kernels import ops
from repro_torch.kernels.quantize import ROWS_PER_TILE

# dtype registry so compressed payloads stay pure-tensor trees (packable to
# flat bytes + manifest without string leaves).
_DTYPES = ["float32", "bfloat16", "float16", "float64"]


def compress_tree(tree: Any, block: int = 256, device: Any = None) -> Any:
    """Quantize floating leaves of at least ``block`` elements to (int8
    codes, f32 scales); pass the others through. A quantized leaf is moved to
    ``device`` first (the leaf's own by default), where the codes and scales
    stay.

    A float64 leaf is recorded as float32: the reference converts leaves
    with ``jnp.asarray`` under JAX's default 32-bit mode, so it quantizes
    and restores them as float32."""

    def comp(x: torch.Tensor) -> Any:
        name = dtype_name(x.dtype)
        if not (x.is_floating_point() and x.numel() >= block and name in _DTYPES):
            return x
        if name == "float64":
            name, x = "float32", x.to(torch.float32)
        q, scale = ops.quantize_blockwise(x.to(x.device if device is None else device).reshape(-1), block)
        meta = torch.tensor([*x.shape, _DTYPES.index(name), x.numel()], dtype=torch.int64)
        return {"_q": q, "_scale": scale, "_meta": meta}

    return _map(comp, tree, lambda x: False)


def _is_packed(x: Any) -> bool:
    return isinstance(x, dict) and "_q" in x


def decompress_tree(tree: Any) -> Any:
    """The inverse of :func:`compress_tree`: each quantized leaf dequantized
    where its codes lie and cast back to its recorded dtype and shape."""

    def decomp(x: Any) -> Any:
        if not _is_packed(x):
            return x
        meta = [int(v) for v in x["_meta"].reshape(-1).tolist()]
        shape, dtype, size = tuple(meta[:-2]), _DTYPES[meta[-2]], meta[-1]
        flat = ops.dequantize_blockwise(x["_q"], x["_scale"].to(x["_q"].device))
        return flat[:size].reshape(shape).to(dtype_from_name(dtype))

    return _map(decomp, tree, _is_packed)


def _map(fn, tree: Any, is_leaf) -> Any:
    """``fn`` over the leaves of a nested dict; a dict for which ``is_leaf``
    holds counts as one leaf."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: _map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def compressed_psum(x: torch.Tensor, group: Any = None, block: int = 256) -> torch.Tensor:
    """Quantize (B5a on the card), dequantize locally, all-reduce (SUM) over
    ``group``, and cast back to ``x``'s shape and dtype: int8 gradient
    all-reduce's numerics, quantize once then sum. The reference reshapes
    the padded length back to ``x``'s shape, which works only when
    ``x.numel()`` is a multiple of ``block * ROWS_PER_TILE`` (8192); the port
    raises a ``ValueError`` for any other size."""
    tile = block * ROWS_PER_TILE
    if x.numel() % tile:
        raise ValueError(f"compressed_psum: {x.numel()} elements is not a multiple of block x "
                         f"ROWS_PER_TILE = {tile} (the padded codes do not reshape to {tuple(x.shape)})")
    q, scale = ops.quantize_blockwise(x.reshape(-1), block)
    # the wire format of a real int8 all-reduce stays int8 per hop; the
    # numerics (quantize once, then sum) are these
    deq = q.to(torch.float32) * scale.repeat_interleave(block)[: q.numel()]
    dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
    return deq.reshape(x.shape).to(x.dtype)
