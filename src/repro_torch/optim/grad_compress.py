"""Snapshot compression for distributed exchange (port of
``repro.optim.grad_compress``).

``compress_tree`` / ``decompress_tree``: blockwise int8 quantization of a
nested dict of tensors through ``kernels.ops.quantize_blockwise`` (the B5a
kernel on the card). The checkpoint engine's compressed mode packs the
result into the partner copy. A quantized leaf becomes the dict
``{"_q": int8 codes, "_scale": f32 scales, "_meta": int64 [*shape, dtype
index, size]}``, byte for byte the reference's, so the packed buffers and
their manifests are the same.

``compressed_psum`` (the quantized all-reduce) waits for the collectives
(ROADMAP A10).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.serialization import dtype_from_name, dtype_name
from repro_torch.kernels import ops

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
