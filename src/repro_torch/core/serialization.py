"""Host-tier snapshot serialization (port of ``repro.core.serialization``).

A snapshot payload is a nested dict of tensors. ``pack_bytes`` serializes it
into one flat ``torch.uint8`` CPU buffer plus a manifest, the representation
the redundancy codecs and compression operate on; ``unpack_bytes`` is the
inverse. Leaves may live on the card: each one is copied exactly once,
straight into its slice of the buffer. Bytes cross as bytes (a bf16 leaf is
never widened), so no numpy bf16 type is needed.

Leaf order and names follow ``jax.tree``'s: dict keys sorted, names the
dotted key path. Dtype names are numpy's (``"float32"``, ``"bfloat16"``,
``"int8"``...), so a manifest compares equal, field by field, with the JAX
package's for the same tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.utils.pytree import Path, tree_flatten, tree_unflatten


def dtype_name(dt: torch.dtype) -> str:
    """numpy/ml_dtypes name of a torch dtype (``torch.bfloat16`` -> ``bfloat16``)."""
    return str(dt).removeprefix("torch.")


def dtype_from_name(name: str) -> torch.dtype:
    """The torch dtype of a numpy/ml_dtypes dtype name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"no torch dtype named {name!r}")
    return dt


def flatten_with_names(tree: Any) -> tuple[list[Path], list[str], list[Any]]:
    """(paths, dotted names, leaves) in sorted-key order (``repro``'s
    ``flatten_with_names``; the root leaf of a bare tensor is named ``""``)."""
    paths, leaves = tree_flatten(tree)
    return paths, [".".join(str(k) for k in p) for p in paths], leaves


# ---------------------------------------------------------------------------
# Flat byte packing (for parity / compression / wire transfer)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LeafSlice:
    """Global coordinates of one leaf's shard (the elastic N-to-M layer).

    A shard holds rows ``[start, stop)`` along ``axis`` of a logical leaf of
    ``global_shape``. ``axis is None`` marks a leaf with no failure-domain
    dimension (replicated: every rank holds the full leaf); a leaf with an
    axis but a full ``[0, global_shape[axis])`` range is one whose dimension
    did not divide the world size.
    """

    global_shape: tuple[int, ...]
    axis: int | None
    start: int
    stop: int


@dataclass
class Manifest:
    names: list[str]
    shapes: list[tuple[int, ...]]
    dtypes: list[str]
    offsets: list[int]  # byte offsets into the flat buffer
    total: int
    treedef: Any        # the leaves' key paths (``tree_unflatten``'s input)
    # One LeafSlice per leaf: this shard's slice of the logical entity,
    # attached by the engine when the entity exposes shard_coords().
    coords: list[LeafSlice] | None = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_packed_nbytes(tree: Any) -> int:
    """Exact byte length ``pack_bytes`` will produce for this tree."""
    return sum(_nbytes(leaf) for leaf in tree_flatten(tree)[1])


def _copy_leaf(dst: torch.Tensor, t: torch.Tensor, off: int) -> None:
    """One copy of leaf ``t`` (any device, any strides) into the uint8 slice
    ``dst`` that starts at byte ``off`` of its buffer: through a view of the
    slice in the leaf's dtype when the offset allows one, else as bytes."""
    if off % t.element_size() == 0:
        dst.view(t.dtype).view(t.shape).copy_(t)
    else:
        dst.copy_(t.contiguous().reshape(-1).view(torch.uint8))


def pack_bytes(
    tree: Any,
    out: torch.Tensor | None = None,
    lease: Callable[[int], torch.Tensor] | None = None,
) -> tuple[torch.Tensor, Manifest]:
    """Serialize a nested dict of tensors into one flat uint8 CPU buffer +
    manifest.

    With ``out`` (a uint8 CPU arena of at least ``tree_packed_nbytes``
    bytes) every leaf is copied once, straight into its slice. ``lease`` is
    the callback form: ``lease(total_nbytes)`` returns the arena once the size
    is known (the engine passes ``HostStore.lease`` through here). The
    returned buffer is a view of the arena. With neither, a fresh buffer is
    allocated.
    """
    paths, names, leaves = flatten_with_names(tree)
    for n, leaf in zip(names, leaves):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"leaf {n!r} is a {type(leaf).__name__}, not a tensor")
    total = sum(_nbytes(leaf) for leaf in leaves)
    if out is None and lease is not None:
        out = lease(total)
    if out is None:
        out = torch.empty(total, dtype=torch.uint8)
    elif out.dtype != torch.uint8 or out.device.type != "cpu" or out.numel() < total:
        raise ValueError(f"arena must be a CPU uint8 buffer of >= {total} bytes, got "
                         f"{out.numel()} {out.dtype} on {out.device}")
    shapes, dtypes, offsets = [], [], []
    off = 0
    for leaf in leaves:
        nb = _nbytes(leaf)
        shapes.append(tuple(leaf.shape))
        dtypes.append(dtype_name(leaf.dtype))
        offsets.append(off)
        if nb:
            _copy_leaf(out[off : off + nb], leaf, off)
        off += nb
    return out[:total], Manifest(names, shapes, dtypes, offsets, total, paths)


def unpack_bytes(flat: torch.Tensor, manifest: Manifest, device: Any = None) -> Any:
    """The nested dict of ``manifest`` read back from ``flat``: owned copies
    (never views of the arena), on ``device`` (``flat``'s by default)."""
    dev = flat.device if device is None else torch.device(device)
    leaves = []
    for shape, dtype, off in zip(manifest.shapes, manifest.dtypes, manifest.offsets):
        dt = dtype_from_name(dtype)
        n = int(torch.Size(shape).numel()) * dt.itemsize
        raw = flat[off : off + n]
        raw = raw.to(dev, copy=True) if raw.device != dev else raw.clone()
        leaves.append(raw.view(dt).reshape(shape))
    return tree_unflatten(manifest.treedef, leaves)
