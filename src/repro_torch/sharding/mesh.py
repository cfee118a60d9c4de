"""A virtual device mesh: named axes with sizes, all on one device.

The JAX package runs one shard per device of a ``jax.sharding.Mesh`` and
moves buffers with ``shard_map`` collectives. The port keeps every virtual
rank's data on one card, in tensors stacked over the mesh coordinates in
JAX's device order (first axis major), so a collective permute becomes an
index permutation along that dimension. A ``PartitionSpec`` becomes a tuple
with one entry per dim: ``None``, an axis name, or a tuple of axis names.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

Spec = tuple  # per-dim entries: None | str | tuple[str, ...]


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another. Raises when CUDA is asked for and absent (no quiet CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())  # tensors report an index
    return dev


@dataclass(frozen=True)
class VirtualMesh:
    """Named axes over one device. ``shape`` keeps axis order (mesh order)."""

    axes: tuple[tuple[str, int], ...]
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def size(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n


def make_mesh(sizes: tuple[int, ...], names: tuple[str, ...], device: Any = None) -> VirtualMesh:
    """``jax.make_mesh``'s counterpart: a virtual mesh on one device."""
    if len(sizes) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh sizes {sizes} and names {names} do not match")
    if any(int(s) < 1 for s in sizes):
        raise ValueError(f"mesh axis sizes must be >= 1, got {sizes}")
    return VirtualMesh(tuple((n, int(s)) for n, s in zip(names, sizes)), resolve_device(device))


def axes_of(entry) -> tuple[str, ...]:
    """Mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def full_rank(spec: Spec, ndim: int) -> tuple:
    """A spec padded with ``None`` (or cut) to ``ndim`` entries."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return tuple(entries[:ndim])
