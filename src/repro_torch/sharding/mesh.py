"""A virtual device mesh: named axes with sizes, all on one device.

The JAX package runs one shard per device of a ``jax.sharding.Mesh`` and
moves buffers with ``shard_map`` collectives. The port keeps every virtual
rank's data on one card, in tensors stacked over the mesh coordinates in
JAX's device order (first axis major), so a collective permute becomes an
index permutation along that dimension. A ``PartitionSpec`` becomes a tuple
with one entry per dim: ``None``, an axis name, or a tuple of axis names.
``topology_of_mesh`` reads a failure-domain topology off a mesh's device
order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
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
    # a mesh on the meta device is the dry run's: it places nothing
    dev = torch.device(device) if device is not None and torch.device(device).type == "meta" else resolve_device(device)
    return VirtualMesh(tuple((n, int(s)) for n, s in zip(names, sizes)), dev)


def axes_of(entry) -> tuple[str, ...]:
    """Mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def full_rank(spec: Spec, ndim: int) -> tuple:
    """A spec padded with ``None`` (or cut) to ``ndim`` entries."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return tuple(entries[:ndim])


def topology_of_mesh(
    mesh: Any,
    n_ranks: int | None = None,
    host_chips: int = 8,
    hosts_per_rack: int = 4,
    racks_per_pod: int = 4,
    placement_level: str = "rack",
):
    """A :class:`repro_torch.core.topology.ClusterTopology` for the engine's
    rank space, read off the mesh's device order: one engine rank is one
    coordinate of the data axes ("pod", "data"), its host the first device
    of its contiguous block (``host_chips`` devices a host), racks and pods
    packed above that as in ``ClusterTopology.regular``. A mesh with
    ``devices`` (items with ``.id``) gives its ids; a ``VirtualMesh``, which
    has no device objects, numbers its virtual devices 0..size-1 in
    row-major axis order."""
    from repro_torch.core.topology import ClusterTopology

    shape = dict(mesh.shape)
    if n_ranks is None:
        n_ranks = math.prod(shape.get(a, 1) for a in ("pod", "data")) or 1
    devices = getattr(mesh, "devices", None)
    if devices is None:
        devs = list(range(math.prod(shape.values())))
    else:
        devs = [d.id for d in np.asarray(devices, dtype=object).reshape(-1)]
    # devices per engine rank under row-major order with the data axes
    # leading: a contiguous block per rank
    per_rank = max(len(devs) // max(n_ranks, 1), 1)
    labels = []
    for r in range(n_ranks):
        host = devs[min(r * per_rank, len(devs) - 1)] // host_chips
        rack = host // hosts_per_rack
        labels.append((host, rack, rack // racks_per_pod))
    return ClusterTopology(labels=tuple(labels), placement_level=placement_level,
                           name=f"mesh[{','.join(f'{k}={v}' for k, v in shape.items())}]")
