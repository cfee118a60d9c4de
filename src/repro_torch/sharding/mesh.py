"""Device meshes: named axes with sizes, on one device or over processes.

The JAX package runs one shard per device of a ``jax.sharding.Mesh`` and
moves buffers with ``shard_map`` collectives. The port has two meshes:

* :class:`VirtualMesh` keeps every virtual rank's data on one card, in
  tensors stacked over the mesh coordinates in JAX's device order (first
  axis major), so a collective permute becomes an index permutation along
  that dimension;
* :class:`ProcessMesh` is one process per mesh coordinate over a
  ``torch.distributed`` group (the counterpart of a ``Mesh`` over real
  devices): each process holds its own shards and runs the per-device body,
  and the collectives go over the group (``core/transport.py``). Its
  ``device_mesh`` is a DTensor ``DeviceMesh`` over the same processes in the
  same axis order, on which a spec becomes DTensor placements
  (:func:`placements`): the sharded train step's layout.

A ``PartitionSpec`` becomes a tuple with one entry per dim: ``None``, an
axis name, or a tuple of axis names. ``topology_of_mesh`` reads a
failure-domain topology off a mesh's device order; ``mesh_axis_size``,
``data_axes``, ``flat_device_index`` and ``hosts_of_mesh`` are the
reference's helpers for either mesh.
"""

from __future__ import annotations

import functools
import itertools
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


def _check_axes(sizes: tuple[int, ...], names: tuple[str, ...]) -> tuple[tuple[str, int], ...]:
    if len(sizes) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh sizes {sizes} and names {names} do not match")
    if any(int(s) < 1 for s in sizes):
        raise ValueError(f"mesh axis sizes must be >= 1, got {sizes}")
    return tuple((n, int(s)) for n, s in zip(names, sizes))


def make_mesh(sizes: tuple[int, ...], names: tuple[str, ...], device: Any = None) -> VirtualMesh:
    """``jax.make_mesh``'s counterpart: a virtual mesh on one device."""
    axes = _check_axes(sizes, names)
    # a mesh on the meta device is the dry run's: it places nothing
    dev = torch.device(device) if device is not None and torch.device(device).type == "meta" else resolve_device(device)
    return VirtualMesh(axes, dev)


@dataclass(frozen=True, eq=False)
class ProcessMesh:
    """Named axes over processes, one per mesh coordinate: this process's
    view. ``rank`` is its flat index in row-major axis order (JAX's device
    order), which is also its rank in ``group``. ``subgroups`` maps each
    proper, non-empty set of axes (a tuple in mesh order) to the group of
    the processes that share this one's coordinates on every other axis;
    the whole axis set is ``group`` itself. ``backend`` is the one the
    caller named (``"gloo"`` or ``"nccl"``); the transport uses no other.
    ``device_mesh`` is the DTensor ``DeviceMesh`` over the same ranks (row
    major, the same axis names) and ``staged_group`` a group of every rank
    on the staged backend (``core/transport.py``) when the backend is gloo;
    ``launch/mesh.py::init_process_mesh`` builds both."""

    axes: tuple[tuple[str, int], ...]
    rank: int
    device: torch.device
    backend: str
    group: Any = None
    subgroups: dict = field(default_factory=dict)
    device_mesh: Any = None
    staged_group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(s for _, s in self.axes)

    @property
    def coords(self) -> dict[str, int]:
        """This process's coordinate on every axis."""
        return coords_of(self.axes, self.rank)

    def rank_of(self, coords: dict[str, int]) -> int:
        """The flat rank of a coordinate (every axis named)."""
        r = 0
        for a, s in self.axes:
            r = r * s + coords[a]
        return r

    def peer(self, axis: str, index: int) -> int:
        """The rank at ``index`` along ``axis`` with this process's
        coordinates on every other axis (a ``ppermute`` partner)."""
        return self.rank_of({**self.coords, axis: index})

    def group_of(self, axes: tuple[str, ...]) -> Any:
        """The process group over ``axes`` (mesh order) holding this process;
        ``None`` for every axis, which is the whole group."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if axes == self.axis_names:
            return self.group
        return self.subgroups[axes]

    @functools.cached_property
    def transport(self):
        """The collectives of the per-device body over this mesh
        (:class:`repro_torch.core.transport.Transport`), one per mesh."""
        from repro_torch.core.transport import Transport

        return Transport(self)


def placements(spec: Spec, mesh: Any) -> tuple:
    """A spec as DTensor placements on ``mesh``'s axes (one per axis, mesh
    order): ``Shard(dim)`` on each axis a dim is sharded over, ``Replicate``
    elsewhere. A dim over several axes is split over them in mesh order,
    the first major, which is JAX's order for a spec entry that names its
    axes in mesh order (as the rules' entries do); another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.axis_names
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in axes_of(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names its axes out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def block_slices(shape: tuple[int, ...], spec: Spec, axes: tuple[tuple[str, int], ...], rank: int) -> tuple:
    """The slices of a global array of ``shape`` that the process at flat
    ``rank`` of a mesh with ``axes`` holds under ``spec`` (what
    ``NamedSharding.devices_indices_map`` gives a device of a mesh over
    devices in row-major order). Every sharded dim must divide evenly."""
    names = [a for a, _ in axes]
    sizes = dict(axes)
    coords = coords_of(axes, rank)
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        lo, hi = 0, n
        for a in sorted(axes_of(entry), key=names.index):
            if (hi - lo) % sizes[a]:
                raise ValueError(f"dim {dim} of {shape} does not divide over {a!r}")
            step = (hi - lo) // sizes[a]
            lo, hi = lo + coords[a] * step, lo + (coords[a] + 1) * step
        out.append(slice(lo, hi))
    return tuple(out)


def local_block(x: torch.Tensor, spec: Spec, mesh: Any) -> torch.Tensor:
    """This process's block of the global tensor ``x`` under ``spec`` (a
    view)."""
    return x[block_slices(tuple(x.shape), spec, mesh.axes, mesh.rank)]


def distribute(x: torch.Tensor, spec: Spec, mesh: Any) -> Any:
    """A DTensor over ``mesh.device_mesh`` from the global tensor ``x``,
    which every process holds alike: each keeps its own block (a copy on
    the mesh's device), with no communication."""
    from torch.distributed.tensor import DTensor

    local = local_block(x, spec, mesh).to(mesh.device, copy=True).contiguous()
    return DTensor.from_local(local, mesh.device_mesh, placements(spec, mesh), run_check=False,
                              shape=x.shape, stride=torch.empty(x.shape, device="meta").stride())


def coords_of(axes: tuple[tuple[str, int], ...], rank: int) -> dict[str, int]:
    """The coordinate of flat index ``rank`` in row-major axis order."""
    out = {}
    for a, s in reversed(axes):
        rank, out[a] = divmod(rank, s)
    return {a: out[a] for a, _ in axes}


def axis_groups(axes: tuple[tuple[str, int], ...], over: tuple[str, ...]) -> list[list[int]]:
    """The partition of the flat ranks into the groups that vary only on the
    axes ``over``: one list per coordinate of the other axes, ranks
    ascending."""
    names = [a for a, _ in axes]
    others = [(a, s) for a, s in axes if a not in over]
    groups = []
    for fixed in itertools.product(*[range(s) for _, s in others]):
        fix = dict(zip([a for a, _ in others], fixed))
        members = []
        for var in itertools.product(*[range(s) for a, s in axes if a in over]):
            c = {**fix, **dict(zip([a for a in names if a in over], var))}
            r = 0
            for a, s in axes:
                r = r * s + c[a]
            members.append(r)
        groups.append(sorted(members))
    return groups


def make_process_mesh(sizes: tuple[int, ...], names: tuple[str, ...], device: Any) -> ProcessMesh:
    """A process mesh over the default ``torch.distributed`` group, which
    must already be initialised (``launch/mesh.py``) with one process per
    coordinate. Collective: every process calls it, in the same order, since
    it makes the subgroup of every proper axis set."""
    import torch.distributed as dist

    axes = _check_axes(sizes, names)
    n = math.prod(s for _, s in axes)
    if not dist.is_initialized():
        raise RuntimeError("make_process_mesh needs an initialised torch.distributed group")
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {n} coordinates over {dist.get_world_size()} processes")
    subgroups = {}
    for k in range(1, len(axes)):
        for over in itertools.combinations(names, k):
            mine, _ = dist.new_subgroups_by_enumeration(axis_groups(axes, over))
            subgroups[over] = mine
    return ProcessMesh(axes, dist.get_rank(), torch.device(device), dist.get_backend(), dist.group.WORLD,
                       subgroups)


# ---------------------------------------------------------------------------
# The reference's mesh helpers (repro/sharding/mesh.py), for either mesh. A
# mesh here has no device objects: its devices are numbered 0..size-1 in
# row-major axis order, which is what the reference's ids are on a mesh made
# by ``jax.make_mesh`` over devices 0..size-1.
# ---------------------------------------------------------------------------

def mesh_axis_size(mesh: Any, axes: tuple[str, ...] | str | None) -> int:
    """Product of the sizes of ``axes`` (absent axes count 1)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape.get(a, 1)
    return size


def data_axes(mesh: Any) -> tuple[str, ...]:
    """The axes that constitute the data-parallel/failure dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def flat_device_index(mesh: Any) -> np.ndarray:
    """device id -> flat index in the mesh's row-major device order."""
    return np.arange(math.prod(mesh.shape.values()))


def hosts_of_mesh(mesh: Any, host_chips: int = 8) -> dict[int, list[int]]:
    """host index -> device ids, with ids dense and hosts contiguous."""
    out: dict[int, list[int]] = {}
    for d in flat_device_index(mesh).tolist():
        out.setdefault(d // host_chips, []).append(d)
    return out


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
