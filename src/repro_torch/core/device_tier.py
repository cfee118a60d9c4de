"""Device-tier snapshot/restore programs, on one card or one process per
mesh coordinate (port of ``repro.core.device_tier`` for codecs ``copy``,
``xor``, ``rs`` and ``lrc``).

The reference runs one shard per TPU under ``shard_map`` and moves buffers
with ``ppermute``. On a :class:`VirtualMesh` every virtual rank lives on
one device, and a fused bucket is one ``(n_coords, words)`` uint32 tensor
with its coordinates ordered over ``bucket.axes`` (mesh order). So:

* a ``ppermute`` along an axis is an index permutation of that dimension;
* the ring collection of a parity group is a set of views of the group's
  rows, handed to the kernel as row pointers: no ``(g, words)`` copy;
* the parity blob is computed **once per group** (every member of the
  reference's group computes the same blob);
* stripe routing is slicing each blob into its holders' slots; where every
  group is full and the bucket varies on no axis after the redundancy axis,
  a blob's stripes are contiguous in the payload and the kernel writes them
  there directly.

Payloads have the global shapes and bytes of ``np.asarray`` of the
reference's payloads. Leaf order, bucket ``leaf_idx`` and ``word_offsets``
and the checksum mix follow ``jax.tree.flatten``'s order: dict keys sorted.

With ``compress=True`` (copy codec only) each bucket's partner copy is
int8: every coordinate's local leaves, in the bucket's dtype, are laid end
to end in one row padded to a multiple of 256 elements, and one launch of
the quantize kernel (B5a) covers all rows (blocks never cross a row). The
codes and scales travel along the same permutation as the uncompressed
copy.

``codec="lrc"`` encodes with ``codec.lrc_generator``'s rows (``lrc_locals``
local XOR rows over ``rs_parity`` Cauchy rows) through the encode kernel
B3, and its restore solves through the codec's cheapest invertible row set
(a single loss: one local parity) with the decode kernel B4.

``emit_full_blobs=True`` (striped codecs) keeps each group's whole blobs on
every member instead of routing stripes: the payload's ``parity_full[tag]``
is ``(n_parity, n_coords·words)``, each coordinate's slice its group's
blobs (encoded once per group and copied to the members).

The copy codec's ``restore_fn`` re-aligns the partner copies to their origin
coordinates (the inverse permutation) and unpacks every exchanged leaf.
``build_mirror_program`` is the hot-replica transport: the copy program
along the ``mirror`` scheme (coordinate ``i`` to ``i + T``, T half the
axis), with no own copy, its payload keyed ``mirror``.

**Over processes.** Given a :class:`ProcessMesh` instead, the three
``build_*`` functions return per-rank programs: each process runs the reference's per-device body
on its own shards (``local_shards``: the padded leaf's block at its
coordinate) and moves buffers with the mesh's transport
(``core/transport.py``): the fused uint32 buffer of ``words`` words, the
checksum fold (B1) and its ``psum``, the partner ``ppermute`` (B5a first
with ``compress=True``), the ring of ``g - 1`` permutes that collects a
parity group, the encode (B2, or B3 with the rs or lrc generator), the
routing rounds to the holder group and the round-robin stripe slots, or the
whole blobs with ``emit_full_blobs``. A rank's payload has the shape and
the bytes of the reference's per-device payload at its coordinate. The
striped restore runs the reference's holder-group ring, the routing home
and the ring of the group's (mask-zeroed) data; the failed coordinates
rebuild their buffers with B4 on their own processes, in place. Only what
the reference's permutes move crosses the wire: one permute of a buffer
per ring step or routing round. Layout and accounting (``FusedBucket``,
``word_offsets``, ``exchanged_bytes``, ``pcie_bytes``) are the same code
for both meshes; ``SnapshotProgram.sent_bytes`` is the bytes this rank's
permutes send per snapshot.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import codec as codec_mod
from repro_torch.core import distribution as dist
from repro_torch.core import gf256
from repro_torch.core.serialization import dtype_name
from repro_torch.kernels import _build
from repro_torch.kernels import checksum as _checksum_k
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quantize as _quantize_k
from repro_torch.kernels import rs_decode as _rsd_k
from repro_torch.kernels import rs_encode as _rs_k
from repro_torch.kernels import xor_parity as _xor_k
from repro_torch.kernels.ref import u32_from_i64
from repro_torch.obs.trace import tracer
from repro_torch.sharding.mesh import ProcessMesh, VirtualMesh, axes_of, full_rank
from repro_torch.utils.logging import get_logger
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten

log = get_logger("core.device_tier")
_TR = tracer()

_CODECS = ("copy", "xor", "rs", "lrc")


def _n_parity(codec: str, g: int, rs_parity: int, lrc_locals: int) -> int:
    """Redundancy blobs per group: lrc's locals (at most g) plus globals."""
    return {"copy": 0, "xor": 1, "rs": rs_parity, "lrc": min(lrc_locals, max(g, 1)) + rs_parity}[codec]


def _generator(codec: str, g: int, rs_parity: int, lrc_locals: int) -> np.ndarray:
    """The (n_parity, g) GF(2^8) generator of a striped codec."""
    if codec == "xor":
        return np.ones((1, g), np.uint8)
    if codec == "lrc":
        return codec_mod.lrc_generator(g, lrc_locals, rs_parity)
    return gf256.cauchy_matrix(rs_parity, g)
# bucket dtypes the quantize kernel reads as they are; others are cast to f32
_QUANT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _traced(phase: str):
    """Span-wrap a program builder."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _TR.span(phase):
                return fn(*args, **kwargs)
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def _uses_axis(pspec, ndim: int, axes: tuple[str, ...]) -> bool:
    return any(a in axes for e in full_rank(pspec, ndim) for a in axes_of(e))


def _axes_size(mesh: VirtualMesh, axes) -> int:
    k = 1
    for a in axes:
        k *= mesh.shape[a]
    return k


def _pad_shape(shape: tuple[int, ...], pspec, mesh: VirtualMesh) -> tuple[int, ...]:
    out = []
    for size, entry in zip(shape, full_rank(pspec, len(shape))):
        k = _axes_size(mesh, axes_of(entry))
        out.append(-(-size // k) * k)
    return tuple(out)


def _local_shape(padded: tuple[int, ...], pspec, mesh: VirtualMesh) -> tuple[int, ...]:
    """Per-coordinate shard shape of a padded leaf under its spec."""
    return tuple(
        size // _axes_size(mesh, axes_of(entry))
        for size, entry in zip(padded, full_rank(pspec, len(padded)))
    )


def _leaf_words(local: tuple[int, ...], itemsize: int) -> int:
    """uint32 words the local shard occupies in the fused buffer (ceil: a
    sub-word tail is zero-padded)."""
    nbytes = int(np.prod(local, dtype=np.int64)) * itemsize
    return -(-nbytes // 4)


@dataclass(frozen=True)
class _Leaf:
    shape: tuple[int, ...]
    dtype: torch.dtype
    pspec: tuple
    padded: tuple[int, ...]
    local: tuple[int, ...]

    @property
    def words(self) -> int:
        return _leaf_words(self.local, self.dtype.itemsize)


def _make_leaf(sd: Any, pspec, mesh: VirtualMesh) -> _Leaf:
    """Layout of one leaf (anything with ``.shape``/``.dtype``) under its spec."""
    shape = tuple(int(s) for s in sd.shape)
    ps = full_rank(pspec, len(shape))
    padded = _pad_shape(shape, ps, mesh)
    return _Leaf(shape, sd.dtype, ps, padded, _local_shape(padded, ps, mesh))


@dataclass(frozen=True)
class FusedBucket:
    """Layout of one per-(axis, dtype) fused exchange buffer.

    ``word_offsets[i]`` is leaf ``leaf_idx[i]``'s start inside each
    coordinate's buffer of ``words`` words; ``axes`` is the union of mesh
    axes the member leaves vary on (in mesh order), the buffer's coordinates.
    """

    tag: str
    axis: str
    dtype: str
    axes: tuple[str, ...]
    leaf_idx: tuple[int, ...] = field(default=())
    word_offsets: tuple[int, ...] = field(default=())
    words: int = 0


@dataclass(frozen=True)
class SnapshotProgram:
    """Snapshot and restore closures + byte accounting."""

    snapshot_fn: Callable      # state -> snapshot payload (dict)
    restore_fn: Callable       # payload -> exchanged leaves re-aligned to origin (copy codec)
    exchanged_names: tuple[str, ...]
    exchanged_bytes: int      # global bytes the reference moves over collectives
    own_bytes: int            # global snapshot bytes (own copies)
    buckets: tuple[FusedBucket, ...] = ()
    pcie_bytes: int = 0       # global device->host bytes per checkpoint
    codec: str = "copy"
    parity_group: int = 0
    # One closure per staging chunk (own copy, then one per bucket), driven
    # by ``staged_snapshot_fetch``.
    snapshot_chunk_fns: tuple = ()
    device: torch.device = torch.device("cpu")
    sent_bytes: int | None = None  # bytes this rank's permutes send per snapshot (process mesh)


def _block_view(x: torch.Tensor, leaf: _Leaf, mesh: VirtualMesh, bucket_axes) -> tuple[torch.Tensor, list[str]]:
    """View a padded leaf as ``(*coords over its axes, *local)``: each dim is
    split into its mesh axes (first axis major) and the local extent, and the
    axis dims are ordered as in ``bucket_axes``. Returns (view, its axes)."""
    assert x.is_contiguous() and tuple(x.shape) == leaf.padded
    split: list[int] = []
    axis_dims: dict[str, int] = {}
    local_dims: list[int] = []
    for size, entry in zip(leaf.padded, full_rank(leaf.pspec, len(leaf.padded))):
        axs = axes_of(entry)
        for a in axs:
            axis_dims[a] = len(split)
            split.append(mesh.shape[a])
        local_dims.append(len(split))
        split.append(size // _axes_size(mesh, axs))
    leaf_axes = [a for a in bucket_axes if a in axis_dims]
    v = x.view(split).permute([axis_dims[a] for a in leaf_axes] + local_dims)
    return v, leaf_axes


def _leaf_slot(buf: torch.Tensor, bucket: FusedBucket, off: int, leaf: _Leaf, mesh: VirtualMesh) -> torch.Tensor:
    """The leaf's segment of every coordinate's fused buffer, viewed as
    ``(*bucket coords, *local)`` in the leaf's dtype (no copy)."""
    sizes = [mesh.shape[a] for a in bucket.axes]
    numel = int(np.prod(leaf.local, dtype=np.int64))
    seg = buf[:, off : off + leaf.words].view(leaf.dtype)[:, :numel]
    return seg.unflatten(0, sizes).unflatten(-1, leaf.local)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _bucket_view(x: torch.Tensor, leaf: _Leaf, mesh: VirtualMesh, bucket_axes) -> torch.Tensor:
    """A leaf (zero-padded to its layout) viewed as ``(*bucket coords,
    *local)``, with size-1 dims for the bucket axes it does not vary on (to
    broadcast: a replicated leaf is not materialised per coordinate)."""
    if tuple(x.shape) != leaf.padded:
        xp = x.new_zeros(leaf.padded)
        xp[tuple(slice(0, s) for s in x.shape)] = x
        x = xp
    v, leaf_axes = _block_view(x.contiguous(), leaf, mesh, bucket_axes)
    for p, a in enumerate(bucket_axes):
        if a not in leaf_axes:
            v = v.unsqueeze(p)
    return v


def _pack_bucket(leaves: list[torch.Tensor], bucket: FusedBucket, meta: dict[int, _Leaf], mesh: VirtualMesh) -> torch.Tensor:
    """The fused ``(n_coords, words)`` uint32 buffer of a bucket: one strided
    copy per leaf straight into its segment."""
    n_coords = _axes_size(mesh, bucket.axes)
    buf = kops.empty_u32((n_coords, bucket.words), mesh.device)
    end = 0
    for i, off in zip(bucket.leaf_idx, bucket.word_offsets):
        leaf = meta[i]
        dst = _leaf_slot(buf, bucket, off, leaf, mesh)
        if leaf.words * 4 != int(np.prod(leaf.local, dtype=np.int64)) * leaf.dtype.itemsize:
            _i32(buf)[:, off + leaf.words - 1] = 0  # as_u32's zero tail
        dst.copy_(_bucket_view(leaves[i], leaf, mesh, bucket.axes).expand(dst.shape))
        end = off + leaf.words
    if end < bucket.words:
        _i32(buf)[:, end:] = 0  # stripe-divisible padding
    return buf


def _pack_rows(leaves: list[torch.Tensor], bucket: FusedBucket, meta: dict[int, _Leaf], mesh: VirtualMesh,
               dtype: torch.dtype) -> torch.Tensor:
    """The compress path's ``(n_coords, L_pad)`` rows of ``dtype``: each
    coordinate's local leaf shards end to end (``L`` elements, padded leaves
    included), zero-padded to a multiple of 256 elements."""
    n_coords = _axes_size(mesh, bucket.axes)
    sizes = [mesh.shape[a] for a in bucket.axes]
    numels = [int(np.prod(meta[i].local, dtype=np.int64)) for i in bucket.leaf_idx]
    length = sum(numels)
    rows = torch.empty((n_coords, -(-length // _quantize_k.QBLOCK) * _quantize_k.QBLOCK),
                       dtype=dtype, device=mesh.device)
    off = 0
    for i, numel in zip(bucket.leaf_idx, numels):
        leaf = meta[i]
        dst = rows[:, off : off + numel].unflatten(0, sizes).unflatten(-1, leaf.local)
        dst.copy_(_bucket_view(leaves[i], leaf, mesh, bucket.axes).expand(dst.shape))
        off += numel
    rows[:, length:] = 0
    return rows


def _unpack_bucket(buf: torch.Tensor, leaves: list[torch.Tensor], bucket: FusedBucket, meta: dict[int, _Leaf], mesh: VirtualMesh) -> None:
    """Write every leaf of the bucket back from the fused buffer, in place
    into ``leaves``. A leaf replicated over a bucket axis takes the
    coordinate at index 0 of that axis (the reference's all_gather(...)[0])."""
    for i, off in zip(bucket.leaf_idx, bucket.word_offsets):
        leaf = meta[i]
        x = leaves[i]
        if not x.is_contiguous():
            raise ValueError(f"leaf {i}: restore writes in place and needs a contiguous tensor")
        padded = tuple(x.shape) != leaf.padded
        tgt = x.new_empty(leaf.padded) if padded else x
        v, leaf_axes = _block_view(tgt, leaf, mesh, bucket.axes)
        src = _leaf_slot(buf, bucket, off, leaf, mesh)
        for p in reversed(range(len(bucket.axes))):
            if bucket.axes[p] not in leaf_axes:
                src = src.select(p, 0)
        v.copy_(src)
        if padded:
            x.copy_(tgt[tuple(slice(0, s) for s in x.shape)])


def overwrite_shards(mesh: VirtualMesh | ProcessMesh, state: Any, state_pspecs: Any, axis: str, ranks, value: float = 99) -> None:
    """Fault injection: overwrite, in place, every shard that coordinates
    ``ranks`` of ``axis`` own, in each leaf sharded over ``axis`` (a killed
    rank's memory). Leaves replicated over ``axis`` survive elsewhere and are
    left alone. On a process mesh ``state`` is this process's shards, and
    only a process whose coordinate is in ``ranks`` overwrites them."""
    _, leaves = tree_flatten(state)
    _, specs = tree_flatten(state_pspecs)
    if isinstance(mesh, ProcessMesh):
        if mesh.coords[axis] in set(ranks):
            for x, ps in zip(leaves, specs):
                if _uses_axis(ps, x.ndim, (axis,)):
                    x.fill_(value)
        return
    for x, ps in zip(leaves, specs):
        if not _uses_axis(ps, x.ndim, (axis,)):
            continue
        leaf = _make_leaf(x, ps, mesh)
        tgt = x
        if leaf.padded != leaf.shape:
            tgt = x.new_zeros(leaf.padded)
            tgt[tuple(slice(0, s) for s in x.shape)] = x
        v, leaf_axes = _block_view(tgt, leaf, mesh, mesh.axis_names)
        for r in ranks:
            v.select(leaf_axes.index(axis), r).fill_(value)
        if tgt is not x:
            x.copy_(tgt[tuple(slice(0, s) for s in x.shape)])


def local_shards(mesh: Any, state: Any, state_pspecs: Any, coords: dict[str, int] | None = None) -> Any:
    """The shards of a whole state at one mesh coordinate (a process mesh's
    own by default): each leaf zero-padded to a multiple of its axes' sizes,
    then its block at the coordinate, a contiguous copy of shape
    ``padded / axes`` (the reference's per-device view under ``shard_map``;
    a leaf on no axis whole). ``mesh`` needs only ``shape`` and
    ``axis_names``."""
    coords = mesh.coords if coords is None else coords
    paths, leaves = tree_flatten(state)
    _, specs = tree_flatten(state_pspecs)
    out = []
    for x, ps in zip(leaves, specs):
        leaf = _make_leaf(x, ps, mesh)
        if leaf.padded != leaf.shape:
            xp = x.new_zeros(leaf.padded)
            xp[tuple(slice(0, s) for s in x.shape)] = x
            x = xp
        v, leaf_axes = _block_view(x.contiguous(), leaf, mesh, mesh.axis_names)
        out.append(v[tuple(coords[a] for a in leaf_axes)].clone(memory_format=torch.contiguous_format))
    return tree_unflatten(paths, out)


def _psum_u32(c: torch.Tensor) -> torch.Tensor:
    """(n_coords, 2) uint32 per-coordinate checksums -> (2,) uint32 sum mod
    2^32 (the reference's psum over the bucket axes)."""
    return u32_from_i64((_i32(c).to(torch.int64) & 0xFFFFFFFF).sum(0) & 0xFFFFFFFF)


def _split_axis(mesh: VirtualMesh, bucket: FusedBucket) -> tuple[int, int, int]:
    """(pre, A, post): the bucket's coordinates as (axes before the failure
    axis, the failure axis, axes after it)."""
    sizes = [mesh.shape[a] for a in bucket.axes]
    p = bucket.axes.index(bucket.axis)
    return int(np.prod(sizes[:p], dtype=np.int64)), sizes[p], int(np.prod(sizes[p + 1 :], dtype=np.int64))


def _stripe_slots(axis_size: int, g: int) -> int:
    """S = ceil(g / k_min): stripe slots each holder keeps (1 when g | axis)."""
    groups = dist.parity_groups(axis_size, g)
    return max(-(-g // len(grp.members)) for grp in groups)


def _encode_rows(codec: str, gen: np.ndarray | None, rows: list[torch.Tensor], k: int,
                 outs: list[torch.Tensor]) -> None:
    """A parity group's blobs from its ``k`` members' rows in member order.
    A short group's missing members are zero rows in the reference; 0·x = 0,
    so its generator is ``coef[:, :k]``."""
    if codec == "xor":
        _xor_k.xor_reduce_into(rows, outs[0])
    else:
        _rs_k.rs_encode_into(rows, [row[:k] for row in gen.tolist()], outs)


# ---------------------------------------------------------------------------
# The per-device body on a process mesh: the reference's collective schedules
# ---------------------------------------------------------------------------

def _ring_pairs(size: int, g: int) -> list[tuple[int, int]]:
    """One within-group ring hop: position p receives p+1's buffer, so after
    t hops position p holds member (p+t) mod k of its group."""
    pairs = []
    for grp in dist.parity_groups(size, g):
        k = len(grp.members)
        pairs += [(grp.members[(q + 1) % k], m) for q, m in enumerate(grp.members)]
    return pairs


def _route_pairs(size: int, g: int, b: int, rnd: int) -> list[tuple[int, int]]:
    """Round ``rnd`` of sending each origin group's blob ``b`` to its holder
    group: holder position p = rnd·k_o + i receives from origin member i."""
    groups = dist.parity_groups(size, g)
    pairs = []
    for gi, grp in enumerate(groups):
        holder = groups[dist.blob_holder_group(len(groups), gi, b)]
        k_o = len(grp.members)
        pairs += [(grp.members[i], holder.members[rnd * k_o + i]) for i in range(k_o)
                  if rnd * k_o + i < len(holder.members)]
    return pairs


def _home_pairs(size: int, g: int, b: int, rnd: int) -> list[tuple[int, int]]:
    """Round ``rnd`` of routing each origin group's reassembled blob ``b``
    home from its holder group: origin position q = rnd·k_h + i receives from
    holder member i."""
    groups = dist.parity_groups(size, g)
    pairs = []
    for gi, grp in enumerate(groups):
        holder = groups[dist.blob_holder_group(len(groups), gi, b)]
        k_h = len(holder.members)
        pairs += [(holder.members[i], grp.members[rnd * k_h + i]) for i in range(k_h)
                  if rnd * k_h + i < len(grp.members)]
    return pairs


def _sends(pairs: list[tuple[int, int]], me: int) -> bool:
    """Whether coordinate ``me`` puts a message on the wire in a permute."""
    return any(s == me and d != me for s, d in pairs)


def _group_pos(size: int, g: int, idx: int) -> tuple[int, int, int]:
    """(group index, position in it, its size) of coordinate ``idx``."""
    gi = idx // g
    return gi, idx % g, len(dist.parity_groups(size, g)[gi].members)


def _check_local(leaves: list[torch.Tensor], meta: dict[int, _Leaf]) -> None:
    for i in meta:
        if tuple(leaves[i].shape) != meta[i].local:
            raise ValueError(f"leaf {i}: a process holds its shard of shape {meta[i].local}, "
                             f"got {tuple(leaves[i].shape)}")


def _pack_local(leaves: list[torch.Tensor], bucket: FusedBucket, meta: dict[int, _Leaf],
                device: torch.device) -> torch.Tensor:
    """This coordinate's fused ``(words,)`` uint32 buffer of a bucket (the
    reference's concatenated ``as_u32`` of the local leaves, zero-padded)."""
    buf = kops.empty_u32(bucket.words, device)
    end = 0
    for i, off in zip(bucket.leaf_idx, bucket.word_offsets):
        leaf = meta[i]
        numel = int(np.prod(leaf.local, dtype=np.int64))
        if leaf.words * 4 != numel * leaf.dtype.itemsize:
            _i32(buf)[off + leaf.words - 1] = 0  # as_u32's zero tail
        buf[off : off + leaf.words].view(leaf.dtype)[:numel].copy_(leaves[i].reshape(-1))
        end = off + leaf.words
    if end < bucket.words:
        _i32(buf)[end:] = 0
    return buf


def _unpack_local(buf: torch.Tensor, meta: dict[int, _Leaf], i: int, off: int) -> torch.Tensor:
    """Leaf ``i``'s local shard, a view of the fused buffer."""
    leaf = meta[i]
    numel = int(np.prod(leaf.local, dtype=np.int64))
    return buf[off : off + leaf.words].view(leaf.dtype)[:numel].view(leaf.local)


class _RankSnapshot:
    """The snapshot program's per-device body on one process of a
    :class:`ProcessMesh`, over its transport."""

    def __init__(self, mesh: ProcessMesh, paths, meta, buckets, *, codec, g, n_parity, gen, scheme, compress,
                 emit_full_blobs, include_own_copy, validate) -> None:
        self.mesh, self.paths, self.meta, self.buckets = mesh, paths, meta, buckets
        self.codec, self.g, self.n_parity, self.gen = codec, g, n_parity, gen
        self.scheme, self.compress, self.emit_full_blobs = scheme, compress, emit_full_blobs
        self.include_own_copy, self.validate = include_own_copy, validate
        self.striped = codec != "copy"

    # -- schedules and accounting ------------------------------------------
    def _compress_len(self, bucket: FusedBucket) -> int:
        n = sum(int(np.prod(self.meta[i].local, dtype=np.int64)) for i in bucket.leaf_idx)
        return -(-n // _quantize_k.QBLOCK) * _quantize_k.QBLOCK

    def sent_bytes(self) -> int:
        """Bytes this process's permutes put on the wire per snapshot: the
        reference's permutes from this coordinate to another."""
        total = 0
        for bucket in self.buckets:
            A, me, nbytes = self.mesh.shape[bucket.axis], self.mesh.coords[bucket.axis], bucket.words * 4
            if not self.striped:
                if _sends(dist.perm_pairs(A, self.scheme), me):
                    n = self._compress_len(bucket)
                    total += n + n // _quantize_k.QBLOCK * 4 if self.compress else nbytes
                continue
            total += (self.g - 1) * nbytes * _sends(_ring_pairs(A, self.g), me)
            if not self.emit_full_blobs:
                total += nbytes * sum(_sends(_route_pairs(A, self.g, b, rnd), me)
                                      for b in range(self.n_parity) for rnd in range(_stripe_slots(A, self.g)))
        return total

    # -- the body ------------------------------------------------------------
    def _leaves(self, state) -> list[torch.Tensor]:
        st_paths, leaves = tree_flatten(state)
        if st_paths != self.paths:
            raise ValueError("state does not match the program's structure")
        for x in leaves:
            if x.device != self.mesh.device:
                raise ValueError(f"state leaf on {x.device}; the process is on {self.mesh.device}")
        _check_local(leaves, self.meta)
        return leaves

    def _compressed(self, bucket: FusedBucket, leaves) -> dict[str, torch.Tensor]:
        tp, dev = self.mesh.transport, self.mesh.device
        dt = self.meta[bucket.leaf_idx[0]].dtype
        row = torch.zeros(self._compress_len(bucket), dtype=dt if dt in _QUANT_DTYPES else torch.float32,
                          device=dev)
        off = 0
        for i in bucket.leaf_idx:
            n = leaves[i].numel()
            row[off : off + n] = leaves[i].reshape(-1)
            off += n
        q = torch.empty(row.numel(), dtype=torch.int8, device=dev)
        scale = torch.empty(row.numel() // _quantize_k.QBLOCK, dtype=torch.float32, device=dev)
        _quantize_k.quantize_into(row, q, scale)
        del row
        pairs = dist.perm_pairs(self.mesh.shape[bucket.axis], self.scheme)
        return {"q": tp.ppermute(q, pairs, bucket.axis), "scale": tp.ppermute(scale, pairs, bucket.axis)}

    def _group_rows(self, buf: torch.Tensor, A: int, axis: str) -> list[torch.Tensor]:
        """The ring of g-1 permutes: the group's k buffers in member order
        (the reference's canonical rows; the zero rows past a short group's
        k are left out)."""
        _, pos, k = _group_pos(A, self.g, self.mesh.coords[axis])
        rows: list[Any] = [None] * k
        rows[pos] = buf
        ring, cur = _ring_pairs(A, self.g), buf
        for t in range(1, self.g):
            cur = self.mesh.transport.ppermute(cur, ring, axis)
            if t < k:
                rows[(pos + t) % k] = cur  # slot t holds member (pos + t) mod k
        return rows

    def _parity(self, bucket: FusedBucket, buf: torch.Tensor) -> tuple[str, torch.Tensor]:
        axis, g, m = bucket.axis, self.g, self.n_parity
        A, me, dev = self.mesh.shape[axis], self.mesh.coords[axis], self.mesh.device
        rows = self._group_rows(buf, A, axis)
        blobs = kops.empty_u32((m, bucket.words), dev)
        _encode_rows(self.codec, self.gen, rows, len(rows), list(blobs.unbind(0)))
        del rows
        if self.emit_full_blobs:
            return "parity_full", blobs
        groups = dist.parity_groups(A, g)
        ng, n_slots, sw = len(groups), _stripe_slots(A, g), bucket.words // g
        gi, pos, k = _group_pos(A, g, me)
        stripes = kops.empty_u32((m, n_slots * sw), dev)
        for b in range(m):
            # my origin group (whose blob I hold) sets the round I keep: the
            # inverse of blob_holder_group's shift h = o + 1 + b mod (ng-1)
            o = (gi - 1 - b % max(ng - 1, 1)) % ng
            keep = min(pos // max(len(groups[o].members), 1), n_slots - 1)
            routed = None
            for rnd in range(n_slots):
                pr = _route_pairs(A, g, b, rnd)
                got = self.mesh.transport.ppermute(blobs[b], pr, axis) if pr else None
                if rnd == keep:
                    routed = got
            for j in range(n_slots):
                s = pos + j * k
                dst = _i32(stripes)[b, j * sw : (j + 1) * sw]
                if s < g and routed is not None:
                    dst.copy_(_i32(routed)[s * sw : (s + 1) * sw])
                else:
                    dst.zero_()
        return "parity", stripes

    def run(self, leaves, sub_buckets, with_checksum: bool) -> dict[str, Any]:
        tp, out, sums = self.mesh.transport, {}, []
        for bucket in sub_buckets:
            if self.compress:
                if with_checksum:
                    buf = _pack_local(leaves, bucket, self.meta, self.mesh.device)
                    sums.append(tp.psum_u32(_checksum_k.checksum_rows(buf.view(1, -1))[0], bucket.axes))
                    del buf
                out.setdefault("partner", {})[bucket.tag] = self._compressed(bucket, leaves)
                continue
            buf = _pack_local(leaves, bucket, self.meta, self.mesh.device)
            if with_checksum:
                sums.append(tp.psum_u32(_checksum_k.checksum_rows(buf.view(1, -1))[0], bucket.axes))
            if self.striped:
                key, val = self._parity(bucket, buf)
            else:
                pairs = dist.perm_pairs(self.mesh.shape[bucket.axis], self.scheme)
                key, val = "partner", tp.ppermute(buf, pairs, bucket.axis)
            del buf
            out.setdefault(key, {})[bucket.tag] = val
        if with_checksum:
            out["checksum"] = (kops.mix_checksums(sums) if sums else
                               torch.zeros(2, dtype=torch.int32, device=self.mesh.device).view(torch.uint32))
        return out

    def snapshot_fn(self, state) -> dict[str, Any]:
        leaves = self._leaves(state)
        payload: dict[str, Any] = {}
        if self.include_own_copy:
            payload["own"] = tree_unflatten(self.paths, [x.clone() for x in leaves])
        payload.update(self.run(leaves, self.buckets, self.validate))
        return payload

    def chunk_fns(self) -> tuple:
        fns: list[Callable] = []
        if self.include_own_copy:
            fns.append(lambda state: {"own": tree_unflatten(self.paths, self._leaves(state))})
        fns += [functools.partial(lambda b, state: self.run(self._leaves(state), [b], False), b)
                for b in self.buckets]
        return tuple(fns)

    def restore_fn(self, payload) -> dict[str, torch.Tensor]:
        """The copy codec: the partner buffers moved back along the inverse
        permutation and unpacked into this coordinate's shards."""
        partner = payload.get("partner")
        if partner is None or self.compress or self.striped:
            raise ValueError("only full-copy uncompressed payloads restore through restore_fn")
        tp, out = self.mesh.transport, {}
        for bucket in self.buckets:
            pairs = dist.inverse_perm(dist.perm_pairs(self.mesh.shape[bucket.axis], self.scheme))
            buf = tp.ppermute(_as_device_u32(partner[bucket.tag], self.mesh.device), pairs, bucket.axis)
            for i, off in zip(bucket.leaf_idx, bucket.word_offsets):
                out[i] = _replicate(self.mesh, _unpack_local(buf, self.meta, i, off).clone(),
                                    bucket, self.meta[i])
        return {str(i): out[i] for b in self.buckets for i in b.leaf_idx}


def _replicate(mesh: ProcessMesh, x: torch.Tensor, bucket: FusedBucket, leaf: _Leaf) -> torch.Tensor:
    """A leaf that does not vary on some of the bucket's axes takes the
    value at index 0 of each (the reference's ``all_gather(leaf, a)[0]``)."""
    leaf_axes = {a for e in leaf.pspec for a in axes_of(e)}
    for a in bucket.axes:
        if a not in leaf_axes and mesh.shape[a] > 1:  # over one process the gather is the identity
            x = mesh.transport.all_gather(x, a)[0]
    return x


@_traced("build_snapshot_program")
def build_snapshot_program(
    mesh: VirtualMesh | ProcessMesh,
    state_sds: Any,            # nested dict of leaves with .shape/.dtype
    state_pspecs: Any,         # nested dict of specs (same structure)
    *,
    redundancy_axis: str = "data",
    scheme: str = "pairwise",
    include_own_copy: bool = True,
    validate: bool = True,
    codec: str = "copy",       # "copy" | "xor" | "rs" | "lrc"
    parity_group: int = 0,     # group size g for the striped codecs
    rs_parity: int = 2,        # m parity blobs for "rs" (global parities for "lrc")
    compress: bool = False,    # int8 partner copies (copy codec only)
    lrc_locals: int = 2,       # local XOR rows for "lrc"
    # whole blobs on every group member instead of routed stripes (more host
    # traffic, no routing)
    emit_full_blobs: bool = False,
) -> SnapshotProgram:
    if codec not in _CODECS:
        raise ValueError(f"codec {codec!r}: this port runs {_CODECS}")
    if compress and codec != "copy":
        raise ValueError("compress applies to the full-copy codec only")
    fail_axes = (redundancy_axis,) if redundancy_axis != "data" else ("data", "pod")
    striped = codec != "copy"
    if striped and parity_group < 1:
        raise ValueError("striped codecs need parity_group (the group size)")
    n_parity = _n_parity(codec, parity_group, rs_parity, lrc_locals)
    g = parity_group if striped else 1
    if striped and n_parity > _build.MAX_M:
        raise ValueError(f"at most {_build.MAX_M} parity blobs per group")
    if striped and g > _build.MAX_K:
        raise ValueError(f"at most {_build.MAX_K} members per parity group")

    paths, leaves_sds = tree_flatten(state_sds)
    ps_paths, leaves_ps = tree_flatten(state_pspecs)
    if ps_paths != paths:
        raise ValueError("state_sds and state_pspecs differ in structure")
    exchanged_idx = [
        i for i, (sd, ps) in enumerate(zip(leaves_sds, leaves_ps))
        if _uses_axis(ps, len(sd.shape), fail_axes)
    ]

    def _leaf_axis(ps, ndim: int) -> str:
        cands = [redundancy_axis] + [a for a in fail_axes if a != redundancy_axis]
        for a in cands:
            if _uses_axis(ps, ndim, (a,)):
                return a
        return redundancy_axis

    meta = {i: _make_leaf(leaves_sds[i], leaves_ps[i], mesh) for i in exchanged_idx}

    by_key: dict[tuple[str, str], list[int]] = {}
    for i in exchanged_idx:
        key = (_leaf_axis(leaves_ps[i], len(meta[i].shape)), dtype_name(meta[i].dtype))
        by_key.setdefault(key, []).append(i)

    buckets: list[FusedBucket] = []
    for (axis, dtype), idxs in sorted(by_key.items()):
        offsets, off = [], 0
        axes_set: set[str] = set()
        for i in idxs:
            offsets.append(off)
            off += meta[i].words
            for e in meta[i].pspec:
                axes_set.update(axes_of(e))
        off += (-off) % g  # stripe-divisible fused length
        buckets.append(FusedBucket(
            tag=f"{axis}:{dtype}", axis=axis, dtype=dtype,
            axes=tuple(a for a in mesh.axis_names if a in axes_set),
            leaf_idx=tuple(idxs), word_offsets=tuple(offsets), words=off,
        ))

    # -- byte accounting (the reference's, term for term) ---------------------
    def _bucket_global_bytes(b: FusedBucket) -> int:
        return b.words * 4 * _axes_size(mesh, b.axes)

    own_bytes = sum(int(np.prod(sd.shape, dtype=np.int64)) * sd.dtype.itemsize for sd in leaves_sds)
    fused_bytes = sum(_bucket_global_bytes(b) for b in buckets)
    if striped:
        # ring collection (g-1 hops) + blob routing (m hops x S rounds, the
        # stripe path only: full blobs stay where they were encoded)
        exchanged_bytes = sum(
            (g - 1 + (0 if emit_full_blobs else n_parity * _stripe_slots(mesh.shape[b.axis], g)))
            * _bucket_global_bytes(b)
            for b in buckets
        )
        if emit_full_blobs:
            pcie_payload = n_parity * fused_bytes
        else:
            pcie_payload = sum(
                n_parity * _bucket_global_bytes(b) * _stripe_slots(mesh.shape[b.axis], g) // g
                for b in buckets
            )
    else:
        exchanged_bytes = fused_bytes
        pcie_payload = fused_bytes if not compress else fused_bytes // 4
    pcie_bytes = (own_bytes if include_own_copy else 0) + pcie_payload

    gen = _generator(codec, g, rs_parity, lrc_locals) if codec in ("rs", "lrc") else None

    def _permuted(bucket: FusedBucket, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
        """The copy codec: rows of ``x`` (one per bucket coordinate) moved
        along the scheme's pairs (or their inverse), coordinate ``dst``
        receiving ``src``'s row, flattened — the reference's ``ppermute`` of
        each coordinate's local array (coordinates no pair reaches get
        zeros)."""
        pre, A, post = _split_axis(mesh, bucket)
        B = x.view(pre, A, post, -1)
        out = torch.zeros_like(B)
        pairs = dist.perm_pairs(A, scheme)
        for src, dst in dist.inverse_perm(pairs) if inverse else pairs:
            out[:, dst] = B[:, src]
        return out.view(-1)

    def _compressed(bucket: FusedBucket, leaves: list[torch.Tensor]) -> dict[str, torch.Tensor]:
        """int8 codes and f32 scales of every coordinate's row, one quantize
        launch for the whole bucket, then moved to the partners."""
        dt = meta[bucket.leaf_idx[0]].dtype
        rows = _pack_rows(leaves, bucket, meta, mesh, dt if dt in _QUANT_DTYPES else torch.float32)
        q = torch.empty(rows.numel(), dtype=torch.int8, device=mesh.device)
        scale = torch.empty(rows.numel() // _quantize_k.QBLOCK, dtype=torch.float32, device=mesh.device)
        _quantize_k.quantize_into(rows.view(-1), q, scale)
        del rows
        return {"q": _permuted(bucket, q), "scale": _permuted(bucket, scale)}

    if isinstance(mesh, ProcessMesh):
        fns = _RankSnapshot(mesh, paths, meta, buckets, codec=codec, g=g, n_parity=n_parity, gen=gen,
                            scheme=scheme, compress=compress, emit_full_blobs=emit_full_blobs,
                            include_own_copy=include_own_copy, validate=validate)
        return SnapshotProgram(
            snapshot_fn=fns.snapshot_fn, restore_fn=fns.restore_fn,
            exchanged_names=tuple(str(i) for i in exchanged_idx), exchanged_bytes=exchanged_bytes,
            own_bytes=own_bytes, buckets=tuple(buckets), pcie_bytes=pcie_bytes, codec=codec,
            parity_group=parity_group, snapshot_chunk_fns=fns.chunk_fns(), device=mesh.device,
            sent_bytes=fns.sent_bytes(),
        )

    def _full_blobs(bucket: FusedBucket, buf: torch.Tensor) -> torch.Tensor:
        """Every member keeps its group's whole blobs: ``(m, n_coords·words)``
        like the reference, each group's blobs encoded once into its first
        member's slot and copied to the others."""
        pre, A, post = _split_axis(mesh, bucket)
        B = buf.view(pre, A, post, bucket.words)
        out = kops.empty_u32((n_parity, pre, A, post, bucket.words), mesh.device)
        for p in range(pre):
            for q in range(post):
                for grp in dist.parity_groups(A, g):
                    rows = [B[p, r, q] for r in grp.members]
                    first = grp.members[0]
                    _encode_rows(codec, gen, rows, len(grp.members), [out[b, p, first, q] for b in range(n_parity)])
                    for member in grp.members[1:]:
                        _i32(out)[:, p, member, q] = _i32(out)[:, p, first, q]
        return out.view(n_parity, -1)

    def _parity(bucket: FusedBucket, buf: torch.Tensor) -> torch.Tensor:
        """Encode each parity group's blobs once and slice them into the
        holders' stripe slots: ``(m, n_coords·S·sw)`` like the reference."""
        pre, A, post = _split_axis(mesh, bucket)
        B = buf.view(pre, A, post, bucket.words)
        groups = dist.parity_groups(A, g)
        ng = len(groups)
        n_slots = _stripe_slots(A, g)
        sw = bucket.words // g
        out = kops.empty_u32((n_parity, pre, A, post, n_slots * sw), mesh.device)
        # every group full and nothing after the failure axis: blob b of
        # group gi is exactly the contiguous run of its holder group's slots,
        # so the kernel writes the payload in place
        direct = n_slots == 1 and post == 1
        blob = None if direct else kops.empty_u32((n_parity, bucket.words), mesh.device)
        for p in range(pre):
            for q in range(post):
                for gi, grp in enumerate(groups):
                    k = len(grp.members)
                    rows = [B[p, r, q] for r in grp.members]  # views: the ring, uncopied
                    holders = [groups[dist.blob_holder_group(ng, gi, b)] for b in range(n_parity)]
                    if direct:
                        outs = [out[b, p, h.members[0] : h.members[-1] + 1, 0].view(-1)
                                for b, h in enumerate(holders)]
                    else:
                        outs = list(blob.unbind(0))
                    _encode_rows(codec, gen, rows, k, outs)
                    if direct:
                        continue
                    for b, h in enumerate(holders):
                        k_h = len(h.members)
                        for pos, member in enumerate(h.members):
                            for j in range(n_slots):
                                s = pos + j * k_h
                                dst = _i32(out)[b, p, member, q, j * sw : (j + 1) * sw]
                                if s < g:
                                    dst.copy_(_i32(blob)[b, s * sw : (s + 1) * sw])
                                else:
                                    dst.zero_()
        return out.view(n_parity, -1)

    def _encode(bucket: FusedBucket, buf: torch.Tensor) -> tuple[str, torch.Tensor]:
        if striped and emit_full_blobs:
            return "parity_full", _full_blobs(bucket, buf)
        if striped:
            return "parity", _parity(bucket, buf)
        return "partner", _permuted(bucket, _i32(buf)).view(torch.uint32)

    def _check_state(state) -> list[torch.Tensor]:
        st_paths, leaves = tree_flatten(state)
        if st_paths != paths:
            raise ValueError("state does not match the program's structure")
        for x in leaves:
            if x.device != mesh.device:
                raise ValueError(f"state leaf on {x.device}; the mesh is on {mesh.device}")
        return leaves

    def _run_buckets(leaves, sub_buckets, with_checksum: bool) -> dict[str, Any]:
        out: dict[str, Any] = {}
        sums = []
        for bucket in sub_buckets:
            if compress:
                # the checksum still covers the uncompressed fused buffer
                if with_checksum:
                    buf = _pack_bucket(leaves, bucket, meta, mesh)
                    sums.append(_psum_u32(_checksum_k.checksum_rows(buf)))
                    del buf
                out.setdefault("partner", {})[bucket.tag] = _compressed(bucket, leaves)
                continue
            buf = _pack_bucket(leaves, bucket, meta, mesh)
            if with_checksum:
                sums.append(_psum_u32(_checksum_k.checksum_rows(buf)))
            key, val = _encode(bucket, buf)
            del buf  # the fused buffer is scratch: free it before the next bucket
            out.setdefault(key, {})[bucket.tag] = val
        if with_checksum:
            out["checksum"] = (
                kops.mix_checksums(sums) if sums
                else torch.zeros(2, dtype=torch.int32, device=mesh.device).view(torch.uint32)
            )
        return out

    def snapshot_fn(state):
        leaves = _check_state(state)
        payload: dict[str, Any] = {}
        if include_own_copy:
            # explicit copies: the snapshot must survive mutation of the live state
            payload["own"] = tree_unflatten(paths, [x.clone() for x in leaves])
        payload.update(_run_buckets(leaves, buckets, validate))
        return payload

    # Chunk 0 hands out the live tensors themselves: the staged path copies
    # them straight into pinned host memory, with no device copy first (the
    # reference copies on device, ``jnp.copy``). Chunk i+1 runs bucket i's
    # encode without the checksum, which only ``snapshot_fn`` folds.
    def _own_chunk(state):
        return {"own": tree_unflatten(paths, _check_state(state))}

    def _bucket_chunk(bucket):
        return lambda state: _run_buckets(_check_state(state), [bucket], False)

    def restore_fn(payload) -> dict[str, torch.Tensor]:
        """Re-align the partner copies to their origin coordinates (the
        inverse permutation) and unpack every exchanged leaf, at its global
        shape: ``{str(leaf index): tensor}``. The copy codec's uncompressed
        payloads only; striped and compressed payloads reconstruct through
        the codec."""
        partner = payload.get("partner")
        if partner is None or compress or striped:
            raise ValueError("only full-copy uncompressed payloads restore through restore_fn")
        out: dict[int, torch.Tensor] = {}
        for bucket in buckets:
            buf = _permuted(bucket, _i32(partner[bucket.tag].to(mesh.device)), inverse=True)
            for i in bucket.leaf_idx:
                out[i] = torch.empty(meta[i].shape, dtype=meta[i].dtype, device=mesh.device)
            _unpack_bucket(buf.view(torch.uint32).view(-1, bucket.words), out, bucket, meta, mesh)
        return {str(i): out[i] for b in buckets for i in b.leaf_idx}

    chunk_fns: list[Callable] = [_own_chunk] if include_own_copy else []
    chunk_fns.extend(_bucket_chunk(b) for b in buckets)
    log.debug(
        "snapshot program: codec=%s g=%d buckets=%s own=%d exchanged=%d pcie=%d bytes",
        codec, g, [(b.tag, b.words) for b in buckets], own_bytes, exchanged_bytes, pcie_bytes,
    )

    return SnapshotProgram(
        snapshot_fn=snapshot_fn,
        restore_fn=restore_fn,
        exchanged_names=tuple(str(i) for i in exchanged_idx),
        exchanged_bytes=exchanged_bytes,
        own_bytes=own_bytes,
        buckets=tuple(buckets),
        pcie_bytes=pcie_bytes,
        codec=codec,
        parity_group=parity_group,
        snapshot_chunk_fns=tuple(chunk_fns),
        device=mesh.device,
    )


@_traced("build_mirror_program")
def build_mirror_program(
    mesh: VirtualMesh | ProcessMesh,
    state_sds: Any,
    state_pspecs: Any,
    *,
    replica_axis: str = "data",
    validate: bool = True,
) -> SnapshotProgram:
    """The hot-replica transport: the fused snapshot program's buckets routed
    to the *shadow team* instead of a parity group. ``replica_axis`` is
    primary half + shadow half (teams of T = axis/2 coordinates); one
    permutation per bucket lands every primary coordinate's fused buffer on
    its shadow twin at ``i + T``. No parity, no own copy, no compression:
    ``snapshot_fn`` emits ``{"mirror": {tag: fused buffer}}`` (+ the folded
    handshake checksum when ``validate``), unpackable with the bucket's
    ``word_offsets`` like a partner payload."""
    prog = build_snapshot_program(
        mesh, state_sds, state_pspecs, redundancy_axis=replica_axis, scheme="mirror",
        include_own_copy=False, compress=False, validate=validate, codec="copy",
    )
    inner = prog.snapshot_fn

    def mirror_fn(state):
        payload = inner(state)
        if "partner" in payload:
            payload["mirror"] = payload.pop("partner")
        return payload

    return replace(prog, snapshot_fn=mirror_fn)


# ---------------------------------------------------------------------------
# Double-buffered device staging (create path)
# ---------------------------------------------------------------------------

def _host_copy(t: torch.Tensor, non_blocking: bool) -> torch.Tensor:
    """A host copy of a tensor: pinned and asynchronous from the card, a
    plain clone on the CPU (the staged payload never aliases live state)."""
    if t.device.type == "cpu":
        return t.clone()
    u32 = t.dtype == torch.uint32
    src = _i32(t) if u32 else t
    host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    host.copy_(src, non_blocking=non_blocking)
    return host.view(torch.uint32) if u32 else host


def staged_snapshot_fetch(prog: SnapshotProgram, state: Any, *, double_buffer: bool = True) -> dict[str, Any]:
    """Stage the snapshot to host memory chunk by chunk (own copy, then one
    chunk per bucket). With ``double_buffer`` on a card, chunk *i*'s
    device-to-host copy runs on a side stream into pinned memory while the
    current stream computes chunk *i+1*'s encode; ``False`` fetches each
    chunk before computing the next.

    Returns the host payload (CPU tensors), byte-identical to
    ``prog.snapshot_fn``'s payload without the checksum.
    """
    on_card = prog.device.type == "cuda"
    side = torch.cuda.Stream(prog.device) if on_card and double_buffer else None
    in_flight: list[Any] = []  # device outputs kept alive until their copies land
    payload: dict[str, Any] = {}
    for i, fn in enumerate(prog.snapshot_chunk_fns):
        with _TR.span("d2h_dispatch", chunk=i, double_buffer=double_buffer):
            out = fn(state)  # enqueued on the current stream
            if side is not None:
                ready = torch.cuda.Event()
                ready.record()
                with torch.cuda.stream(side):
                    side.wait_event(ready)
                    host = tree_map(lambda t: _host_copy(t, True), out)
                in_flight.append(out)
            else:
                host = tree_map(lambda t: _host_copy(t, False), out)
        for key, val in host.items():
            if isinstance(val, dict) and key in payload:
                payload[key].update(val)
            else:
                payload[key] = val
    if side is not None:
        with _TR.span("d2h_merge"):
            side.synchronize()
        in_flight.clear()
    return payload


# ---------------------------------------------------------------------------
# Striped RESTORE program
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StripedRestoreProgram:
    """Reconstruction of failed coordinates for the striped codecs.

    ``restore_fn(state, parity, decode_rows, survivor_mask)`` rebuilds every
    failed coordinate's shards on the device and returns the exchanged
    leaves ``{str(leaf index): tensor}``. ``decode_rows``/``survivor_mask``
    are per failure axis (from :func:`striped_decode_rows`), so one kernel
    serves every failure combination.
    """

    restore_fn: Callable
    buckets: tuple[FusedBucket, ...]
    pcie_bytes: int            # uploads: survivor shards + held stripes
    host_decode_pcie_bytes: int  # the host-decode alternative's PCIe bill
    codec: str
    parity_group: int
    rs_parity: int
    axes: tuple[str, ...]      # failure axes needing decode_rows/mask entries
    n_parity: int              # stripe rows per device (codec blobs)
    stripe_words: tuple[tuple[str, int], ...]  # tag -> per-device stripe words


def striped_decode_rows(
    axis_size: int,
    parity_group: int,
    codec: str,
    rs_parity: int,
    failed: set[int] | tuple[int, ...],
    lrc_locals: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """Host precompute for the restore: per failure-axis coordinate ONE decode
    row over the ``g + m`` inputs ``[group data 0..g-1, blobs 0..m-1]``.

    Survivors get their one-hot identity row; each failed coordinate gets its
    row of ``gf256.erasure_decode_matrix``. For ``lrc`` the rows it solves
    through are the codec's own cheapest invertible set (a single loss: one
    local parity, zero coefficients outside its subgroup). Returns ``(rows
    (size, g+m) uint32, mask (ng·g,) uint32)``; raises ``ValueError`` when
    the failure set exceeds the codec's tolerance or destroys the blobs
    needed to cover it.
    """
    if codec not in ("xor", "rs", "lrc"):
        raise ValueError(f"codec {codec!r}: this port decodes ('xor', 'rs', 'lrc')")
    g = parity_group
    coef = _generator(codec, g, rs_parity, lrc_locals)
    helper = codec_mod.LRCCodec(g, lrc_locals, rs_parity) if codec == "lrc" else None
    m = coef.shape[0]
    failed = set(failed)
    groups = dist.parity_groups(axis_size, g)
    ng = len(groups)
    rows = np.zeros((axis_size, g + m), np.uint8)
    mask = np.zeros(ng * g, np.uint32)
    mask[:axis_size] = 1
    for r in failed:
        mask[r] = 0
    for gi, grp in enumerate(groups):
        missing = [q for q, r in enumerate(grp.members) if r in failed]
        present = [q for q in range(len(grp.members)) if q not in missing]
        for q in present:
            rows[grp.members[q], q] = 1
        if not missing:
            continue
        if helper is None and len(missing) > m:
            raise ValueError(f"group {gi} lost {len(missing)} members; codec {codec!r} tolerates {m}")
        # a blob is usable iff every holder of its stripes survives
        usable = [
            b for b in range(m)
            if all(h not in failed for h in groups[dist.blob_holder_group(ng, gi, b)].members)
        ]
        if helper is not None:
            try:
                sel = helper._decode_rows(sorted(usable), missing, present)
            except codec_mod.CodecDecodeError as exc:
                raise ValueError(str(exc)) from exc
        elif len(usable) < len(missing):
            raise ValueError(
                f"group {gi}: {len(missing)} losses but only "
                f"{len(usable)} intact redundancy blobs (codec {codec!r})"
            )
        else:
            sel = usable[: len(missing)]
        D = gf256.erasure_decode_matrix(g, coef, present, sel, missing)
        for t, q in enumerate(missing):
            rows[grp.members[q]] = D[t]
    return rows.astype(np.uint32), mask


def _as_device_u32(x: Any, device: torch.device) -> torch.Tensor:
    """A uint32 payload array (numpy or tensor) as a tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).view(torch.uint32)
    if x.dtype != torch.uint32:
        raise ValueError(f"expected uint32 parity, got {x.dtype}")
    return _i32(x).to(device).view(torch.uint32)


@_traced("build_striped_restore_program")
def build_striped_restore_program(
    mesh: VirtualMesh | ProcessMesh,
    state_sds: Any,
    state_pspecs: Any,
    *,
    redundancy_axis: str = "data",
    codec: str = "xor",
    parity_group: int = 1,
    rs_parity: int = 2,
    lrc_locals: int = 2,
) -> StripedRestoreProgram:
    """The inverse of the striped snapshot program.

    For each parity group with failed members: the group's blobs are
    reassembled from their holders' stripe slots (read in place when they are
    contiguous), and one decode-kernel launch per group writes every failed
    member's fused buffer from the surviving members' rows and the blobs,
    with the failed members' decode rows as runtime coefficients. Survivors'
    rows are their identity rows in the reference: their buffers pass
    through, so no kernel touches them here.

    The state is repaired **in place**: the failed shards of the caller's
    tensors are overwritten (the reference returns new arrays). This saves a
    second copy of the exchanged state on the card.
    """
    if codec not in ("xor", "rs", "lrc"):
        raise ValueError(f"codec {codec!r}: this port restores ('xor', 'rs', 'lrc')")
    if parity_group < 1:
        raise ValueError("parity_group must be >= 1")
    n_parity = _n_parity(codec, parity_group, rs_parity, lrc_locals)
    g = parity_group

    # Same bucketing as the snapshot program: the parity payload this program
    # consumes is the one the snapshot emitted.
    snap = build_snapshot_program(
        mesh, state_sds, state_pspecs, redundancy_axis=redundancy_axis,
        include_own_copy=False, validate=False, codec=codec,
        parity_group=parity_group, rs_parity=rs_parity, lrc_locals=lrc_locals,
    )
    buckets = snap.buckets
    paths, leaves_sds = tree_flatten(state_sds)
    _, leaves_ps = tree_flatten(state_pspecs)
    meta = {i: _make_leaf(leaves_sds[i], leaves_ps[i], mesh) for b in buckets for i in b.leaf_idx}
    axes = tuple(sorted({b.axis for b in buckets}))
    fused = sum(b.words * 4 * _axes_size(mesh, b.axes) for b in buckets)
    stripes_bytes = sum(
        n_parity * b.words * 4 * _axes_size(mesh, b.axes) * _stripe_slots(mesh.shape[b.axis], g) // g
        for b in buckets
    )
    stripe_words = tuple(
        (b.tag, _stripe_slots(mesh.shape[b.axis], g) * (b.words // g)) for b in buckets
    )

    def _program(restore_fn: Callable) -> StripedRestoreProgram:
        return StripedRestoreProgram(
            restore_fn=restore_fn, buckets=buckets, pcie_bytes=fused + stripes_bytes,
            host_decode_pcie_bytes=2 * fused + stripes_bytes, codec=codec, parity_group=parity_group,
            rs_parity=rs_parity, axes=axes, n_parity=n_parity, stripe_words=stripe_words,
        )

    if isinstance(mesh, ProcessMesh):
        return _program(functools.partial(_rank_striped_restore, mesh, paths, meta, buckets, g, n_parity))

    def _blob(par: torch.Tensor, holder: dist.ParityGroup, p: int, q: int, b: int,
              words: int, sw: int, n_slots: int, post: int) -> torch.Tensor:
        """Blob b of the group whose stripes ``holder`` keeps: stripe s sits
        at holder member s mod k_h, slot s // k_h."""
        if n_slots == 1 and post == 1:
            return par[b, p, holder.members[0] : holder.members[-1] + 1, 0].view(-1)
        k_h = len(holder.members)
        full = kops.empty_u32(words, mesh.device)
        for s in range(g):
            member, slot = holder.members[s % k_h], s // k_h
            _i32(full)[s * sw : (s + 1) * sw] = _i32(par)[b, p, member, q, slot * sw : (slot + 1) * sw]
        return full

    def restore_fn(state, parity, decode_rows, survivor_mask):
        st_paths, leaves = tree_flatten(state)
        if st_paths != paths:
            raise ValueError("state does not match the program's structure")
        result: dict[str, torch.Tensor] = {}
        for bucket in buckets:
            pre, A, post = _split_axis(mesh, bucket)
            rows = np.asarray(decode_rows[bucket.axis]).astype(np.int64)
            mask = np.asarray(survivor_mask[bucket.axis])
            failed = {a for a in range(A) if mask[a] == 0}
            if not failed:
                for i in bucket.leaf_idx:
                    result[str(i)] = leaves[i]
                continue
            n_slots = _stripe_slots(A, g)
            sw = bucket.words // g
            par = _as_device_u32(parity[bucket.tag], mesh.device).view(n_parity, pre, A, post, n_slots * sw)
            buf = _pack_bucket(leaves, bucket, meta, mesh)  # failed rows hold garbage
            B = buf.view(pre, A, post, bucket.words)
            groups = dist.parity_groups(A, g)
            for gi, grp in enumerate(groups):
                miss = [r for r in grp.members if r in failed]
                if not miss:
                    continue
                # Inputs with an all-zero coefficient column are dropped
                # (0·x = 0): the failed members' own rows (the reference
                # zeroes them with the mask) and unused blobs.
                cols = [q for q, r in enumerate(grp.members) if r not in failed]
                cols += [g + b for b in range(n_parity)]
                cols = [c for c in cols if rows[miss][:, c].any()]
                coef = torch.from_numpy(rows[np.ix_(miss, cols)].astype(np.int32)).view(torch.uint32)
                coef = _i32(coef).to(mesh.device).view(torch.uint32)
                for p in range(pre):
                    for q in range(post):
                        inputs = []
                        for c in cols:
                            if c < g:
                                inputs.append(B[p, grp.members[c], q])
                            else:
                                holder = groups[dist.blob_holder_group(len(groups), gi, c - g)]
                                inputs.append(_blob(par, holder, p, q, c - g, bucket.words, sw, n_slots, post))
                        _rsd_k.rs_decode_into(inputs, coef, [B[p, r, q] for r in miss])
            _unpack_bucket(buf, leaves, bucket, meta, mesh)
            del buf
            for i in bucket.leaf_idx:
                result[str(i)] = leaves[i]
        return result

    return _program(restore_fn)


def _rank_striped_restore(mesh: ProcessMesh, paths, meta: dict[int, _Leaf], buckets, g: int, n_parity: int,
                          state, parity, decode_rows, survivor_mask) -> dict[str, torch.Tensor]:
    """The striped restore's per-device body on one process: ``state`` is
    its shards (a failed coordinate's hold garbage), ``parity`` its payload's
    stripes. The processes run the reference's schedule for the parity
    groups that lost a member: for each blob of such a group, the ring of
    g-1 permutes in its holder group, the splice and the rounds home; then
    the ring of the group's data, zeroed where the mask is 0. A failed
    coordinate applies its decode row with B4 (columns with a zero
    coefficient left out) and writes its shards in place; a survivor's row
    is its identity, so its shards stand, and the rings and routes of the
    groups that lost no member, which feed only such rows in the reference,
    are not run. A bucket whose axis lost no coordinate is left alone."""
    st_paths, leaves = tree_flatten(state)
    if st_paths != paths:
        raise ValueError("state does not match the program's structure")
    _check_local(leaves, meta)
    tp, dev = mesh.transport, mesh.device
    result: dict[str, torch.Tensor] = {}
    for bucket in buckets:
        axis = bucket.axis
        A, me = mesh.shape[axis], mesh.coords[axis]
        rows = np.asarray(decode_rows[axis]).astype(np.int64)
        mask = np.asarray(survivor_mask[axis])
        if mask[:A].all():
            for i in bucket.leaf_idx:
                result[str(i)] = leaves[i]
            continue
        groups = dist.parity_groups(A, g)
        ng, n_slots, sw = len(groups), _stripe_slots(A, g), bucket.words // g
        gi, pos, k = _group_pos(A, g, me)
        ring = _ring_pairs(A, g)
        par = _as_device_u32(parity[bucket.tag], dev).view(n_parity, n_slots * sw)
        # Only a group that lost a member reads blobs and data (a survivor's
        # row is its identity): the rings and routes run for those alone.
        # Each decision is the same on both ends of every pair.
        hurt = {q for q, grp in enumerate(groups) if not mask[list(grp.members)].all()}

        def origin(h: int, b: int) -> int:  # whose blob b group h holds
            return (h - 1 - b % max(ng - 1, 1)) % ng

        blob_rows: list[Any] = [None] * n_parity
        for b in range(n_parity):
            full = None
            if origin(gi, b) in hurt:
                # my group's stripe buffers in member order: stripe s of the
                # blob sits at member s mod k, slot s // k
                held: list[Any] = [None] * k
                held[pos] = cur = par[b]
                for t in range(1, g):
                    cur = tp.ppermute(cur, ring, axis)
                    if t < k:
                        held[(pos + t) % k] = cur
                full = kops.empty_u32(bucket.words, dev)
                for s in range(g):
                    _i32(full)[s * sw : (s + 1) * sw] = _i32(held[s % k])[(s // k) * sw : (s // k + 1) * sw]
                del held, cur
            # route home; my blob-b holder group's size sets the round I keep
            h = (gi + 1 + b % max(ng - 1, 1)) % ng
            keep = min(pos // max(len(groups[h].members), 1), n_slots - 1)
            for rnd in range(n_slots):
                pr = [(s, d) for s, d in _home_pairs(A, g, b, rnd) if d // g in hurt]
                if not any(me in pair for pair in pr):
                    continue
                got = tp.ppermute(full if full is not None else kops.empty_u32(bucket.words, dev), pr, axis)
                if rnd == keep and gi in hurt:
                    blob_rows[b] = got
            del full
        if gi in hurt:
            buf = _pack_local(leaves, bucket, meta, dev)
            if mask[me] == 0:
                _i32(buf).zero_()  # the reference's mask: a failed coordinate sends zeros
            data: list[Any] = [None] * k
            data[pos] = cur = buf
            for t in range(1, g):
                cur = tp.ppermute(cur, ring, axis)
                if t < k:
                    data[(pos + t) % k] = cur
            if mask[me] == 0:
                # inputs with a zero coefficient are left out (0·x = 0): the
                # failed members' rows, the zero rows past a short group, the
                # blobs whose holders died
                mine = rows[me]
                cols = [c for c in range(g + n_parity)
                        if mine[c] and (c < k if c < g else blob_rows[c - g] is not None)]
                if not cols:
                    raise ValueError(f"coordinate {me} of {axis!r}: an empty decode row")
                inputs = [data[c] if c < g else blob_rows[c - g] for c in cols]
                coef = torch.from_numpy(mine[cols][None].astype(np.int32)).to(dev).view(torch.uint32)
                _rsd_k.rs_decode_into(inputs, coef, [buf])
                for i, off in zip(bucket.leaf_idx, bucket.word_offsets):
                    leaves[i].copy_(_unpack_local(buf, meta, i, off))
            del data, buf, cur
        del blob_rows
        for i in bucket.leaf_idx:
            result[str(i)] = _replicate(mesh, leaves[i], bucket, meta[i])
            if result[str(i)] is not leaves[i]:
                leaves[i].copy_(result[str(i)])
                result[str(i)] = leaves[i]
    return result


# ---------------------------------------------------------------------------
# Program cache: building walks the whole state tree, so repeated builds for
# the same (mesh, structure, codec) reuse the result. Thread-safe, LRU-bounded.
# ---------------------------------------------------------------------------

_PROGRAM_CACHE: OrderedDict = OrderedDict()
_PROGRAM_CACHE_LOCK = threading.Lock()
_PROGRAM_CACHE_MAX = 16
_PROGRAM_CACHE_STATS = {"hits": 0, "misses": 0}


def _program_cache_key(kind: str, mesh: VirtualMesh | ProcessMesh, state_sds: Any, state_pspecs: Any, kw: dict) -> tuple:
    paths, leaves = tree_flatten(state_sds)
    _, specs = tree_flatten(state_pspecs)
    # a process mesh's program closes over its group: key on the process too
    proc = (mesh.rank, mesh.backend, id(mesh.group)) if isinstance(mesh, ProcessMesh) else None
    return (
        kind, type(mesh).__name__, proc, mesh.axes, str(mesh.device), tuple(paths),
        tuple((tuple(int(s) for s in x.shape), dtype_name(x.dtype)) for x in leaves),
        tuple(repr(s) for s in specs),
        tuple(sorted(kw.items())),
    )


def _cached_program(kind, builder, mesh, state_sds, state_pspecs, kw):
    key = _program_cache_key(kind, mesh, state_sds, state_pspecs, kw)
    with _PROGRAM_CACHE_LOCK:
        prog = _PROGRAM_CACHE.get(key)
        if prog is not None:
            _PROGRAM_CACHE.move_to_end(key)
            _PROGRAM_CACHE_STATS["hits"] += 1
            return prog
    prog = builder(mesh, state_sds, state_pspecs, **kw)
    with _PROGRAM_CACHE_LOCK:
        _PROGRAM_CACHE_STATS["misses"] += 1
        _PROGRAM_CACHE[key] = prog
        _PROGRAM_CACHE.move_to_end(key)
        while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_MAX:
            _PROGRAM_CACHE.popitem(last=False)
    return prog


def cached_snapshot_program(mesh: VirtualMesh | ProcessMesh, state_sds: Any, state_pspecs: Any, **kw: Any) -> SnapshotProgram:
    """``build_snapshot_program`` through the bounded program cache."""
    return _cached_program("snapshot", build_snapshot_program, mesh, state_sds, state_pspecs, kw)


def cached_striped_restore_program(mesh: VirtualMesh | ProcessMesh, state_sds: Any, state_pspecs: Any, **kw: Any) -> StripedRestoreProgram:
    """``build_striped_restore_program`` through the bounded program cache."""
    return _cached_program("striped_restore", build_striped_restore_program, mesh, state_sds, state_pspecs, kw)


def program_cache_stats() -> dict[str, int]:
    with _PROGRAM_CACHE_LOCK:
        return dict(_PROGRAM_CACHE_STATS, size=len(_PROGRAM_CACHE))


def program_cache_clear() -> None:
    with _PROGRAM_CACHE_LOCK:
        _PROGRAM_CACHE.clear()
        _PROGRAM_CACHE_STATS.update(hits=0, misses=0)
