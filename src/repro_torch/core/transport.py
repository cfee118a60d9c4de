"""The collectives of the device tier's per-device body over a process group.

The reference's per-device body runs under ``shard_map`` and moves buffers
with ``jax.lax.ppermute``, ``psum`` and ``all_gather`` over named mesh axes.
Here every mesh coordinate is a process of a :class:`ProcessMesh`, and
:class:`Transport` does the same three over its ``torch.distributed`` group:

* ``ppermute(x, pairs, axis)``: ``dist.batch_isend_irecv`` between the
  processes that share this one's coordinates on every other axis. A
  coordinate that no pair reaches gets zeros, as in ``jax.lax.ppermute``; a
  pair from a coordinate to itself is a local copy, not a message;
* ``psum_u32(c, axes)``: the int64 partials gathered over the axes' group and
  summed mod 2^32 (torch's CPU ops do not wrap a uint32 sum, and the
  backends differ in their uint32 support);
* ``all_gather(x, axis)``: the axis group's tensors stacked in axis order.

The backend is the one the mesh was made with; the transport never picks
one. ``"nccl"`` sends the tensors where they lie, on the rank's card.
``"gloo"`` reads host memory, so a tensor on a card is copied to pinned
host memory, sent, received into pinned host memory and copied back onto
the card, each step in the open here, in chunks of ``chunk_bytes`` so that
the copies of one chunk overlap the wire time of the next. uint32 tensors
cross as int32 (same bytes).

``sent_bytes``/``recv_bytes`` count the bytes this process's permutes put
on and took off the wire (what the reference's permutes move);
``collective_bytes`` the bytes it contributed to ``psum_u32`` and
``all_gather``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels.ref import u32_from_i64


def _wire_dtype(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous tensor of a dtype every backend sends."""
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


class Transport:
    """``ppermute``, ``psum_u32`` and ``all_gather`` of one process mesh."""

    def __init__(self, mesh: Any) -> None:
        if mesh.backend == "nccl" and mesh.device.type != "cuda":
            raise ValueError("nccl moves tensors on the card: a process mesh on the CPU needs gloo")
        self.mesh = mesh
        # gloo's point-to-point reads host memory: tensors on a card are staged
        self.staged = mesh.backend == "gloo" and mesh.device.type == "cuda"
        self.chunk_bytes = 64 << 20
        self.sent_bytes = 0
        self.recv_bytes = 0
        self.collective_bytes = 0

    def reset_counts(self) -> None:
        self.sent_bytes = self.recv_bytes = self.collective_bytes = 0

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        return x.to("cpu") if self.staged else x

    def _staged_exchange(self, wire: torch.Tensor, out: torch.Tensor, dst: int | None, src: int | None) -> None:
        """Send ``wire`` to rank ``dst`` and receive rank ``src``'s into
        ``out`` through host buffers, chunk by chunk: every receive is posted
        first, then each chunk is copied to the host and sent while the
        previous one is on the wire, and each arrived chunk is copied back
        onto the device while the next one arrives."""
        n = wire.numel() * wire.element_size()
        spans = [(o, min(self.chunk_bytes, n - o)) for o in range(0, n, self.chunk_bytes)]
        pin = wire.device.type == "cuda"
        recvs = []
        if src is not None:
            got = torch.empty(n, dtype=torch.uint8, pin_memory=pin)
            recvs = [dist.irecv(got[o : o + k], src, tag=i) for i, (o, k) in enumerate(spans)]
        sends = []
        if dst is not None:
            flat = wire.reshape(-1).view(torch.uint8)
            host = torch.empty(n, dtype=torch.uint8, pin_memory=pin)
            for i, (o, k) in enumerate(spans):
                host[o : o + k].copy_(flat[o : o + k])
                sends.append(dist.isend(host[o : o + k], dst, tag=i))
        if src is not None:
            dest = out.reshape(-1).view(torch.uint8)
            for req, (o, k) in zip(recvs, spans):
                req.wait()
                dest[o : o + k].copy_(got[o : o + k], non_blocking=pin)
        for req in sends:
            req.wait()
        if pin and src is not None:
            torch.cuda.current_stream(out.device).synchronize()  # the host buffer is reused once freed

    def ppermute(self, x: torch.Tensor, pairs: Sequence[tuple[int, int]], axis: str) -> torch.Tensor:
        """``jax.lax.ppermute(x, axis, pairs)`` for this process: the
        coordinate ``dst`` along ``axis`` receives ``src``'s ``x`` for every
        ``(src, dst)`` pair; zeros where no pair arrives. Sources and
        destinations are each unique, as JAX requires."""
        me = self.mesh.coords[axis]
        srcs = [s for s, d in pairs if d == me]
        dsts = [d for s, d in pairs if s == me]
        if len(srcs) > 1 or len(dsts) > 1:
            raise ValueError(f"ppermute pairs {pairs}: sources and destinations must be unique")
        wire = _wire_dtype(x)
        out = torch.empty_like(wire)
        nbytes = wire.numel() * wire.element_size()
        dst = self.mesh.peer(axis, dsts[0]) if dsts and dsts[0] != me else None
        src = self.mesh.peer(axis, srcs[0]) if srcs and srcs[0] != me else None
        self.sent_bytes += nbytes * (dst is not None)
        self.recv_bytes += nbytes * (src is not None)
        if self.staged and (dst is not None or src is not None):
            self._staged_exchange(wire, out, dst, src)
        else:
            ops = []
            if dst is not None:
                ops.append(dist.P2POp(dist.isend, wire, dst))
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, out, src))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        if src is None:
            if srcs:  # a pair from this coordinate to itself
                out.copy_(wire)
            else:
                out.zero_()
        return out.view(x.dtype)

    def psum_u32(self, c: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The sum mod 2^32 of a uint32 tensor over the processes of
        ``axes`` (the reference's ``psum`` of the checksum partials)."""
        c64 = c.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        if not axes:
            return c
        parts = self.all_gather(c64, tuple(axes))
        return u32_from_i64(parts.sum(0) & 0xFFFFFFFF)

    def all_gather(self, x: torch.Tensor, axis: str | Sequence[str]) -> torch.Tensor:
        """``jax.lax.all_gather(x, axis)``: the tensors of the processes
        along ``axis`` (or over a tuple of axes, row-major in mesh order)
        stacked on a new leading dim, this process's included."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        group = self.mesh.group_of(axes)
        wire = _wire_dtype(x)
        n = dist.get_world_size(group)
        send = self._to_wire(wire)
        parts = [torch.empty_like(send) for _ in range(n)]
        dist.all_gather(parts, send, group=group)
        self.collective_bytes += wire.numel() * wire.element_size()
        out = torch.stack(parts).to(x.device)
        return out.view(x.dtype)
