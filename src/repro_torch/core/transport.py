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


# ---------------------------------------------------------------------------
# The staged backend: gloo's collectives on host copies of a card's tensors
# ---------------------------------------------------------------------------

STAGED_BACKEND = "repro_staged"


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host (pinned when it lies on a card); ``t`` itself when it
    is already there."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _copy_back(dst: torch.Tensor, host: torch.Tensor) -> None:
    if host is not dst:
        dst.copy_(host)


class _DoneWork(dist.Work):
    """A finished ``Work``: the collective ran to its end before returning."""

    def wait(self, timeout=None) -> bool:
        return True

    def is_completed(self) -> bool:
        return True

    def get_future(self):
        from torch.futures import Future

        fut = Future()
        fut.set_result(None)
        return fut


def _done_work() -> dist.Work:
    return _DoneWork()


class StagedGroup(dist.ProcessGroup):
    """A process group whose every collective runs on a gloo group of the
    same ranks over host memory: a tensor on a card is copied to pinned host
    memory, the collective runs there, and the result is copied back onto
    the card before the call returns. Host tensors go to gloo as they are.

    gloo's own CUDA collectives are not used: DTensor's all-gather of a
    card's tensors ended every process with a segmentation fault in gloo
    (``tools/gloo_dtensor_probe.py``). This is the transport's staging made a
    backend that DTensor's collectives reach; it is the backend a caller
    names (:data:`STAGED_BACKEND`), never one picked in its place. Each
    method is the ``ProcessGroup`` trampoline's name for a collective (both
    the current and the older name where they differ). ``traffic`` counts,
    per collective, the calls and the bytes of their inputs and outputs
    (:func:`staged_traffic` sums a mesh's groups)."""

    def __init__(self, store, rank: int, size: int, timeout, name: str) -> None:
        super().__init__(rank, size)
        from torch.distributed.distributed_c10d import ProcessGroupGloo

        self.inner = ProcessGroupGloo(store, rank, size, timeout)
        self.name = name
        self.traffic: dict[str, tuple[int, int]] = {}

    def getBackendName(self) -> str:  # noqa: N802 - the trampoline's name
        return STAGED_BACKEND

    @property
    def group_name(self) -> str:
        return self.name

    def _run(self, name: str, outs: list, ins: list, op, inplace: bool = False) -> Any:
        """Collective ``name``: stage ``ins`` and ``outs`` (flat lists of
        tensors; ``outs`` with their values when the collective works in
        place) to the host, run ``op(host_outs, host_ins)`` on gloo and wait,
        copy the outputs back."""
        h_in = [_host_copy(t) for t in ins]
        h_out = [_host_copy(t) if inplace or t.device.type == "cpu"
                 else torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs]
        calls, nbytes = self.traffic.get(name, (0, 0))
        self.traffic[name] = (calls + 1, nbytes + sum(t.numel() * t.element_size() for t in ins + outs))
        op(h_out, h_in).wait()
        for dst, host in zip(outs, h_out):
            _copy_back(dst, host)
        return _done_work()

    def _each(self, o: list, i: list, fn) -> Any:
        for a, b in zip(o, i):
            fn(a, b).wait()
        return _done_work()

    def allreduce(self, tensors, opts=None):
        return self._run("allreduce", tensors, [], lambda o, i: self.inner.allreduce(o, *_opts(opts)),
                         inplace=True)

    def allreduce_coalesced(self, tensors, opts=None):
        return self._run("allreduce_coalesced", tensors, [],
                         lambda o, i: self.inner.allreduce_coalesced(o, *_opts(opts)), inplace=True)

    def broadcast(self, tensors, opts=None):
        return self._run("broadcast", tensors, [], lambda o, i: self.inner.broadcast(o, *_opts(opts)),
                         inplace=True)

    def allgather(self, output_tensors, input_tensors, opts=None):
        n = len(output_tensors[0])
        flat_out = [t for ts in output_tensors for t in ts]
        return self._run("allgather", flat_out, input_tensors, lambda o, i: self.inner.allgather(
            [o[k * n:(k + 1) * n] for k in range(len(output_tensors))], i))

    def all_gather_single_coalesced(self, outputs, inputs, opts=None):
        return self._run("all_gather_single_coalesced", outputs, inputs,
                         lambda o, i: self._each(o, i, self.inner._allgather_base))

    allgather_into_tensor_coalesced = all_gather_single_coalesced

    def reduce_scatter(self, output_tensors, input_tensors, opts=None):
        n = len(input_tensors[0])
        flat_in = [t for ts in input_tensors for t in ts]
        return self._run("reduce_scatter", output_tensors, flat_in, lambda o, i: self.inner.reduce_scatter(
            o, [i[k * n:(k + 1) * n] for k in range(len(output_tensors))], *_opts(opts)))

    def reduce_scatter_single_coalesced(self, outputs, inputs, opts=None):
        return self._run("reduce_scatter_single_coalesced", outputs, inputs, lambda o, i: self._each(
            o, i, lambda a, b: self.inner._reduce_scatter_base(a, b, *_opts(opts))))

    reduce_scatter_tensor_coalesced = reduce_scatter_single_coalesced

    def all_to_all_single(self, output, input, output_split_sizes, input_split_sizes, opts=None):
        return self._run("all_to_all_single", [output], [input], lambda o, i: self.inner.alltoall_base(
            o[0], i[0], output_split_sizes, input_split_sizes))

    alltoall_base = all_to_all_single

    def barrier(self, opts=None):
        return self._run("barrier", [torch.zeros(1)], [], lambda o, i: self.inner.allreduce(o), inplace=True)

    def send(self, tensors, dst: int, tag: int):
        return self._run("send", [], tensors, lambda o, i: self.inner.send(i, dst, tag))

    def recv(self, tensors, src: int, tag: int):
        return self._run("recv", tensors, [], lambda o, i: self.inner.recv(o, src, tag))


def _opts(opts) -> tuple:
    """The options argument, where the caller gave one."""
    return () if opts is None else (opts,)


def _create_staged(opts, _backend_options) -> StagedGroup:
    """The backend's creator under ``register_backend``'s extended API,
    which hands it the group's name (``group_id``)."""
    return StagedGroup(opts.store, opts.group_rank, opts.group_size, opts.timeout, opts.group_id)


def register_staged_backend() -> str:
    """Register :class:`StagedGroup` as ``torch.distributed`` backend
    :data:`STAGED_BACKEND` for the card's tensors and the host's (once per
    process); returns its name."""
    if STAGED_BACKEND not in dist.Backend.backend_list:
        dist.Backend.register_backend(STAGED_BACKEND, _create_staged, extended_api=True, devices=["cpu", "cuda"])
    return STAGED_BACKEND


def staged_traffic(mesh: Any, reset: bool = False) -> dict[str, list[int]]:
    """[calls, bytes] per collective over every staged group of ``mesh`` (its
    DeviceMesh's groups and ``staged_group``); ``reset`` zeroes them after."""
    groups = [mesh.device_mesh.get_group(n) for n in mesh.axis_names] + [mesh.staged_group]
    out: dict[str, list[int]] = {}
    for g in groups:
        for name, (calls, nbytes) in getattr(g, "traffic", {}).items():
            c, b = out.get(name, [0, 0])
            out[name] = [c + calls, b + nbytes]
        if reset and hasattr(g, "traffic"):
            g.traffic.clear()
    return out
