"""The dry run's production meshes, and process meshes for the device tier.

The JAX package compiles its dry run on 512 virtual host devices. The port
has no compiler to feed, so its meshes are ``VirtualMesh``es on the meta
device: named axes with sizes, nothing allocated and no device touched,
here or when the module is imported.

A process mesh (``sharding/mesh.py::ProcessMesh``) runs one process per
mesh coordinate over a ``torch.distributed`` group. ``init_process_mesh``
joins the group and builds it:

* under ``torchrun --nproc-per-node N``, from the ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` it sets;
* or from an explicit rank, world size and ``file://`` rendezvous, as a
  :class:`RankGroup` (or :func:`spawn`) hands them to each process it
  starts (no port is opened beyond loopback).

Each process runs on ``cuda:{LOCAL_RANK % device_count}``, or on the CPU
when the caller asks. The backend is the caller's: ``"nccl"`` needs one card
per process and raises where two would share one (NCCL refuses two ranks on
one device); ``"gloo"`` stages tensors on a card through host memory.

The mesh also carries a DTensor ``DeviceMesh`` over the same processes, for
the sharded train step. Over ``"nccl"`` it runs on NCCL. Over ``"gloo"`` its
groups are on the staged backend (``core/transport.py::StagedGroup``: gloo
on host copies; gloo's own all-gather of a card's tensors ends the
processes), on the CPU as on the card, and so is ``mesh.staged_group``, a
group of every process for the state's gathers and scatters. Each spawned
process runs torch on one thread: the processes share the host's cores.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch

from dataclasses import replace

from repro_torch.sharding.mesh import ProcessMesh, VirtualMesh, make_process_mesh, resolve_device
from repro_torch.sharding.mesh import make_mesh as _make_mesh

BACKENDS = ("gloo", "nccl")


def make_production_mesh(*, multi_pod: bool = False) -> VirtualMesh:
    """16x16 = 256 chips per pod over (``data``, ``model``); multi-pod adds
    a leading 2-pod axis (512 chips)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, "meta")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> VirtualMesh:
    return _make_mesh(shape, axes, "meta")


def check_backend(backend: str, device: torch.device, local_world_size: int,
                  device_count: int | None = None) -> None:
    """Refuse a backend the processes cannot run: NCCL moves tensors on the
    card, one card per process (it refuses two ranks on one device)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the transport runs {BACKENDS}")
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError("nccl moves tensors on the card: a process on the CPU needs gloo")
    cards = torch.cuda.device_count() if device_count is None else device_count
    if local_world_size > cards:
        raise RuntimeError(
            f"nccl needs one card per process: {local_world_size} processes on this host share "
            f"{cards} card(s), and NCCL refuses two ranks on one device; use gloo, which stages "
            f"through host memory")


def rank_device(device: Any, local_rank: int) -> torch.device:
    """The device a process runs on: the CPU when asked, else
    ``cuda:{local_rank % device_count}`` (raising where CUDA is absent)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    dev = resolve_device(device)
    if torch.device(device if device is not None else "cuda").index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def init_process_mesh(
    shape: tuple[int, ...],
    names: tuple[str, ...],
    backend: str,
    *,
    rank: int | None = None,
    world_size: int | None = None,
    init_method: str | None = None,
    device: Any = None,
) -> ProcessMesh:
    """Join the process group and build this process's mesh. Without
    ``rank`` the group comes from torchrun's environment (``env://``);
    with it, from ``world_size`` and ``init_method`` (a ``file://`` path),
    every process on this host. Checks the backend against the devices
    before anything is joined."""
    import torch.distributed as dist

    if rank is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        init_method = "env://"
    elif world_size is None or init_method is None:
        raise ValueError("an explicit rank needs world_size and init_method")
    else:
        local_rank, local_world_size = rank, world_size
    dev = rank_device(device, local_rank)
    check_backend(backend, dev, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size, **kw)
    mesh = make_process_mesh(shape, names, dev)
    return replace(mesh, **_dtensor_groups(mesh, shape, names))


def _dtensor_groups(mesh: ProcessMesh, shape: tuple[int, ...], names: tuple[str, ...]) -> dict:
    """The ``DeviceMesh`` over the mesh's processes (collective), and under
    gloo the staged group of every process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if mesh.backend == "nccl":
        return {"device_mesh": init_device_mesh(mesh.device.type, tuple(shape), mesh_dim_names=tuple(names))}
    from repro_torch.core.transport import register_staged_backend

    staged = register_staged_backend()
    dm = init_device_mesh(mesh.device.type, tuple(shape), mesh_dim_names=tuple(names),
                          backend_override={n: staged for n in names})
    return {"device_mesh": dm, "staged_group": dist.new_group(backend=staged)}


# ---------------------------------------------------------------------------
# One process per coordinate, on one machine
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world_size, init_method, args, results, inbox) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)  # the processes share the host's cores
    try:
        extra = (inbox.get,) if inbox is not None else ()
        out = fn(rank, world_size, init_method, *args, *extra)
        results.put((rank, None, out))
    except BaseException:  # noqa: BLE001 - handed to the parent with its traceback
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankGroup:
    """``world_size`` fresh processes (start method ``spawn``), each running
    ``fn(rank, world_size, init_method, *args)`` from the moment the group is
    made, so their start-up overlaps whatever the caller does next.
    ``init_method`` is a ``file://`` rendezvous in a temporary directory,
    for :func:`init_process_mesh`. ``fn`` must be importable by name, and its
    results picklable without shared memory (numbers, strings, numpy
    arrays). With ``late=True`` each process also gets a last argument,
    ``receive()``, which waits for what :meth:`feed` sends it: only rank
    ``r`` receives ``rank_args[r]``, and tensors on a card cross by CUDA IPC,
    so the caller keeps them alive until :meth:`join` returns. Each process
    runs torch on one thread."""

    def __init__(self, fn: Callable, world_size: int, *, args: Sequence = (), late: bool = False) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self.results = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(world_size)] if late else [None] * world_size
        self.rdv = tempfile.mkdtemp(prefix="repro-rdv-")
        init_method = "file://" + os.path.join(self.rdv, "rendezvous")
        self.procs = []
        try:
            for r in range(world_size):
                p = ctx.Process(target=_rank_main, daemon=True,
                                args=(fn, r, world_size, init_method, tuple(args), self.results, self.inboxes[r]))
                p.start()
                self.procs.append(p)
        except BaseException:
            self.stop()
            raise

    def feed(self, rank_args: Sequence[Sequence]) -> None:
        """Send rank ``r`` its ``rank_args[r]`` (what its ``receive()`` returns)."""
        for inbox, a in zip(self.inboxes, rank_args):
            inbox.put(tuple(a))

    def join(self, timeout: float = 600.0) -> list[Any]:
        """Each rank's result, in rank order. Raises ``RuntimeError`` with
        the first failed rank's traceback; every process has ended when it
        returns or raises."""
        try:
            out: dict[int, Any] = {}
            errors: dict[int, str] = {}
            deadline = time.monotonic() + timeout
            while len(out) + len(errors) < self.world_size:
                try:
                    r, err, val = self.results.get(timeout=1.0)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"{self.world_size - len(out) - len(errors)} ranks gave no result "
                                           f"in {timeout} s") from None
                    dead = [p.pid for r2, p in enumerate(self.procs)
                            if r2 not in out and not p.is_alive() and p.exitcode != 0]
                    if dead and self.results.empty():
                        raise RuntimeError(f"processes {dead} ended without a result") from None
                    continue
                if err is not None:
                    errors[r] = err
                    break  # the other ranks may wait on the failed one forever
                out[r] = val
            if errors:
                r = min(errors)
                raise RuntimeError(f"rank {r} of {self.world_size} failed:\n{errors[r]}")
            for p in self.procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
            return [out[r] for r in range(self.world_size)]
        finally:
            self.stop()

    def stop(self) -> None:
        """End every process (killing those still running) and clean up."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        self.procs = []
        for q in (self.results, *[q for q in self.inboxes if q is not None]):
            q.close()
        shutil.rmtree(self.rdv, ignore_errors=True)


def spawn(fn: Callable, world_size: int, *, args: Sequence = (), timeout: float = 600.0) -> list[Any]:
    """Run ``fn(rank, world_size, init_method, *args)`` in a
    :class:`RankGroup` and return each rank's result, in rank order. Raises
    ``RuntimeError`` with the first failed rank's traceback; every process
    has ended when it returns or raises."""
    return RankGroup(fn, world_size, args=args).join(timeout)
