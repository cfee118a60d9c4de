#!/usr/bin/env python3
"""Ask gloo for DTensor's collectives on a card's tensors and print, for
each one, "ok" or gloo's own words.

    python3 tools/gloo_dtensor_probe.py [--device cpu] [--world 4]

``--world`` processes (``launch.mesh.spawn``, a ``file://`` rendezvous)
share the one card (or run on the CPU with ``--device cpu``), join one gloo
group through ``launch.mesh.init_process_mesh`` and build a (2, 2)
``DeviceMesh`` over it on the card's device type. Each process then runs,
on tensors on its device:

* the raw collectives DTensor calls (``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``,
  ``broadcast``) and the object and list collectives the trainer uses
  (``gather``, ``scatter``);
* DTensor redistributions (Shard -> Replicate on either axis, Partial ->
  Shard in f32 and bf16, Partial -> Replicate, Shard(0) -> Shard(1)) and an
  einsum of a Shard(0) x Shard(1) pair and its backward, held against the
  plain einsum on the same inputs: first on the mesh's own ``DeviceMesh``,
  whose groups are on the staged backend (``core/transport.py``; design
  (b)), with a send/recv on its staged group and the seconds of a 128 MiB
  bf16 reduce-scatter and all-gather; then on a ``DeviceMesh`` over the gloo
  group itself (design (a)).

Every case is tried on its own; an exception's first line is what gloo (or
DTensor) said. Each process runs the cases in the same order and writes
each case's name to a progress file before it starts it, with
``faulthandler`` on, so a case that ends the processes (a signal, an abort
in the backend) is named: the parent records the exit codes and what the
processes last started, and starts a fresh group at the next case. The last
line of stdout is one JSON object: the card, torch's version and each
case's result. Exit 0 when every case has a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SHAPE, NAMES = (2, 2), ("data", "model")
_DTENSOR = ("Shard->Replicate", "Partial->Shard", "Partial->Replicate", "Shard(0)->Shard(1)",
            "Shard(1)->Replicate on model", "Shard einsum + backward", "bf16 Partial->Shard")
CASES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce", "all_to_all_single", "broadcast",
         "gather", "scatter", *[f"staged: {n}" for n in _DTENSOR], "staged: send/recv",
         "staged: 128 MiB bf16 reduce-scatter + all-gather", "gloo: device_mesh", *[f"gloo: {n}" for n in _DTENSOR])


def _first_line(exc: BaseException) -> str:
    text = str(exc).strip().splitlines()
    return f"{type(exc).__name__}: {text[0] if text else ''}"


def probe_rank(rank: int, world: int, init_method: str, device: str, skip: list, progress: str) -> dict:
    import faulthandler

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import init_process_mesh

    faulthandler.enable()
    torch.set_num_threads(1)
    log = open(Path(progress) / f"rank{rank}", "a")
    mesh = init_process_mesh(SHAPE, NAMES, "gloo", rank=rank, world_size=world, init_method=init_method,
                             device=device)
    dev = mesh.device
    out: dict[str, str] = {}

    def case(name, fn):
        if name in skip:
            return
        log.write(name + "\n")
        log.flush()
        try:
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            out[name] = "ok"
        except Exception as exc:  # noqa: BLE001 - the backend's words are the result
            out[name] = _first_line(exc)

    x = torch.arange(8, dtype=torch.float32, device=dev) + rank

    def all_gather_into_tensor():
        got = torch.empty(8 * world, dtype=torch.float32, device=dev)
        dist.all_gather_into_tensor(got, x)
        assert torch.equal(got.cpu(), torch.cat([torch.arange(8.0) + r for r in range(world)]))

    def reduce_scatter_tensor():
        big = torch.arange(2 * world, dtype=torch.float32, device=dev)
        got = torch.empty(2, dtype=torch.float32, device=dev)
        dist.reduce_scatter_tensor(got, big)
        assert torch.equal(got.cpu(), world * torch.arange(2 * rank, 2 * rank + 2, dtype=torch.float32))

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        assert torch.equal(y.cpu(), world * torch.arange(8.0) + sum(range(world)))

    def all_to_all_single():
        y = torch.empty(world * 2, dtype=torch.float32, device=dev)
        dist.all_to_all_single(y, torch.arange(world * 2, dtype=torch.float32, device=dev) + 100 * rank)

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        assert torch.equal(y.cpu(), torch.arange(8.0))

    def gather():
        parts = [torch.empty_like(x) for _ in range(world)] if rank == 0 else None
        dist.gather(x, parts, dst=0)

    def scatter():
        y = torch.empty_like(x)
        dist.scatter(y, [x + r for r in range(world)] if rank == 0 else None, src=0)

    for name, fn in (("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor), ("all_reduce", all_reduce),
                     ("all_to_all_single", all_to_all_single), ("broadcast", broadcast), ("gather", gather),
                     ("scatter", scatter)):
        case(name, fn)

    c = mesh.coords
    g = torch.Generator().manual_seed(0)
    a_full = torch.randn(8, 6, generator=g)
    w_full = torch.randn(6, 4, generator=g)
    a_loc = a_full.chunk(2, 0)[c["data"]].to(dev)
    w_loc = w_full.chunk(2, 1)[c["model"]].to(dev)

    def dtensor_cases(tag: str, dm) -> None:
        def sharded(local, placements, shape):
            return DTensor.from_local(local, dm, placements, run_check=False, shape=shape,
                                      stride=torch.empty(shape).stride())

        def shard_to_replicate():
            y = sharded(a_loc, [Shard(0), Replicate()], a_full.shape).redistribute(dm, [Replicate(), Replicate()])
            assert torch.equal(y.to_local().cpu(), a_full)

        def partial_to_shard():
            p = DTensor.from_local(a_full.to(dev), dm, [Partial(), Replicate()], run_check=False)
            y = p.redistribute(dm, [Shard(0), Replicate()])
            assert torch.equal(y.to_local().cpu(), 2 * a_full.chunk(2, 0)[c["data"]])

        def partial_to_replicate():
            p = DTensor.from_local(a_full.to(dev), dm, [Partial(), Replicate()], run_check=False)
            assert torch.equal(p.redistribute(dm, [Replicate(), Replicate()]).to_local().cpu(), 2 * a_full)

        def shard0_to_shard1():
            y = sharded(a_loc, [Shard(0), Replicate()], a_full.shape).redistribute(dm, [Shard(1), Replicate()])
            assert torch.equal(y.to_local().cpu(), a_full.chunk(2, 1)[c["data"]])

        def shard1_to_replicate_model():
            y = sharded(w_loc, [Replicate(), Shard(1)], w_full.shape).redistribute(dm, [Replicate(), Replicate()])
            assert torch.equal(y.to_local().cpu(), w_full)

        def einsum_backward():
            a = sharded(a_loc, [Shard(0), Replicate()], a_full.shape).requires_grad_()
            w = sharded(w_loc, [Replicate(), Shard(1)], w_full.shape).requires_grad_()
            y = torch.einsum("bd,df->bf", a, w)
            (y * y).sum().backward()
            ap, wp = a_full.clone().requires_grad_(), w_full.clone().requires_grad_()
            yp = torch.einsum("bd,df->bf", ap, wp)
            (yp * yp).sum().backward()
            err = max(float((y.detach().full_tensor().cpu() - yp.detach()).abs().max()),
                      float((a.grad.full_tensor().cpu() - ap.grad).abs().max()),
                      float((w.grad.full_tensor().cpu() - wp.grad).abs().max()))
            assert err < 1e-4, err

        def bf16_partial_to_shard():
            p = DTensor.from_local(a_full.to(dev, torch.bfloat16), dm, [Partial(), Replicate()], run_check=False)
            y = p.redistribute(dm, [Shard(0), Replicate()])
            assert torch.equal(y.to_local().cpu(), 2 * a_full.to(torch.bfloat16).chunk(2, 0)[c["data"]])

        for name, fn in (("Shard->Replicate", shard_to_replicate), ("Partial->Shard", partial_to_shard),
                         ("Partial->Replicate", partial_to_replicate), ("Shard(0)->Shard(1)", shard0_to_shard1),
                         ("Shard(1)->Replicate on model", shard1_to_replicate_model),
                         ("Shard einsum + backward", einsum_backward),
                         ("bf16 Partial->Shard", bf16_partial_to_shard)):
            case(f"{tag}: {name}", fn)

    # design (b) first: the mesh's own DeviceMesh, on the staged backend
    groups = {type(mesh.device_mesh.get_group(n)).__name__ for n in NAMES}
    if groups != {"StagedGroup"}:
        raise RuntimeError(f"the mesh's DeviceMesh is on {groups}, not the staged backend")
    dtensor_cases("staged", mesh.device_mesh)

    def staged_send_recv():
        y = x.clone()
        if rank == 0:
            dist.send(y, 1, group=mesh.staged_group)
        elif rank == 1:
            dist.recv(y, 0, group=mesh.staged_group)
            assert torch.equal(y.cpu(), torch.arange(8.0))

    case("staged: send/recv", staged_send_recv)

    def staged_rate():
        n = 64 << 20  # bf16 elements: 128 MiB
        big = torch.ones(n, dtype=torch.bfloat16, device=dev)
        p = DTensor.from_local(big, mesh.device_mesh, [Partial(), Replicate()], run_check=False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        y = p.redistribute(mesh.device_mesh, [Shard(0), Replicate()])
        z = y.redistribute(mesh.device_mesh, [Replicate(), Replicate()])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rates.append(time.perf_counter() - t0)
        assert float(z.to_local()[0]) == 2.0

    rates: list = []
    case("staged: 128 MiB bf16 reduce-scatter + all-gather", staged_rate)
    if rates:
        out["staged: 128 MiB bf16 reduce-scatter + all-gather"] += f" ({rates[0]:.3f} s)"

    # design (a): a DeviceMesh over the gloo group itself
    dm = None

    def gloo_device_mesh():
        nonlocal dm
        dm = DeviceMesh(dev.type, torch.arange(world).reshape(SHAPE), mesh_dim_names=NAMES)

    case("gloo: device_mesh", gloo_device_mesh)
    if dm is not None:
        dtensor_cases("gloo", dm)
    return out


def _group_class():
    from repro_torch.launch.mesh import RankGroup

    class Group(RankGroup):
        """A rank group that keeps its processes' exit codes."""

        exitcodes: list = []

        def stop(self) -> None:
            for p in self.procs:
                p.join(timeout=5)
            self.exitcodes = [p.exitcode for p in self.procs] or self.exitcodes
            super().stop()

    return Group


def main() -> int:
    import argparse

    import torch

    global _Group
    _Group = _group_class()

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args()
    card = None
    if args.device != "cpu":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
        print(card, flush=True)
    results: dict[str, list[str]] = {}
    skip: list[str] = []
    for _ in range(len(CASES) + 1):
        with tempfile.TemporaryDirectory() as progress:
            group = _Group(probe_rank, args.world, args=(args.device, list(skip), progress))
            try:
                res = group.join(120)
            except RuntimeError as exc:
                started = []
                for r in range(args.world):
                    f = Path(progress) / f"rank{r}"
                    lines = f.read_text().splitlines() if f.exists() else []
                    started.append(lines[-1] if lines else "start-up")
                name = next((c for c in CASES if c not in skip and c in started), "start-up")
                results.pop(name, None)
                codes = ", ".join(f"rank {r}: {c}" for r, c in enumerate(group.exitcodes))
                results[name] = [f"processes ended (exit codes {codes}); {_first_line(exc)}"]
                skip.append(name)
                if name == "start-up":
                    break
                continue
        for name in res[0]:
            results[name] = sorted({r[name].split(" (")[0] if name.endswith("all-gather") else r[name]
                                    for r in res})
            if name.endswith("all-gather"):
                results[name].append("seconds by rank: " + ", ".join(r[name].split(" (")[-1].rstrip("s)")
                                                                     for r in res))
        break
    for name in CASES:
        print(f"{name}: " + " | ".join(results.get(name, ["not run"])), flush=True)
    print(json.dumps({"card": card, "torch": torch.__version__, "device": args.device, "results": results}))
    return 0 if all(c in results for c in CASES) else 1


if __name__ == "__main__":
    sys.exit(main())
