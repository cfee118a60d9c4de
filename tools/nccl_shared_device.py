#!/usr/bin/env python3
"""Ask NCCL for two ranks on one card and print its own refusal.

    python3 tools/nccl_shared_device.py     # on a machine with one card

Two processes (``launch.mesh.spawn``, a ``file://`` rendezvous) both pick
``cuda:0``, join an NCCL group without the port's own check
(``launch.mesh.check_backend``, which refuses this before NCCL is asked) and
all-reduce a vector. NCCL's warnings go to stderr (``NCCL_DEBUG=WARN``); the
error each rank raised is printed, then the port's check on the same
request. Exit 0 when NCCL refused, 1 when it did not.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def shared_card_rank(rank: int, world: int, init_method: str) -> list[float]:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=init_method, rank=rank, world_size=world, device_id=dev)
    x = torch.ones(4, device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return x.tolist()


def main() -> int:
    import torch

    from repro_torch.launch.mesh import check_backend, spawn

    os.environ.setdefault("NCCL_DEBUG", "WARN")
    print(f"torch {torch.__version__}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
          f"{torch.cuda.device_count()} card(s): {torch.cuda.get_device_name(0)}", flush=True)
    try:
        out = spawn(shared_card_rank, 2, timeout=120)
    except RuntimeError as exc:
        print("NCCL refused two ranks on one card; the first failed rank's error:", flush=True)
        lines = str(exc).strip().splitlines()
        start = max(i for i, line in enumerate(lines) if line.startswith("Traceback")) if any(
            line.startswith("Traceback") for line in lines) else 0
        print("\n".join(line for line in lines[start:] if not line.startswith("  ")), flush=True)
        refused = True
    else:
        print(f"NCCL ran two ranks on one card: {out}", flush=True)
        refused = False
    try:
        check_backend("nccl", torch.device("cuda", 0), local_world_size=2)
        print("the port's check let it through", flush=True)
    except RuntimeError as exc:
        print(f"the port's check: {exc}", flush=True)
    return 0 if refused else 1


if __name__ == "__main__":
    sys.exit(main())
