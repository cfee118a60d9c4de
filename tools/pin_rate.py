#!/usr/bin/env python3
"""How fast host memory can be page-locked for the card, by way of making it:
the host engine's arenas are allocated once per (bank, key) and pinned in
place, and at llama3.2-1b's width a generation is 39.5 GB of them.

    python3 tools/pin_rate.py [--gib 4] [--reps 2]

For each way, ``--reps`` fresh buffers of ``--gib`` GiB are made and
pinned, then released; prints GB/s for the pinning (the release timed
apart) and the device-to-host copy rate into the buffer:

* ``register``: ``torch.empty`` then ``cudaHostRegister`` (the arenas' way);
* ``touch+register``: the pages faulted in first by a multi-threaded
  ``zero_()``, then registered;
* ``hugepage+register``: ``madvise(MADV_HUGEPAGE)`` on the range first (if
  the kernel allows transparent huge pages), then registered;
* ``pin_memory``: ``torch.empty(pin_memory=True)`` (PyTorch's pinned
  allocator, which rounds each block up to a power of two).

Needs a CUDA card; prints the card's name and power limit and the
kernel's transparent-huge-page setting.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import torch

MADV_HUGEPAGE = 14
PAGE = 4096


def _register(buf: torch.Tensor) -> None:
    err = int(torch.cuda.cudart().cudaHostRegister(buf.data_ptr(), buf.numel(), 0))
    if err != 0:
        raise RuntimeError(f"cudaHostRegister failed (cudaError {err})")


def _unregister(buf: torch.Tensor) -> None:
    torch.cuda.cudart().cudaHostUnregister(buf.data_ptr())


def _madvise_huge(buf: torch.Tensor) -> int:
    libc = ctypes.CDLL(None, use_errno=True)
    start = (buf.data_ptr() + PAGE - 1) // PAGE * PAGE
    length = (buf.data_ptr() + buf.numel() - start) // PAGE * PAGE
    return libc.madvise(ctypes.c_void_p(start), ctypes.c_size_t(length), MADV_HUGEPAGE)


def one(way: str, nbytes: int, src: torch.Tensor) -> dict:
    t0 = time.perf_counter()
    if way == "pin_memory":
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    else:
        buf = torch.empty(nbytes, dtype=torch.uint8)
        if way == "touch+register":
            buf.zero_()
        elif way == "hugepage+register":
            _madvise_huge(buf)
        _register(buf)
    pin_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf[: src.numel()].copy_(src)
    d2h_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if way != "pin_memory":
        _unregister(buf)
    del buf
    if way == "pin_memory":
        torch.cuda.empty_cache()
        fn = getattr(torch._C, "_host_emptyCache", None)
        if fn is not None:
            fn()
    release_s = time.perf_counter() - t0
    return dict(pin_gbps=nbytes / pin_s / 1e9, pin_s=pin_s, d2h_gbps=src.numel() / d2h_s / 1e9,
                release_s=release_s)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gib", type=float, default=4.0)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    try:
        thp = open("/sys/kernel/mm/transparent_hugepage/enabled").read().strip()
    except OSError:
        thp = "unknown"
    nbytes = int(args.gib * 2**30)
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda").fill_(1)
    print(f"{card}; transparent_hugepage: {thp}; torch threads {torch.get_num_threads()}")
    for way in ("register", "touch+register", "hugepage+register", "pin_memory"):
        runs = [one(way, nbytes, src) for _ in range(args.reps)]
        print(json.dumps({"way": way, "gib": args.gib, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
