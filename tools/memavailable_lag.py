#!/usr/bin/env python3
"""How long freed host memory takes to reach ``MemAvailable``.

Allocates and touches ``--gib`` GiB of host memory with PyTorch, frees it,
and polls ``/proc/meminfo`` every half second until ``MemAvailable`` is back
within 1 GiB of its reading before the allocation (or ``--timeout`` runs
out), printing the process's resident set beside it. ``chip_smoke.py``
sizes its paths on ``MemAvailable``; where freed pages show up late, a
reading taken right after a path under-reports what the next one can use.

    python3 tools/memavailable_lag.py [--gib 20] [--timeout 60]
"""

from __future__ import annotations

import argparse
import time

import torch


def meminfo_gib(key: str, path: str = "/proc/meminfo") -> float:
    with open(path) as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) / 2**20
    raise KeyError(key)


def rss_gib() -> float:
    return meminfo_gib("VmRSS", "/proc/self/status")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gib", type=float, default=20.0)
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args()

    before = meminfo_gib("MemAvailable")
    print(f"MemAvailable {before:.2f} GiB, RSS {rss_gib():.2f} GiB before")
    buf = torch.ones(int(args.gib * 2**30), dtype=torch.uint8)
    print(f"MemAvailable {meminfo_gib('MemAvailable'):.2f} GiB, RSS {rss_gib():.2f} GiB "
          f"with {args.gib:g} GiB allocated")
    del buf
    t0 = time.perf_counter()
    while True:
        now, waited = meminfo_gib("MemAvailable"), time.perf_counter() - t0
        print(f"{waited:6.1f} s after the free: MemAvailable {now:.2f} GiB, RSS {rss_gib():.2f} GiB")
        if now >= before - 1.0 or waited > args.timeout:
            break
        time.sleep(0.5)
    print(f"back within 1 GiB after {waited:.1f} s" if now >= before - 1.0
          else f"not back after {waited:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
