#!/usr/bin/env python3
"""The host-side rates a storage-tier flush and load run at, on this machine:
the filesystem under a directory (its /proc/mounts entry) and its free
bytes, writing with fsync, reading back after ``posix_fadvise(DONTNEED)``
and again, BLAKE2b-128 (the chunk store's digest) on 1 and 4 threads, and
``np_checksum`` (the rank files' Fletcher sums), over 4 MiB chunks of
seeded bytes. Prints one JSON line.

    python3 tools/disk_rate.py [--dir build/disk_rate] [--gib 2]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import dir_probe  # noqa: E402
from repro_torch.core.integrity import np_checksum  # noqa: E402

CHUNK = 4 << 20


def rate(nbytes: int, fn) -> float:
    t0 = time.perf_counter()
    fn()
    return nbytes / (time.perf_counter() - t0) / 1e9


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=str(ROOT / "build" / "disk_rate"))
    ap.add_argument("--gib", type=float, default=2.0)
    args = ap.parse_args()
    d = Path(args.dir)
    d.mkdir(parents=True, exist_ok=True)
    n = int(args.gib * 2**30) // CHUNK * CHUNK
    buf = np.random.default_rng(0).integers(0, 256, n, dtype=np.uint8)
    chunks = [buf[lo : lo + CHUNK] for lo in range(0, n, CHUNK)]
    path = d / "rate.bin"
    out = dict(fs=dir_probe(d), gib=n / 2**30)

    def write():
        with open(path, "wb") as f:
            for c in chunks:
                f.write(memoryview(c))
            f.flush()
            os.fsync(f.fileno())

    def read():
        into = np.empty(CHUNK, np.uint8)
        with open(path, "rb") as f:
            while f.readinto(memoryview(into)):
                pass

    out["write_fsync_gbps"] = rate(n, write)
    fd = os.open(path, os.O_RDONLY)
    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    os.close(fd)
    out["read_after_dontneed_gbps"] = rate(n, read)
    out["read_again_gbps"] = rate(n, read)

    def digest(c):
        return hashlib.blake2b(memoryview(c), digest_size=16).hexdigest()

    out["blake2b_1_thread_gbps"] = rate(n, lambda: [digest(c) for c in chunks])
    with ThreadPoolExecutor(4) as pool:
        out["blake2b_4_threads_gbps"] = rate(n, lambda: list(pool.map(digest, chunks)))
        out["blake2b_and_np_checksum_4_threads_gbps"] = rate(
            n, lambda: list(pool.map(lambda c: (digest(c), np_checksum(c)), chunks)))
    out["np_checksum_1_thread_gbps"] = rate(n, lambda: [np_checksum(c) for c in chunks])
    out["cpus"] = os.cpu_count()
    shutil.rmtree(d, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
