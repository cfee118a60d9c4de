"""Per-rank host-DRAM snapshot store (diskless, double-buffered, arena-backed);
port of ``repro.core.hoststore``, with ``torch.uint8`` CPU arenas.

One ``HostStore`` models the main memory of one failure-domain rank (a TPU
host / data-axis coordinate). Its double buffer holds:

  * ``own``    — this rank's serialized snapshot shards, per entity
  * ``parity`` — redundancy stripes hosted for other groups, keyed
                 ``group -> (entity, blob, stripe)`` (copies, XOR parity,
                 RS blobs — whatever the active codec emits)
  * ``meta``   — step / checksums / manifests / provenance

Serialized payloads live in **arenas**: per-(bank, key) uint8 buffers leased
through :meth:`HostStore.lease` and reused across checkpoints, so the
steady-state hot path allocates nothing — ``pack_bytes`` writes each leaf
straight into the inactive bank and the codec encodes over arena views.
Two banks alternate with the double buffer's generation parity: the
read-only checkpoint (generation ``g``) owns bank ``g % 2`` and the next
write stages into the other bank, so an in-flight (or aborted and retried)
checkpoint can never scribble over the committed one — the bank flip is
what extends Algorithm 2's pointer-swap guarantee to buffer reuse.

Killing the rank wipes the store — in-memory checkpoints die with their host,
which is exactly the failure model the paper's redundancy exists to survive.

A store whose engine runs on the card leases **pinned** arenas: each is
allocated once per (bank, key) and page-locked in place
(``cudaHostRegister``, exactly its bytes), so the capture copies every leaf
from the card straight into it and a restore reads it back at the link's
rate. A failed registration raises; no arena silently stays pageable. On
the CPU the arenas are pageable.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.core.doublebuffer import DoubleBuffer


@dataclass
class StorePayload:
    own: dict[str, Any] = field(default_factory=dict)       # entity -> (flat, manifest)
    own_exch: dict[str, Any] = field(default_factory=dict)  # entity -> exchange subset (striped codecs)
    parity: dict[int, Any] = field(default_factory=dict)    # group -> (entity, blob, stripe) -> bytes
    meta: dict[str, Any] = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return sum(self.nbytes_by_kind().values())

    def nbytes_by_kind(self) -> dict[str, int]:
        """Byte split for the engine's itemized memory report: own snapshot
        payloads vs exchange subsets vs hosted redundancy stripes."""

        def acc(obj: Any) -> int:
            if isinstance(obj, torch.Tensor):
                return obj.nbytes
            if isinstance(obj, dict):
                return sum(acc(v) for v in obj.values())
            if isinstance(obj, (list, tuple)):
                return sum(acc(v) for v in obj)
            return 0

        return {"own": acc(self.own), "exchange": acc(self.own_exch), "redundancy": acc(self.parity)}


def pinned_empty(nbytes: int) -> torch.Tensor:
    """A uint8 host buffer of ``nbytes``, page-locked for the card. Registered
    in place rather than taken from PyTorch's pinned allocator, which rounds
    every block up to a power of two and keeps it cached; unregistered when
    the buffer is collected. Raises if the registration fails."""
    buf = torch.empty(nbytes, dtype=torch.uint8)
    if nbytes:
        cudart = torch.cuda.cudart()
        err = int(cudart.cudaHostRegister(buf.data_ptr(), nbytes, 0))
        if err != 0:
            raise RuntimeError(f"pinning a {nbytes}-byte host arena failed (cudaError {err})")
        weakref.finalize(buf, cudart.cudaHostUnregister, buf.data_ptr())
    return buf


class HostStore:
    def __init__(self, rank: int, pinned: bool = False) -> None:
        self.rank = rank
        #: lease page-locked arenas (the engine's device is a card)
        self.pinned = pinned
        self.buffer = DoubleBuffer(f"host{rank}")
        self.alive = True
        # Bumped on every wipe/revive: a rebuilt store may reuse both arena
        # addresses and the reset generation numbers, so the epoch is what
        # tells a stale cached entry apart (the classic ABA guard).
        self.epoch = 0
        # (bank, key) -> reusable uint8 arena; see module docstring.
        self._arenas: dict[tuple[int, Any], torch.Tensor] = {}
        # Serializes arena growth + payload-dict writes when the pipeline
        # drains on multiple workers (a holder store receives stripes from
        # units owned by different workers). Distinct arena KEYS never share
        # bytes, so only the bookkeeping needs the lock, never the memcpys.
        self.lock = threading.Lock()

    # ------------------------------------------------------------------ #
    # arena leasing (zero-copy staging)
    # ------------------------------------------------------------------ #
    @property
    def staging_bank(self) -> int:
        """Bank index for the NEXT checkpoint's payload. The committed
        checkpoint (generation g) owns bank ``g % 2``; staging uses the other
        one. An aborted attempt doesn't advance the generation, so a retry
        reuses the same (non-committed) bank."""
        return (self.buffer.generation + 1) % 2

    def lease(self, key: Any, nbytes: int) -> torch.Tensor:
        """A reusable uint8 arena view of exactly ``nbytes`` for the upcoming
        checkpoint. Grown (never shrunk) when the payload grows; steady-state
        checkpoints allocate nothing. Thread-safe: concurrent pipeline
        workers may lease distinct keys from the same store."""
        k = (self.staging_bank, key)
        with self.lock:
            buf = self._arenas.get(k)
            if buf is None or buf.numel() < nbytes:
                buf = pinned_empty(nbytes) if self.pinned else torch.empty(nbytes, dtype=torch.uint8)
                self._arenas[k] = buf
            return buf[:nbytes]

    def wipe(self) -> None:
        """Host failure: all in-memory snapshot data on this rank is gone."""
        self.buffer = DoubleBuffer(f"host{self.rank}")
        self._arenas = {}
        self.epoch += 1
        self.alive = False

    def revive(self, rank: int | None = None) -> None:
        """Spare substitution / elastic regrow: fresh store joins."""
        if rank is not None:
            self.rank = rank
        self.buffer = DoubleBuffer(f"host{self.rank}")
        self._arenas = {}
        self.epoch += 1
        self.alive = True

    @property
    def nbytes(self) -> int:
        """Bytes both banks' payloads hold."""
        return sum(p.nbytes for p in (self.buffer.read_only, self.buffer.writable) if p is not None)

    def nbytes_by_kind(self) -> dict[str, int]:
        out = {"own": 0, "exchange": 0, "redundancy": 0}
        for payload in (self.buffer.read_only, self.buffer.writable):
            if payload is not None:
                for k, v in payload.nbytes_by_kind().items():
                    out[k] += v
        return out
