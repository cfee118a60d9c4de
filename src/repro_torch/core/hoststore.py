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

The arenas are pageable host memory; pinned arenas wait for the async
create path (ROADMAP A5).
"""

from __future__ import annotations

import threading
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


class HostStore:
    def __init__(self, rank: int) -> None:
        self.rank = rank
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
                buf = torch.empty(nbytes, dtype=torch.uint8)
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
