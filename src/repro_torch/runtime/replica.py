"""Hot-replica teams, the resilience rung above the codec ladder (port of
``repro.runtime.replica``).

A *shadow team* (a second ``VirtualCluster`` with its own
``CheckpointEngine`` over the same entities) trails the primary by exactly
one committed checkpoint generation. On a primary failure the server
*promotes* the shadow instead of blocking on a codec rebuild: the promoted
engine already holds a committed generation on every member, so recovery is
the zero-communication survivor unpack, while the old team is rebuilt off
the critical path and re-enrolled as the new shadow.

Lazy sync: the primary's commit point *stages* a reference capture of the
just-swapped read-only generation (:func:`repro_torch.core.storage.capture_snapshot`,
the view the background tier flush rides), and the NEXT commit point
installs the previous capture into the shadow stores. The bytes copied are
the host payloads already resident in ``HostStore`` (own shards, exchange
subsets, parity stripes): no second encode, no device traffic. A deployed
team would move the same fused buckets with the device tier's mirror
program (``core.device_tier.build_mirror_program``); this host-side copy is
its single-process stand-in.

The ladder composes downward:

  replica promote        shadow fully synced: zero-comm unpack
  └─ codec rebuild       a shadow member died (e.g. during catch-up): its
                         shard is rebuilt from the copied redundancy
     └─ tier escalation  beyond codec tolerance: the promoted engine falls
                         down the storage ladder
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.core.checkpoint import CheckpointEngine
from repro_torch.core.hoststore import HostStore, StorePayload
from repro_torch.core.storage import TierSnapshot, capture_snapshot
from repro_torch.obs.trace import tracer
from repro_torch.runtime.cluster import VirtualCluster
from repro_torch.utils.logging import get_logger

log = get_logger("runtime.replica")

#: Promotion state machine: enrolled -> syncing -> ready -> promoted;
#: re_enroll() returns a promoted or stale team to "enrolled".
STATES = ("enrolled", "syncing", "ready", "promoted")


class ReplicaTeam:
    """A shadow cluster + engine mirroring a primary engine's generations.

    ``engine_factory(n_ranks)`` must return a :class:`CheckpointEngine` with
    the same entities registered as the primary's: promotion restores
    through those entities, exactly like a normal recovery.
    """

    def __init__(
        self,
        n_ranks: int,
        engine_factory: Callable[[int], CheckpointEngine],
        n_spares: int = 0,
        fault_hook: Callable[[int], None] | None = None,
    ) -> None:
        self.n_ranks = n_ranks
        self.n_spares = n_spares
        self._factory = engine_factory
        # fault_hook(rank) fires before each member's install during catch-up
        # (lets a test kill a shadow rank mid-sync)
        self._fault_hook = fault_hook or (lambda rank: None)
        self.state = "enrolled"
        self.synced_gen = -1          # primary commit counter last installed
        self.syncs = 0
        self.promotions = 0
        self.bytes_synced = 0
        self.blocked_sync_s = 0.0     # primary-visible lazy-sync stall
        self.rebuild_s = 0.0          # off-critical-path re-enroll cost
        self._staged: TierSnapshot | None = None
        self._build()

    def _build(self) -> None:
        self.cluster = VirtualCluster(self.n_ranks, self.n_spares)
        self.engine = self._factory(self.n_ranks)
        self.cluster.attach_engine(self.engine)

    # ------------------------------------------------------------------ #
    # lazy sync: stage at commit g, install at commit g+1
    # ------------------------------------------------------------------ #
    def stage(self, primary_engine: CheckpointEngine) -> None:
        """Capture the primary's just-committed generation by reference (no
        copies: the snapshot holds the read-only payload objects, so the
        next swap cannot overwrite them)."""
        self._staged = capture_snapshot(primary_engine)

    def catch_up(self) -> bool:
        """Install the previously staged generation into the shadow stores.
        True when a sync happened (False: nothing staged, or already at that
        generation). Dead shadow members are skipped; their shards come back
        through the codec at promotion."""
        snap = self._staged
        if snap is None or snap.created <= self.synced_gen or not snap.payloads:
            return False
        self.state = "syncing"
        t0 = time.perf_counter()
        total = 0
        with tracer().span("replica_sync", gen=snap.created):
            for r, src in sorted(snap.payloads.items()):
                self._fault_hook(r)
                st = self.engine.stores.get(r)
                if st is None or not st.alive:
                    continue
                total += self._install(st, src)
        self.synced_gen = snap.created
        self.syncs += 1
        dt = time.perf_counter() - t0
        self.blocked_sync_s += dt
        self.bytes_synced += total
        self.state = "ready"
        self.engine.journal.record(
            "replica_sync", gen=snap.created, bytes=total, duration_s=dt,
            members=len(snap.payloads), step=snap.step,
        )
        return True

    def _install(self, st: HostStore, src: StorePayload) -> int:
        """Copy one member's payload through the shadow store's arena leases
        (pinned when the engine is on the card; allocation-free at steady
        state), then commit it with the double-buffer swap."""
        new = StorePayload()
        nbytes = 0

        def copy_blob(key: Any, blob: torch.Tensor) -> torch.Tensor:
            nonlocal nbytes
            flat = blob.contiguous().reshape(-1).view(torch.uint8)
            dst = st.lease(key, flat.numel())
            dst.copy_(flat)
            nbytes += flat.numel()
            if blob.dtype != torch.uint8 or blob.dim() != 1:
                return dst.view(blob.dtype).reshape(blob.shape)
            return dst

        for name, (flat, man) in src.own.items():
            new.own[name] = (copy_blob(("r_own", name), flat), man)
        for name, (flat, man) in src.own_exch.items():
            new.own_exch[name] = (copy_blob(("r_exch", name), flat), man)
        for gi, stripes in src.parity.items():
            new.parity[gi] = {key: copy_blob(("r_parity", gi, key), blob) for key, blob in stripes.items()}
        # manifests, checksums and coordinates are immutable once committed:
        # sharing the references keeps the sync payload pure data bytes
        new.meta = dict(src.meta)
        st.buffer.write(new)
        st.buffer.swap()
        return nbytes

    # ------------------------------------------------------------------ #
    # promotion / re-enrollment
    # ------------------------------------------------------------------ #
    @property
    def can_promote(self) -> bool:
        return self.state == "ready" and self.engine.has_valid_checkpoint

    def release(self) -> tuple[VirtualCluster, CheckpointEngine]:
        """Hand the shadow's cluster + engine to the caller for promotion."""
        if not self.can_promote:
            raise RuntimeError("promotion without a synced generation")
        self.state = "promoted"
        self.promotions += 1
        self._staged = None
        return self.cluster, self.engine

    def re_enroll(self, old_engine: CheckpointEngine | None = None) -> None:
        """Rebuild the former primary team as the new shadow: a fresh cluster
        and engine from the factory (its hosts restarted), empty at
        generation -1; the next primary commit lazy-syncs it back to
        ready."""
        t0 = time.perf_counter()
        with tracer().span("replica_reenroll"):
            if old_engine is not None:
                old_engine.close()
            self._build()
        self.synced_gen = -1
        self._staged = None
        self.state = "enrolled"
        self.rebuild_s += time.perf_counter() - t0
        log.info("old team rebuilt and re-enrolled as shadow (%d ranks)", self.n_ranks)
