"""The distributed checkpoint engine over per-rank host stores (port of
``repro.core.checkpoint``, paper §5.2).

Algorithm 2 (``checkpoint``): capture every entity's shards into the
writable bank of each rank's host store → encode and distribute redundancy
through the codec → handshake (liveness + checksum validation) → pointer
swap of every double buffer. A fault anywhere before the swap leaves every
read-only buffer untouched.

Algorithm 4 (``restore``): survivors restore their own shards with zero
communication; a lost shard is adopted from a surviving partner copy.

What this slice runs, and what raises ``NotImplementedError`` naming its
ROADMAP item instead of quietly running another path:

* codecs: ``copy`` (pairwise, neighbor, ``n_copies``), with ``compress``
  (int8 partner copies through the B5a/B5b kernels on the engine's device).
  ``xor``/``rs``/``lrc`` on the host wait for A4.
* create: the blocking drain, capture → encode → transfer → verify, one
  (group, entity) unit after another, each unit encoded whole (the
  reference's ``encode_chunk_bytes=-1`` shape; the copy codec has no GF
  matrix to chunk). Background drains (``checkpoint_async(background=True)``,
  ``async_workers > 1``) wait for A5.
* restore: ``restore_mode="sync"`` (the serial per-origin decode), and
  ``restore_elastic``, the N-to-M repartition onto a new world size (on the
  card, every split leaf of every new rank is built by the row-gather
  kernel B6). The pipelined restore (the reference's default) waits for A5,
  storage tiers and ``delta`` for A7 (so for the cold N-to-M restart too),
  ``topology`` for A9.

Host stores hold ``torch.uint8`` CPU arenas; the handshake checksums them
on the host with ``np_checksum``, as the reference does. Restored payloads
are unpacked onto the engine's device (``cuda`` unless the caller passes
``device="cpu"``), where the entities write them back.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Protocol

import torch

from repro_torch.core import codec as codec_mod
from repro_torch.core import distribution as dist
from repro_torch.core.hoststore import HostStore, StorePayload
from repro_torch.core.integrity import np_checksum
from repro_torch.core.serialization import Manifest, pack_bytes, unpack_bytes
from repro_torch.core.snapshot import Snapshottable
from repro_torch.elastic.plan import ElasticReport, plan_repartition
from repro_torch.elastic.reshard import reshard_leaves, reshard_leaves_device
from repro_torch.obs.journal import EventJournal
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import tracer
from repro_torch.optim.grad_compress import compress_tree, decompress_tree
from repro_torch.sharding.mesh import resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.pytree import tree_flatten, tree_unflatten

log = get_logger("core.checkpoint")

_TR = tracer()  # process-global span tracer (no-op spans while disabled)

# Engines number themselves so multi-engine traces stay attributable.
_ENGINE_SEQ = itertools.count()


class DistributedEntity(Protocol):
    """An entity whose snapshot is sharded across failure-domain ranks."""

    def snapshot_shards(self, n_ranks: int) -> list[Any]: ...

    def restore_shards(self, shards: dict[int, Any]) -> None: ...


class _ReplicatedAdapter:
    """Wraps a plain Snapshottable: same payload stored on every rank (small
    entities — timers, counters, RNG seeds)."""

    def __init__(self, entity: Snapshottable) -> None:
        self.entity = entity

    def snapshot_shards(self, n_ranks: int) -> list[Any]:
        payload = self.entity.snapshot()
        return [payload for _ in range(n_ranks)]

    def restore_shards(self, shards: dict[int, Any]) -> None:
        # Any surviving replica works; pick the lowest rank deterministically.
        self.entity.restore(shards[min(shards)])


@dataclass(frozen=True)
class EngineConfig:
    """The reference's fields and defaults. Settings this slice does not run
    make ``CheckpointEngine`` raise (see the module docstring)."""

    scheme: str = "pairwise"       # pairwise | neighbor (distribution callbacks)
    n_copies: int = 1              # R remote copies (eq. 2: MEM = S(1+2R'), R' = 1+n_copies)
    parity_group: int = 0          # >0: erasure-coded group size (k for xor/rs)
    compress: bool = False         # int8-compress partner payloads (beyond-paper)
    validate: bool = True          # checksum handshake
    codec: str = ""                # "" infers: parity_group>0 -> "xor", else "copy"
    rs_parity: int = 2             # m parity blobs per group for codec="rs"
    lrc_locals: int = 2            # local groups for codec="lrc"
    topology: object = None        # failure-domain topology (ROADMAP A9)
    async_workers: int = 1         # background drain workers (ROADMAP A5 above 1)
    restore_mode: str = "pipelined"  # "sync" here; "pipelined" waits for A5
    restore_chunk_bytes: int = 0   # pipelined restore chunking (A5)
    encode_chunk_bytes: int = 0    # create-side chunking; the copy codec encodes whole
    delta: bool = False            # differential checkpointing (ROADMAP A7)
    delta_chunk_bytes: int = 1 << 20
    delta_crossover: float = 0.6
    gf_backend: str = ""           # host GF(2^8) backend (ROADMAP A4)
    tiers: tuple = ()              # persistent storage-tier ladder (ROADMAP A7)


def _unported(cfg: EngineConfig) -> str | None:
    """Why this slice cannot run ``cfg``, naming the ROADMAP item; None if
    it can."""
    if cfg.restore_mode != "sync":
        return (f"restore_mode={cfg.restore_mode!r}: only the serial 'sync' restore is "
                f"ported; the pipelined restore waits for ROADMAP A5")
    if cfg.async_workers > 1:
        return "async_workers > 1: sharded background drains wait for ROADMAP A5"
    if cfg.tiers:
        return "tiers: the storage-tier ladder waits for ROADMAP A7"
    if cfg.delta:
        return "delta: differential checkpointing waits for ROADMAP A7"
    if cfg.topology is not None:
        return "topology: failure-domain-aware placement waits for ROADMAP A9"
    if cfg.gf_backend:
        return "gf_backend: the host GF(2^8) backends wait for ROADMAP A4"
    return None


#: ``CheckpointStats`` attribute -> (metric kind, metric name, python type,
#: help): the reference's names for the counters this slice keeps.
_STATS_METRICS: dict[str, tuple[str, str, type, str]] = {
    "created": ("counter", "ckpt_created_total", int,
                "Checkpoints committed (pointer swaps)."),
    "aborted": ("counter", "ckpt_aborted_total", int,
                "Checkpoints aborted before the commit point."),
    "restored": ("counter", "restore_total", int, "Successful restores."),
    "last_create_s": ("gauge", "ckpt_last_create_seconds", float,
                      "Wall time of the last checkpoint, capture to commit."),
    "last_restore_s": ("gauge", "restore_last_seconds", float,
                       "Wall time of the last restore."),
    "last_bytes_exchanged": ("gauge", "ckpt_last_bytes_exchanged", int,
                             "Redundancy bytes the last checkpoint moved."),
    "last_bytes_per_rank": ("gauge", "ckpt_last_bytes_per_rank", int,
                            "Redundancy bytes per rank, last checkpoint."),
    "zero_comm_restores": ("counter", "restore_zero_comm_shards_total", int,
                           "Shards restored from local memory."),
    "adopted_restores": ("counter", "restore_adopted_shards_total", int,
                         "Shards adopted from partner copies."),
    "reconstructed_restores": ("counter", "restore_reconstructed_shards_total",
                               int, "Shards rebuilt from parity."),
    "last_capture_s": ("gauge", "ckpt_last_capture_seconds", float,
                       "Phase A: arena-staged snapshot capture."),
    "last_finalize_wait_s": ("gauge", "ckpt_last_finalize_wait_seconds", float,
                             "Time finalize_async blocked on phase B."),
    "last_blocked_s": ("gauge", "ckpt_last_blocked_seconds", float,
                       "Capture + finalize wait = blocked critical path."),
    "last_bytes_staged": ("gauge", "ckpt_last_bytes_staged", int,
                          "Own + exchange bytes staged (host copies)."),
    "last_pipeline_chunks": ("gauge", "ckpt_last_pipeline_chunks", int,
                             "(group, entity) units the last drain ran."),
}


class CheckpointStats:
    """Flat engine statistics as a *view* over a :class:`MetricsRegistry`:
    every attribute maps to a typed counter/gauge cell (``_STATS_METRICS``),
    so ``stats.created += 1`` and ``registry.counter("ckpt_created_total")``
    are the same number by construction."""

    __slots__ = ("registry", "_cells")

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        reg = registry if registry is not None else MetricsRegistry()
        cells: dict[str, tuple[Any, type]] = {}
        for attr, (kind, name, typ, help_) in _STATS_METRICS.items():
            cells[attr] = (getattr(reg, kind)(name, help_), typ)
        object.__setattr__(self, "registry", reg)
        object.__setattr__(self, "_cells", cells)

    def __getattr__(self, attr: str) -> Any:
        try:
            metric, typ = object.__getattribute__(self, "_cells")[attr]
        except KeyError:
            raise AttributeError(attr) from None
        return typ(metric.value())

    def __setattr__(self, attr: str, value: Any) -> None:
        try:
            metric, _ = self._cells[attr]
        except KeyError:
            raise AttributeError(f"CheckpointStats has no field {attr!r}") from None
        metric.set(value)

    def __repr__(self) -> str:
        body = ", ".join(f"{a}={getattr(self, a)!r}" for a in _STATS_METRICS)
        return f"CheckpointStats({body})"

    def as_dict(self) -> dict[str, Any]:
        return {a: getattr(self, a) for a in _STATS_METRICS}


class FaultDuringCheckpoint(RuntimeError):
    """Raised into the engine by the failure injector mid-checkpoint."""


@dataclass
class _PendingCheckpoint:
    """An un-committed snapshot between the capture and the swap."""

    packed: dict[str, list[tuple[Any, Manifest]]]   # exchange/partner buffers
    manifests: dict[tuple[int, str], Any]
    alive0: set[int]
    t0: float
    bytes_exchanged: int = 0
    verified: set = field(default_factory=set)      # (rank, entity) unit-verified
    # Replicated with every store's meta (shared reference, like the
    # manifests) and filled by the drain's encode stage: capture-time
    # exchange checksums, keys (rank, entity).
    exch_sums: dict = field(default_factory=dict)
    gen: int = 0                # generation this snapshot becomes on commit


class CheckpointEngine:
    """Algorithm 2 create and Algorithm 4 restore over ``n_ranks`` host
    stores (one per failure domain), for the entities registered with
    :meth:`register`."""

    def __init__(
        self,
        n_ranks: int,
        cfg: EngineConfig = EngineConfig(),
        alive_fn: Callable[[], set[int]] | None = None,
        fault_hook: Callable[[str], None] | None = None,
        device: Any = None,
    ) -> None:
        why = _unported(cfg)
        if why is not None:
            raise NotImplementedError(why)
        self.n_ranks = n_ranks
        self.cfg = cfg
        #: where restored payloads are unpacked and compression runs
        self.device = resolve_device(device)
        self.stores: dict[int, HostStore] = {r: HostStore(r) for r in range(n_ranks)}
        self._entities: dict[str, DistributedEntity] = {}
        # Entities whose payload is identical on every rank need no partner
        # exchange (paper §5.2.1) — any survivor restores them.
        self._replicated: set[str] = set()
        self._alive_fn = alive_fn or (lambda: {r for r, s in self.stores.items() if s.alive})
        # fault_hook(phase) lets a failure injector strike at precise points
        # inside the checkpoint procedure (tests for Algorithm 2's guarantee).
        self._fault_hook = fault_hook or (lambda phase: None)
        self._pending: _PendingCheckpoint | None = None
        self._obs_id = next(_ENGINE_SEQ)
        self.stats = CheckpointStats()
        self.registry = self.stats.registry
        self.journal = EventJournal(None, self.registry)
        self.last_elastic_report: ElasticReport | None = None  # of the last N-to-M restore
        self.codec = codec_mod.make_codec(cfg)
        if self.codec.striped:
            raise NotImplementedError(
                f"codec {self.codec.name!r}: striped codecs on the host wait for ROADMAP A4")

    def _codec_spec(self, c: codec_mod.RedundancyCodec) -> str:
        """Compact codec descriptor recorded per entity in every payload."""
        m = getattr(c, "m", getattr(c, "global_parity", 0))
        l = getattr(c, "local", 0)
        return f"{c.name}:{m}:{l}"

    # ------------------------------------------------------------------ #
    # registration
    # ------------------------------------------------------------------ #
    def register(self, name: str, entity: Snapshottable | DistributedEntity) -> None:
        if name in self._entities:
            raise KeyError(f"entity {name!r} already registered")
        if hasattr(entity, "snapshot_shards"):
            self._entities[name] = entity  # type: ignore[assignment]
        else:
            self._entities[name] = _ReplicatedAdapter(entity)  # type: ignore[arg-type]
            self._replicated.add(name)

    # ------------------------------------------------------------------ #
    # Algorithm 2: resilient checkpoint creation
    # ------------------------------------------------------------------ #
    def checkpoint(self, meta: dict[str, Any] | None = None) -> bool:
        """Create + distribute + handshake + swap. Returns True on success;
        False if a fault struck before the swap (read-only buffers intact).
        Fully synchronous and deterministic (no background worker)."""
        if self.checkpoint_async(meta, background=False):
            return self.finalize_async() is True
        return False

    def checkpoint_async(self, meta: dict[str, Any] | None = None, background: bool = False) -> bool:
        """Capture a consistent snapshot of every entity straight into the
        writable-bank arenas; the encode + transfer + verify drain runs in
        ``finalize_async``. Background drains wait for ROADMAP A5."""
        if background:
            raise NotImplementedError("background drains wait for ROADMAP A5")
        if self._pending is not None:
            # Two captures without a finalize: the first snapshot was never
            # committed — drop it before its arenas are re-leased.
            self.discard_pending()
        gen = self.stats.created + 1  # generation this capture becomes on commit
        t0 = time.perf_counter()
        alive0 = self._alive_fn()
        try:
            with _TR.span("capture", eng=self._obs_id, gen=gen):
                self._fault_hook("before_create")
                packed_partner, manifests, exch_sums = self._capture(alive0, meta)
                self._fault_hook("after_create")
        except FaultDuringCheckpoint as e:
            log.warning("checkpoint aborted during create: %s", e)
            for s in self.stores.values():
                s.buffer.discard_writable()
            self.stats.aborted += 1
            self.journal.record("abort", phase="capture", gen=gen, cause=str(e))
            return False

        self.stats.last_capture_s = time.perf_counter() - t0
        self._pending = _PendingCheckpoint(packed_partner, manifests, alive0, t0, exch_sums=exch_sums, gen=gen)
        return True

    def _capture(
        self, alive0: set[int], meta: dict[str, Any] | None
    ) -> tuple[dict[str, list[tuple[Any, Manifest]]], dict[tuple[int, str], Any], dict]:
        """Serialize every entity's per-rank shards directly into host-store
        arenas (one copy per leaf, zero steady-state allocation) and stage
        the writable payloads. Returns the exchange buffers the drain
        encodes, the replicated manifest table and the (empty, shared)
        exchange-checksum table the drain fills."""
        packed: dict[str, list[tuple[Any, Manifest]]] = {}
        packed_partner: dict[str, list[tuple[Any, Manifest]]] = {}
        coords_tables: dict[str, Any] = {}
        bytes_staged = 0

        def _lease_for(r: int, key: tuple):
            """HostStore.lease bound for pack_bytes's callback form; None for
            ranks with no live store — those pack into fresh buffers."""
            store = self.stores.get(r)
            if r not in alive0 or store is None or not store.alive:
                return None
            return lambda nbytes: store.lease(key, nbytes)

        for name, ent in self._entities.items():
            shards = ent.snapshot_shards(self.n_ranks)
            rows: list[tuple[Any, Manifest]] = []
            for r, shard in enumerate(shards):
                rows.append(pack_bytes(shard, lease=_lease_for(r, ("own", name))))
                bytes_staged += rows[-1][0].nbytes
            packed[name] = rows
            if hasattr(ent, "shard_coords"):
                # Global-coordinate manifest: each shard records its slice of
                # the logical entity (replicated with every store's meta).
                table = ent.shard_coords(self.n_ranks)
                for r, (_, man) in enumerate(packed[name]):
                    man.coords = table[r]
                coords_tables[name] = table
            if hasattr(ent, "partner_payload"):
                # Exchange only the uniquely-owned subset (replicated leaves
                # exist on every rank already — paper §5.2.1).
                sub_rows: list[tuple[Any, Manifest]] = []
                for r, shard in enumerate(shards):
                    subset = ent.partner_payload(shard, self.n_ranks)
                    sub_rows.append(pack_bytes(subset, lease=_lease_for(r, ("exch", name))))
                    bytes_staged += sub_rows[-1][0].nbytes
                packed_partner[name] = sub_rows
            else:
                packed_partner[name] = packed[name]

        # Manifests are tiny: replicate all of them with every store's meta so
        # any survivor can unpack any origin's copy. (Compression in the
        # encode stage swaps in the tagged compressed manifest per origin —
        # the dict is shared, mutated only before the commit point.)
        manifests = {
            (r, name): rows[r][1]
            for name, rows in packed_partner.items()
            for r in range(self.n_ranks)
        }
        # Checksums of every origin's EXCHANGE payload, replicated like the
        # manifests: attached empty here, filled by the drain's encode stage
        # (complete before the commit, which always follows the drain).
        exch_sums: dict[tuple[int, str], Any] = {}
        codec_specs = {name: self._codec_spec(self.codec) for name in packed}
        for r in alive0:
            payload = StorePayload(meta=dict(meta or {}))
            if coords_tables:
                payload.meta["coords"] = dict(coords_tables)
            payload.meta["manifests"] = manifests
            payload.meta["codecs"] = codec_specs
            for name, rows in packed.items():
                flat, man = rows[r]
                payload.own[name] = (flat, man)
                if self.cfg.validate:
                    payload.meta.setdefault("checksums", {})[name] = np_checksum(flat.numpy())
            if self.cfg.validate:
                payload.meta["exch_checksums"] = exch_sums
            self.stores[r].buffer.write(payload)
        self.stats.last_bytes_staged = bytes_staged
        return packed_partner, manifests, exch_sums

    # ------------------------------------------------------------------ #
    # the drain: encode / transfer / verify per (group, entity) unit
    # ------------------------------------------------------------------ #
    def _pipeline_units(self, packed) -> list[tuple]:
        """One work unit per (group, entity)."""
        groups = self._groups()
        units = []
        for gi, grp in enumerate(groups):
            for name in packed:
                if name in self._replicated:
                    continue  # equal on all ranks: no redundancy needed
                placements = self.codec.placement(groups, gi, self.n_ranks)
                if not placements:
                    continue
                units.append((gi, grp, placements, name))
        return units

    def _drain(self, pending: _PendingCheckpoint) -> tuple[int, set]:
        """Unit *i* ENCODEs, then unit *i−1*'s copies TRANSFER to their
        holder stores, then unit *i−2* VERIFYs its members' staged checksums
        (the reference's software-pipeline order, on one thread). Nothing
        here touches a read-only buffer; a fault raises
        ``FaultDuringCheckpoint`` and the whole snapshot aborts."""
        units = self._pipeline_units(pending.packed)
        n = len(units)
        total = 0
        verified: set = set()
        encoded: dict[int, list[torch.Tensor]] = {}
        eng, gen = self._obs_id, pending.gen
        for i in range(n + 2):
            if i < n:
                u = units[i]
                with _TR.span("encode", eng=eng, gen=gen, group=u[0], entity=u[3]):
                    encoded[i] = self._encode_unit(u, pending)
            if 0 <= i - 1 < n:
                u = units[i - 1]
                with _TR.span("transfer", eng=eng, gen=gen, group=u[0], entity=u[3]):
                    total += self._transfer_unit(u, encoded.pop(i - 1))
            if 0 <= i - 2 < n:
                u = units[i - 2]
                with _TR.span("verify", eng=eng, gen=gen, group=u[0], entity=u[3]):
                    self._verify_unit(u, verified)
            self._fault_hook("pipeline_chunk")
        self.stats.last_pipeline_chunks = n
        return total, verified

    def _encode_unit(self, unit, pending: _PendingCheckpoint) -> list[torch.Tensor]:
        """ENCODE stage: one group's exchange buffers of one entity into
        redundancy blobs (under ``compress``, each member's buffer is first
        int8-compressed on the engine's device and its manifest replaced by
        the tagged compressed one). Also records each uncompressed member's
        exchange checksum into the replicated ``exch_sums`` table."""
        gi, grp, placements, name = unit
        bufs = []
        for m in grp.members:
            flat, man = pending.packed[name][m]
            if self.cfg.compress and self.codec.compressible:
                flat, man = self._compress(flat, man)
                pending.manifests[(m, name)] = man
            elif self.cfg.validate:
                # Compressed blobs skip restore-verify (their manifest is
                # tagged); everything else gets a capture-state reference.
                pending.exch_sums[(m, name)] = np_checksum(flat.numpy())
            bufs.append(flat)
        return self.codec.encode(bufs, len(placements))

    def _transfer_unit(self, unit, blobs: list[torch.Tensor]) -> int:
        """TRANSFER stage: whole copies are stored by reference on every
        holder store (no copy; the referenced flat is the origin's arena view
        from the same staging bank, so it commits and retires with the rest
        of the snapshot)."""
        gi, grp, placements, name = unit
        total = 0
        for b, (blob, holders) in enumerate(zip(blobs, placements)):
            blob = blob.reshape(-1)
            for j, member in enumerate(holders):
                st = self.stores[member]
                # Capture the payload reference once: a kill wipes the store
                # (swaps its buffer out); the handshake then aborts.
                payload = st.buffer.writable if st.alive else None
                if payload is None:
                    continue
                with st.lock:
                    payload.parity.setdefault(gi, {})[(name, b, j)] = blob
                total += blob.nbytes
        return total

    def _verify_unit(self, unit, verified: set) -> None:
        """VERIFY stage: recompute each member's staged own checksum for this
        entity (detects corruption during staging unit by unit, instead of
        one monolithic validation pass after all transfers)."""
        gi, grp, placements, name = unit
        if not self.cfg.validate:
            return
        for m in grp.members:
            st = self.stores.get(m)
            payload = st.buffer.writable if st is not None and st.alive else None
            if payload is None:
                continue  # dead rank: the handshake aborts the snapshot
            sums = payload.meta.get("checksums", {})
            if name in sums and name in payload.own:
                if np_checksum(payload.own[name][0].numpy()) != sums[name]:
                    raise FaultDuringCheckpoint(f"checksum mismatch rank {m} entity {name}")
                verified.add((m, name))

    def finalize_async(self) -> bool | None:
        """Drain, handshake, and **commit via the pointer swap** — the single
        commit point. Returns True on success, False on abort, None if
        nothing is pending."""
        if self._pending is None:
            return None
        pending = self._pending
        self._pending = None
        eng, gen = self._obs_id, pending.gen
        t_wait0 = time.perf_counter()
        try:
            with _TR.span("finalize_wait", eng=eng, gen=gen):
                pending.bytes_exchanged, pending.verified = self._drain(pending)
            self.stats.last_finalize_wait_s = time.perf_counter() - t_wait0

            self._fault_hook("after_distribute")

            with _TR.span("handshake", eng=eng, gen=gen):
                alive1 = self._alive_fn()
                if alive1 != pending.alive0 or len(alive1) < self.n_ranks:
                    raise FaultDuringCheckpoint(
                        f"rank set changed during checkpoint: "
                        f"{sorted(pending.alive0 - alive1)} died"
                    )
                if self.cfg.validate:
                    self._validate(alive1, skip=pending.verified)
        except FaultDuringCheckpoint as e:
            # Read-only buffers were never touched; discard in-flight writes.
            log.warning("checkpoint aborted: %s", e)
            for s in self.stores.values():
                s.buffer.discard_writable()
            self.stats.aborted += 1
            self.journal.record("abort", phase="finalize", gen=gen, cause=str(e))
            return False

        # -- swap: pointer swap, no communication — cannot be interrupted ----
        with _TR.span("commit", eng=eng, gen=gen):
            for r in pending.alive0:
                self.stores[r].buffer.swap()
        self.stats.created += 1
        self.stats.last_create_s = time.perf_counter() - pending.t0
        self.stats.last_blocked_s = self.stats.last_capture_s + self.stats.last_finalize_wait_s
        self.stats.last_bytes_exchanged = pending.bytes_exchanged
        self.stats.last_bytes_per_rank = pending.bytes_exchanged // max(len(pending.alive0), 1)
        return True

    def discard_pending(self) -> None:
        """Drop an un-finalized snapshot (e.g. before a restore): it counts as
        an aborted checkpoint (captured but never committed)."""
        if self._pending is not None:
            self._pending = None
            for s in self.stores.values():
                s.buffer.discard_writable()
            self.stats.aborted += 1

    def _groups(self) -> list[dist.ParityGroup]:
        """The contiguous rank-order group layout."""
        return dist.parity_groups(self.n_ranks, self.codec.group_size(self.n_ranks))

    def _group_of(self, rank: int) -> int:
        return dist.group_of(rank, self.codec.group_size(self.n_ranks))

    def _compress(self, flat: torch.Tensor, man: Manifest) -> tuple[torch.Tensor, tuple]:
        """Compress per-leaf floats through the manifest (int8 blockwise, on
        the engine's device); raw bytes are not quantizable, the tree's float
        leaves are. The packed result is a fresh host buffer."""
        tree = unpack_bytes(flat, man, device=self.device)
        cflat, cman = pack_bytes(compress_tree(tree, device=self.device))
        return cflat, ("compressed", cman)

    def _decompress(self, flat: torch.Tensor, man: tuple) -> Any:
        _, cman = man
        return decompress_tree(unpack_bytes(flat, cman, device=self.device))

    def _validate(self, alive: set[int], skip: set | None = None) -> None:
        """Handshake-time checksum validation over whatever the drain's VERIFY
        stage did not already cover (replicated entities, and every entity
        when the codec places no redundancy)."""
        skip = skip or set()
        for r in alive:
            payload = self.stores[r].buffer.writable
            sums = payload.meta.get("checksums", {})
            for name, (flat, _) in payload.own.items():
                if (r, name) in skip:
                    continue
                if name in sums and np_checksum(flat.numpy()) != sums[name]:
                    raise FaultDuringCheckpoint(f"checksum mismatch rank {r} entity {name}")

    # ------------------------------------------------------------------ #
    # Algorithm 4 + restore
    # ------------------------------------------------------------------ #
    @property
    def has_valid_checkpoint(self) -> bool:
        alive = self._alive_fn()
        return any(self.stores[r].buffer.valid for r in alive)

    def checkpoint_step(self) -> Any:
        """Meta recorded with the last valid checkpoint (e.g. the step)."""
        for r in sorted(self.stores):
            store = self.stores[r]
            if store.alive and store.buffer.valid:
                return store.buffer.read_only.meta
        raise RuntimeError("no valid checkpoint")

    def restore(self) -> dict[str, Any]:
        """Recover every entity from the last valid checkpoint. Returns the
        checkpoint meta. Survivor shards restore with zero communication.
        Entities are only mutated after EVERY shard has been recovered, so a
        failure anywhere in recovery leaves both the entities and the
        committed checkpoint untouched."""
        self.discard_pending()
        t0 = time.perf_counter()
        alive = self._alive_fn()
        failed = set(range(self.n_ranks)) - alive
        with _TR.span("restore", eng=self._obs_id, failed=len(failed), mode=self.cfg.restore_mode):
            recovered = {
                name: self._recover_entity_shards(name, ent, alive, failed)
                for name, ent in self._entities.items()
            }
            for name, ent in self._entities.items():
                ent.restore_shards(recovered[name])
        meta = self.checkpoint_step()
        self.stats.restored += 1
        self.stats.last_restore_s = time.perf_counter() - t0
        # The reference's record, field for field. In the sync restore its
        # rebuilt-bytes gauge stays 0 (only the pipelined restore, A5, sets
        # it); tier escalations (A7) and failure-domain labels (A9) are
        # not ported.
        self.journal.record(
            "recovery", mode=self.cfg.restore_mode, failed=len(failed),
            n_ranks=self.n_ranks, duration_s=self.stats.last_restore_s,
            bytes_rebuilt=0, escalations=0,
            step=meta.get("step") if isinstance(meta, dict) else None,
            domains="",
        )
        return meta

    def restore_elastic(self, new_n_ranks: int) -> dict[str, Any]:
        """Recover the last valid checkpoint (created on this engine's N
        ranks, possibly with failures) and restore it onto ``new_n_ranks``
        ranks — shrink after a failure without spares, or grow on scale-up.

        Entities exposing a global-coordinate manifest (``shard_coords``) are
        repartitioned with minimal data movement via elastic/plan.py; others
        restore through their old-world shard map unchanged. On the card
        every leaf with a data axis is built by the row gather (B6) from the
        recovered payloads, which the recovery unpacked there; on the CPU by
        host slicing. The engine's stores are rebuilt for the new world
        (empty until the next checkpoint re-protects it). Returns the
        checkpoint meta; movement accounting lands in
        ``self.last_elastic_report``.

        With nothing in memory the reference rehydrates the stores from its
        storage tiers first (the cold N-to-M restart); the port has no tiers
        yet (ROADMAP A7), so ``checkpoint_step()``'s "no valid checkpoint" is
        what the caller sees.
        """
        if new_n_ranks < 1:
            raise ValueError(f"new_n_ranks must be >= 1, got {new_n_ranks}")
        self.discard_pending()
        t0 = time.perf_counter()
        alive = self._alive_fn()
        failed = set(range(self.n_ranks)) - alive
        meta = self.checkpoint_step()  # read before the stores are rebuilt

        # Physical residency of every origin's recovered payload in the NEW
        # world: survivors keep their own shard on-host under the dense
        # renumbering; adopted shards materialize on the adopting host. Hosts
        # renumbered past M leave the job (their data counts as movement if
        # the plan still needs it).
        reassign = dist.shrink_reassignment(self.n_ranks, failed)
        residency: dict[int, int | None] = {}
        for origin in range(self.n_ranks):
            holder = self._recovery_host(origin, alive)
            dense = reassign.get(holder) if holder is not None else None
            residency[origin] = dense if dense is not None and dense < new_n_ranks else None

        report = ElasticReport(n_old=self.n_ranks, n_new=new_n_ranks)
        with _TR.span("restore", eng=self._obs_id, failed=len(failed),
                      mode=self.cfg.restore_mode, elastic=new_n_ranks):
            recovered = {
                name: self._recover_entity_shards(name, ent, alive, failed)
                for name, ent in self._entities.items()
            }
        with _TR.span("reshard", eng=self._obs_id, elastic=new_n_ranks):
            for name, ent in self._entities.items():
                plan = self._reshard_entity(name, ent, recovered.pop(name), residency, new_n_ranks)
                if plan is not None:
                    report.add(name, plan)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the restore ends when the new shards are written

        # Rebuild the engine for the new world. The consumed checkpoint dies
        # with the old rank space; callers re-protect by checkpointing
        # immediately.
        self.n_ranks = new_n_ranks
        self.stores = {r: HostStore(r) for r in range(new_n_ranks)}
        self.last_elastic_report = report
        self.stats.restored += 1
        self.stats.last_restore_s = time.perf_counter() - t0
        self.journal.record(
            "resize", n_old=report.n_old, n_new=report.n_new,
            failed=len(failed), bytes_moved=report.bytes_moved,
            bytes_total=report.bytes_total,
            duration_s=self.stats.last_restore_s,
        )
        log.info(
            "elastic restore %d->%d ranks: %.1f MiB held, %.1f MiB moved (lower bound %.1f)",
            report.n_old, report.n_new,
            report.bytes_total / 2**20, report.bytes_moved / 2**20,
            report.bytes_lower_bound / 2**20,
        )
        return meta

    def _reshard_entity(self, name: str, ent: DistributedEntity, shards: dict[int, Any],
                        residency: dict[int, int | None], new_n_ranks: int):
        """Write one entity's recovered old-world shards back as
        ``new_n_ranks`` new ones; returns its plan, or None for an entity
        without global coordinates (it merges its old-world shard map and
        re-shards at the next checkpoint). The recovered and new shards of
        the entity are freed when this returns."""
        coords = self._stored_coords(name)
        if coords is None and hasattr(ent, "shard_coords"):
            coords = ent.shard_coords(self.n_ranks)
        if name in self._replicated or coords is None:
            ent.restore_shards(shards)
            return None
        paths = tree_flatten(shards[min(shards)])[0]
        leaves_by_origin = {o: tree_flatten(p)[1] for o, p in shards.items()}
        axes = [ls.axis for ls in coords[0]]
        row_nb = _row_nbytes(leaves_by_origin[min(leaves_by_origin)], coords[0])
        plan = plan_repartition(coords, new_n_ranks, residency, row_nb)
        reshard = reshard_leaves_device if self.device.type == "cuda" else reshard_leaves
        new_leaves = reshard(plan, leaves_by_origin, axes)
        ent.restore_shards({j: tree_unflatten(paths, new_leaves[j]) for j in range(new_n_ranks)})
        return plan

    def _recovery_host(self, origin: int, alive: set[int]) -> int | None:
        """Old-world rank whose host ends up holding ``origin``'s recovered
        payload (the survivor itself or the adopting copy holder — the codec
        decides). An alive-but-empty origin (revived spare) holds nothing:
        its shard is rebuilt elsewhere, and residency must say so or elastic
        movement accounting undercounts."""
        if origin in alive and self.stores[origin].buffer.valid:
            return origin
        return self.codec.rebuilder(self._groups(), self._group_of(origin), origin, alive)

    def _stored_coords(self, name: str):
        """Global-coordinate table recorded with the last valid checkpoint."""
        for st in self.stores.values():
            if st.alive and st.buffer.valid:
                table = st.buffer.read_only.meta.get("coords", {}).get(name)
                if table is not None:
                    return table
        return None

    def _recover_entity_shards(
        self, name: str, ent: DistributedEntity, alive: set[int], failed: set[int]
    ) -> dict[int, Any]:
        """Recover every origin's shard of one entity (Algorithm 4 inner loop)."""
        shards: dict[int, Any] = {}
        partials: dict[int, Any] = {}
        decode_cache: dict[int, dict[int, Any]] = {}
        for origin in range(self.n_ranks):
            kind, payload = self._recover_shard(origin, name, alive, failed, decode_cache)
            if kind == "full":
                shards[origin] = payload
            elif kind == "partial":
                partials[origin] = payload
        if not shards:
            raise dist.DataLostError(f"no shard of entity {name!r} recoverable")
        if partials:
            # Adopted copies hold only the uniquely-owned subset; merge in
            # the replicated leaves from any survivor's full payload.
            ref = shards[min(shards)]
            for origin, subset in partials.items():
                shards[origin] = ent.merge_payload(subset, ref, self.n_ranks)
        return shards

    def _recover_shard(
        self,
        origin: int,
        name: str,
        alive: set[int],
        failed: set[int],
        decode_cache: dict[int, dict[int, Any]] | None = None,
    ):
        """Returns ("full"|"partial", payload). Partial = partner-exchange
        subset needing a merge with a survivor's replicated leaves."""
        has_subset = hasattr(self._entities[name], "partner_payload")
        # 1. Survivor: restore from its own read-only buffer — local, no comm.
        if origin in alive and self.stores[origin].buffer.valid:
            flat, man = self.stores[origin].buffer.read_only.own[name]
            self.stats.zero_comm_restores += 1
            return "full", unpack_bytes(flat, man, device=self.device)

        # 1b. Replicated entity: any survivor's own copy is the payload.
        if name in self._replicated:
            for r in sorted(alive):
                if self.stores[r].buffer.valid:
                    flat, man = self.stores[r].buffer.read_only.own[name]
                    self.stats.zero_comm_restores += 1
                    return "full", unpack_bytes(flat, man, device=self.device)
            raise dist.DataLostError(f"replicated entity {name!r} lost everywhere")

        # 2. Codec rebuild: gather the group's surviving shards + intact
        # redundancy blobs and ask the codec to decode the missing ones. The
        # copy codec's group is the singleton {origin}: present={}, and
        # decode adopts any surviving whole copy (communication!).
        groups = self._groups()
        gi = self._group_of(origin)
        grp = groups[gi]

        def _has_data(m: int) -> bool:
            st = self.stores.get(m)
            return st is not None and st.alive and st.buffer.valid

        rebuilt_map = decode_cache.get(gi) if decode_cache is not None else None
        if rebuilt_map is None:
            # Missing = dead ranks AND alive-but-empty ones (revived spares).
            missing_idx = [i for i, m in enumerate(grp.members) if not _has_data(m)]
            if len(missing_idx) > self.codec.tolerance():
                raise dist.DataLostError(
                    f"group {gi} lost {len(missing_idx)} members; "
                    f"codec {self.codec.name!r} tolerates {self.codec.tolerance()}"
                )
            blobs: dict[int, torch.Tensor] = {}
            for b, holders in enumerate(self.codec.placement(groups, gi, self.n_ranks)):
                # whole copies: one stripe per blob, adopted by reference
                stripes = [
                    self.stores[member].buffer.read_only.parity.get(gi, {}).get((name, b, j))
                    if _has_data(member) else None
                    for j, member in enumerate(holders)
                ]
                if all(s is not None for s in stripes):
                    blobs[b] = stripes[0]
            present = {
                i: self.stores[m].buffer.read_only.own[name][0]
                for i, m in enumerate(grp.members) if i not in missing_idx
            }
            try:
                rebuilt_map = self.codec.decode(present, blobs, missing_idx)
            except codec_mod.CodecDecodeError as e:
                raise dist.DataLostError(
                    f"rank {origin} (group {gi}) unrecoverable under codec "
                    f"{self.codec.name!r}, entity {name!r}: {e}"
                ) from e
            if decode_cache is not None:
                decode_cache[gi] = rebuilt_map
        rebuilt = rebuilt_map[grp.members.index(origin)].reshape(-1)
        self.stats.adopted_restores += 1
        man = self._redundancy_manifest(origin, name)
        kind = "partial" if has_subset else "full"
        if isinstance(man, tuple) and man[0] == "compressed":
            return kind, self._decompress(rebuilt, man)
        return kind, unpack_bytes(rebuilt[: man.total], man, device=self.device)

    def _redundancy_manifest(self, origin: int, name: str) -> Any:
        # Manifests are tiny; replicated with every store's meta at capture.
        for st in self.stores.values():
            if st.alive and st.buffer.valid:
                mans = st.buffer.read_only.meta.get("manifests", {})
                if (origin, name) in mans:
                    return mans[(origin, name)]
        raise dist.DataLostError(f"manifest for rank {origin} entity {name!r} lost")


def _row_nbytes(leaves: list[torch.Tensor], coords: list[Any]) -> list[int]:
    """Bytes per planner row for each leaf: a slice along the leaf's data
    axis, or the full leaf for replicated ones (one logical row)."""
    out = []
    for leaf, ls in zip(leaves, coords):
        nbytes = leaf.numel() * leaf.element_size()
        out.append(nbytes if ls.axis is None else nbytes // max(leaf.shape[ls.axis], 1))
    return out
