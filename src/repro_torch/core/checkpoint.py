"""The distributed checkpoint engine over per-rank host stores (port of
``repro.core.checkpoint``, paper §5.2).

Algorithm 2 (``checkpoint``): capture every entity's shards into the
writable bank of each rank's host store → encode and distribute redundancy
through the codec → handshake (liveness + checksum validation) → pointer
swap of every double buffer. A fault anywhere before the swap leaves every
read-only buffer untouched.

Algorithm 4 (``restore``): survivors restore their own shards with zero
communication; a lost shard is adopted from a surviving partner copy, or
rebuilt by the codec from its group's survivors and redundancy blobs.

Codecs (``core/codec.py``): ``copy`` (whole partner copies) and the striped
``xor``, ``rs`` and ``lrc``, whose blobs are striped over holder groups.
Their encode runs as GF(2^8) matrix products over planned byte ranges
(``_encode_blobs_chunked``) and their restore as the codec's chunked decode,
both through ``gf256``'s active backend: on the card (B4) when it is
``torch``, which ``cfg.gf_backend`` forces and the backend probe may pick.

The reference's default engine runs as it is:

* create: phase A (``checkpoint_async``) captures each leaf straight into
  the writable bank's arenas, pinned ones when the engine runs on the card
  (one device-to-host copy per byte; the exchange subset is copied host-side
  from the own arena). Phase B, the drain, runs ENCODE i ‖ TRANSFER i−1 ‖
  VERIFY i−2 over (group, entity) units: in ``finalize_async``, or on a
  background worker (``async_workers > 0``, the default), sharded across
  ``async_workers`` workers. Under ``compress`` the encode quantizes on the
  card (B5a) on the worker's own CUDA stream, which the training step never
  waits on; the GF(2^8) products of the striped codecs run on that stream
  too. Striped blobs are encoded into per-(group, entity) scratch arenas,
  pinned on the card and reused across creates, and TRANSFER copies each
  stripe into its holder's arena.
* restore: ``restore_mode="pipelined"`` (the default) drains the chunked
  TRANSFER/DECODE/VERIFY/DEQ pipeline, the dequantization on the card (B5b)
  chunk by chunk, with a generation-keyed plan cache and the adaptive chunk
  planner; ``"sync"`` keeps the serial per-origin decode. Both give the same
  bytes, and so does ``restore_elastic``, the N-to-M repartition onto a new
  world size (on the card every split leaf of every new rank is built by
  the row-gather kernel B6).

Below the diskless stores sits the storage-tier ladder (``core/storage.py``,
``cfg.tiers``): a committed generation is flushed to its persistent rungs in
the background, on the drain's worker pool after the pointer swap, and
recovery escalates down the ladder: codec reconstruction first, and only
when the failure set exceeds the codec's tolerance (or nothing survives a
cold start) is the newest valid generation on disk loaded and recovery run
again against it. ``restore_elastic`` with nothing in memory is the cold
N-to-M restart from the same generation.

Under ``cfg.delta`` (differential checkpointing) the drain takes each
member's exchange checksum per chunk of a fixed grid (the partials combine
to the exact whole-buffer sums, so one host pass serves both) and diffs it
against the committed generation's table: below ``delta_crossover`` the
parity is patched in place, ``parity ^= G·(new ⊕ old)`` over the merged
dirty ranges (one GF(2^8) product per range, B4 on the card under the
``torch`` backend), and TRANSFER copies only the stripe chunks that differ
from what the holder's arena holds.

With a failure-domain topology (``cfg.topology``, ``core/topology.py``)
the parity groups are packed so that no group holds two members of one
domain (``distribution.domain_parity_groups``): a whole-rack loss costs
each group at most one member. Each entity may carry its own codec at the
engine's group size (``set_entity_codec``, driven by ``core/policy.py``
through ``add_commit_hook``); every payload records the codec that encoded
each entity, and a restore decodes with that record, never with the live
override.

Host stores hold ``torch.uint8`` CPU arenas; the handshake checksums them
on the host with ``np_checksum``, as the reference does. Restored payloads
are unpacked onto the engine's device (``cuda`` unless the caller passes
``device="cpu"``), where the entities write them back.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Protocol

import numpy as np
import torch

from repro_torch.core import codec as codec_mod
from repro_torch.core import distribution as dist
from repro_torch.core import gf256
from repro_torch.core import parity as parity_mod
from repro_torch.core import storage as storage_mod
from repro_torch.core.hoststore import HostStore, StorePayload, pinned_empty
from repro_torch.core.integrity import IntegrityError, np_checksum
from repro_torch.core.serialization import Manifest, arena_views, dtype_from_name, pack_bytes, unpack_bytes
from repro_torch.core.snapshot import Snapshottable
from repro_torch.elastic.plan import ElasticReport, plan_repartition
from repro_torch.elastic.reshard import reshard_leaves, reshard_leaves_device
from repro_torch.obs.journal import EventJournal
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import tracer
from repro_torch.kernels import quantize as qk
from repro_torch.optim.grad_compress import _DTYPES, _is_packed, _map, compress_tree, decompress_tree
from repro_torch.sharding.mesh import resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.pytree import tree_flatten, tree_unflatten

log = get_logger("core.checkpoint")

_TR = tracer()  # process-global span tracer (no-op spans while disabled)

# Engines number themselves so multi-engine traces stay attributable.
_ENGINE_SEQ = itertools.count()

#: Process-wide decode- and encode-rate records (range bytes/s, peak with
#: slow decay, per codec name): a fresh engine sizes its first chunks from
#: the last engine's measured rate, else from the GF backend probe.
_DECODE_RATE: dict[str, float] = {}
_DECODE_RATE_LOCK = threading.Lock()
_ENCODE_RATE: dict[str, float] = {}
_ENCODE_RATE_LOCK = threading.Lock()


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
    """The reference's fields and defaults."""

    scheme: str = "pairwise"       # pairwise | neighbor (distribution callbacks)
    n_copies: int = 1              # R remote copies (eq. 2: MEM = S(1+2R'), R' = 1+n_copies)
    parity_group: int = 0          # >0: erasure-coded group size (k for xor/rs)
    compress: bool = False         # int8-compress partner payloads (beyond-paper)
    validate: bool = True          # checksum handshake
    codec: str = ""                # "" infers: parity_group>0 -> "xor", else "copy"
    rs_parity: int = 2             # m parity blobs per group for codec="rs"
    lrc_locals: int = 2            # local groups for codec="lrc"
    topology: object = None        # failure-domain topology: domain-aware parity groups
    async_workers: int = 1         # background drain workers (0: drain in finalize_async)
    restore_mode: str = "pipelined"  # "pipelined" | "sync" (the serial per-origin decode)
    restore_chunk_bytes: int = 0   # pipelined restore chunk bytes; 0 = the adaptive planner
    encode_chunk_bytes: int = 0    # create-side chunking; the copy codec encodes whole
    delta: bool = False            # differential checkpointing (dirty map, parity patch, transfer skip)
    delta_chunk_bytes: int = 1 << 20   # dirty-map chunk grid (4-aligned)
    delta_crossover: float = 0.6       # dirty fraction beyond which a full re-encode wins
    gf_backend: str = ""           # force a GF(2^8) backend: "table" | "swar" | "torch"
    tiers: tuple = ()              # persistent storage-tier ladder (storage.TierSpec rungs)


#: ``CheckpointStats`` attribute -> (metric kind, metric name, python type,
#: help): the reference's names, and one of the port's own
#: (``last_delta_ranges``).
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
    "last_restore_decode_s": ("gauge", "restore_last_decode_seconds", float,
                              "Wall time of the last recovery drain."),
    "last_restore_bytes_rebuilt": ("gauge", "restore_last_bytes_rebuilt", int,
                                   "Padded bytes codecs reconstructed."),
    "last_restore_chunks": ("gauge", "restore_last_chunks", int,
                            "TRANSFER/DECODE/VERIFY chunks drained."),
    "last_restore_decompressed_bytes": ("gauge", "restore_last_decompressed_bytes", int,
                                        "Bytes expanded by the chunked DEQ stage."),
    "restore_plan_reuses": ("counter", "restore_plan_reuse_total", int,
                            "Restore units served from the generation-keyed plan cache."),
    "tier_flushes": ("counter", "tier_flush_total", int, "Persistent-tier generations committed."),
    "tier_flush_skipped": ("counter", "tier_flush_skipped_total", int,
                           "Flush cadence points dropped under back-pressure."),
    "tier_flush_queued": ("counter", "tier_flush_queued_total", int,
                          "Flush cadence points deferred into the queue slot."),
    "tier_escalations": ("counter", "tier_escalation_total", int,
                         "Recoveries that fell back to a persistent tier."),
    "last_flush_s": ("gauge", "tier_last_flush_seconds", float, "Wall time of the last background flush."),
    "last_flush_bytes": ("gauge", "tier_last_flush_bytes", int, "Bytes the last flush wrote."),
    "last_flush_wait_s": ("gauge", "tier_last_flush_wait_seconds", float,
                          "Capture time spent joining a flush (bank conflict)."),
    "last_dirty_fraction": ("gauge", "ckpt_last_dirty_fraction", float,
                            "Dirty-chunk byte fraction of the last delta capture."),
    "delta_encodes": ("counter", "ckpt_delta_encode_total", int,
                      "Units whose parity was patched incrementally."),
    "full_encodes": ("counter", "ckpt_full_encode_total", int, "Units re-encoded in full under delta mode."),
    "last_transfer_bytes_skipped": ("gauge", "ckpt_last_transfer_bytes_skipped", int,
                                    "Stripe bytes the last transfer left in place (unchanged chunks)."),
    "last_flush_chunks_written": ("gauge", "tier_last_flush_chunks_written", int,
                                  "New chunk objects the last dedup flush stored."),
    "last_flush_chunks_reused": ("gauge", "tier_last_flush_chunks_reused", int,
                                 "Chunk references the last dedup flush served from the store."),
    "last_dedup_ratio": ("gauge", "tier_last_dedup_ratio", float,
                         "Stored/logical byte ratio of the last dedup flush (lower = more dedup)."),
    "last_delta_ranges": ("gauge", "ckpt_last_delta_ranges", int,
                          "Dirty ranges the last create patched (one GF(2^8) product each)."),
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
class _RestoreUnit:
    """One failure group's reconstruction of one entity, the unit of the
    restore pipeline: prepared up front (references to the surviving copies
    captured, the codec's chunk decoder bound), then drained in 4-aligned
    byte chunks: TRANSFER joins stripe segments into blob arenas, DECODE
    runs the codec's chunk function, VERIFY takes Fletcher partials of the
    rebuilt bytes, DEQ dequantizes the chunk's int8 codes on the engine's
    device. Chunks touch disjoint byte ranges, so chunks and units run in
    parallel across workers."""

    gi: int
    grp: Any
    name: str
    missing_idx: list[int]
    stripe_srcs: dict[int, list[torch.Tensor]]   # blob -> stripes to join (multi-stripe only)
    blobs: dict[int, torch.Tensor]               # blob -> arena (or adopted single stripe)
    rebuilt: dict[int, torch.Tensor]             # missing idx -> rebuilt flat
    decode_chunk: Any                            # codec chunk fn (lo, hi) -> None
    bounds: list[tuple[int, int]]                # 4-aligned chunk byte ranges
    manifests: dict[int, Any]                    # missing idx -> origin manifest
    ref_sums: dict[int, Any]                     # missing idx -> capture checksum | None
    sums: dict[int, list]                        # missing idx -> per-chunk partials
    # compressed origins: missing idx -> one _DeqLeaf per quantized leaf
    decomp: dict[int, list] | None = None
    # a plan-cache hit: the blob arenas already hold the committed bytes
    # (``staged``) and their checksum verdict is known clean (``verified``)
    staged: bool = False
    verified: bool = False


@dataclass
class _DeqLeaf:
    """One quantized leaf of a compressed origin, dequantized chunk by chunk:
    bytes [q_off, q_off + q_n) of the rebuilt flat hold the int8 codes, one
    f32 scale per ``block`` of them (``scales``, on the engine's device,
    read at prep: the compressed copy is adopted whole); ``out`` is the f32
    destination on the engine's device."""

    q_off: int
    q_n: int
    block: int
    scales: torch.Tensor
    out: torch.Tensor


@dataclass
class _PendingCheckpoint:
    """An un-committed snapshot between the capture and the swap."""

    packed: dict[str, list[tuple[Any, Manifest]]]   # exchange/partner buffers
    manifests: dict[tuple[int, str], Any]
    alive0: set[int]
    t0: float
    future: Any = None          # background drain future (None = drain in finalize_async)
    bytes_exchanged: int = 0
    verified: set = field(default_factory=set)      # (rank, entity) unit-verified
    # Replicated with every store's meta (shared reference, like the
    # manifests) and filled by the drain's encode stage: capture-time
    # exchange checksums, keys (rank, entity).
    exch_sums: dict = field(default_factory=dict)
    gen: int = 0                # generation this snapshot becomes on commit
    # Differential bookkeeping (cfg.delta), filled by the drain like
    # exch_sums: the per-(rank, entity) chunk-grid Fletcher partials of the
    # exchange payloads (replicated in meta: the next capture's dirty-map
    # baseline), the scratch-parity validity entries staged for commit, and
    # the capture's dirty/skip byte and patched-range tallies.
    chunk_sums: dict = field(default_factory=dict)
    delta_enc: dict = field(default_factory=dict)
    dirty_bytes: int = 0
    logical_bytes: int = 0
    skipped_bytes: int = 0
    delta_ranges: int = 0


def _chunk_checksums(flat: torch.Tensor, step: int) -> tuple:
    """Per-chunk Fletcher partials over the ``step`` grid (``step``
    4-aligned, only the last chunk ragged). Linearity makes them combine:
    the chunk at word offset ``o`` adds ``s1 += c1; s2 += c2 + o·c1``, so
    the combined sums equal a whole-buffer ``np_checksum``."""
    flat = flat.numpy()
    return tuple(np_checksum(flat[lo : lo + step]) for lo in range(0, flat.nbytes, step))


def _combine_checksums(parts: tuple, step: int) -> tuple[int, int]:
    s1 = s2 = 0
    words = step // 4
    for ci, (c1, c2) in enumerate(parts):
        s1 = (s1 + c1) & 0xFFFFFFFF
        s2 = (s2 + c2 + ci * words * c1) & 0xFFFFFFFF
    return s1, s2


def _merge_chunk_ranges(idx: list[int], step: int, nbytes: int) -> list:
    """Dirty chunk indices -> merged, clipped [lo, hi) byte ranges."""
    ranges: list[list[int]] = []
    for ci in idx:
        lo, hi = ci * step, min(ci * step + step, nbytes)
        if ranges and ranges[-1][1] == lo:
            ranges[-1][1] = hi
        else:
            ranges.append([lo, hi])
    return [(lo, hi) for lo, hi in ranges]


def _copy_dirty(dst: torch.Tensor, src: torch.Tensor, step: int) -> int:
    """Copy only the ``step``-grid chunks of ``src`` that differ from what
    ``dst`` (the holder arena's previous content) holds; returns the bytes
    left in place. Exact: it compares the bytes, so a fresh (garbage) arena
    simply copies everything."""
    dst, src = dst.numpy(), src.numpy()
    skipped = 0
    for lo in range(0, src.nbytes, step):
        hi = min(lo + step, src.nbytes)
        if np.array_equal(dst[lo:hi], src[lo:hi]):
            skipped += hi - lo
        else:
            np.copyto(dst[lo:hi], src[lo:hi])
    return skipped


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
        self.n_ranks = n_ranks
        self.cfg = cfg
        #: where restored payloads are unpacked and compression runs
        self.device = resolve_device(device)
        self.stores: dict[int, HostStore] = self._new_stores(n_ranks)
        self._entities: dict[str, DistributedEntity] = {}
        # Entities whose payload is identical on every rank need no partner
        # exchange (paper §5.2.1) — any survivor restores them.
        self._replicated: set[str] = set()
        self._alive_fn = alive_fn or (lambda: {r for r, s in self.stores.items() if s.alive})
        # fault_hook(phase) lets a failure injector strike at precise points
        # inside the checkpoint procedure (tests for Algorithm 2's guarantee).
        self._fault_hook = fault_hook or (lambda phase: None)
        self._pending: _PendingCheckpoint | None = None
        self._pool: Any = None          # lazy ThreadPoolExecutor (drain + restore workers)
        self._streams: dict[int, Any] = {}  # worker thread -> its CUDA stream for the drain
        # Single-slot restore-plan cache: key -> prepped units of the last
        # fully successful pipelined restore (one slot: restore arenas are
        # leased by (group, entity) key, so two plans would alias them).
        self._restore_plan_cache: tuple[Any, dict[tuple[int, str], _RestoreUnit]] | None = None
        # ((group, entity), blob) -> the striped encode's accumulator: pinned
        # on the card, reused across creates (TRANSFER copies the stripes out
        # before the next drain re-leases it)
        self._enc_scratch: dict[Any, torch.Tensor] = {}
        # Differential checkpointing: which (group, entity) scratch arenas
        # still hold the COMMITTED generation's parity, and under which codec
        # and member layout: the baseline a parity patch needs. Cleared on
        # every discontinuity (abort, discard, escalation, resize): a full
        # re-encode is always right, a stale baseline never is.
        self._delta_enc: dict[tuple[int, str], tuple] = {}
        self._delta_lock = threading.Lock()  # pending dirty/skip tallies
        # The storage-tier ladder: rung 0 is the stores above; persistent
        # rungs flush committed generations in the background and feed
        # escalating recovery.
        self.tiers = storage_mod.build_tiers(cfg.tiers)
        self._flush_future: Any = None       # at most one flush in flight
        self._flush_created: int = -1        # commit counter when it started
        self._flush_pending: Any = None      # queued (due tiers, snapshot): one slot
        # guards the _flush_pending hand-off between the caller and the
        # flush worker (which chains the queued flush itself)
        self._flush_lock = threading.Lock()
        self._obs_id = next(_ENGINE_SEQ)
        self.stats = CheckpointStats()
        self.registry = self.stats.registry
        self._h_stage = self.registry.histogram(
            "ckpt_stage_seconds", "Create-pipeline stage seconds per unit.", labelnames=("phase",))
        self._h_rate = self.registry.histogram(
            "ckpt_stage_bytes_per_second", "Create-pipeline stage throughput per unit.",
            labelnames=("phase",))
        self._h_restore = self.registry.histogram(
            "restore_stage_seconds", "Restore-pipeline stage seconds per chunk.", labelnames=("phase",))
        # pre-bound children for the chunk loop (no kwargs dict per chunk)
        self._hr_transfer = self._h_restore.labels(phase="r_transfer")
        self._hr_decode = self._h_restore.labels(phase="decode")
        self._hr_verify = self._h_restore.labels(phase="r_verify")
        self._hr_deq = self._h_restore.labels(phase="deq")
        self._h_restore_rate = self.registry.histogram(
            "restore_decode_bytes_per_second",
            "Chunk-decode throughput driving the adaptive restore planner.", labelnames=("codec",))
        # the journal lives in the first persistent tier's directory, so the
        # failure and recovery record survives a cold restart with the data
        journal_path = next((os.path.join(t.path, "journal.jsonl") for t in self.tiers
                             if t.persistent and getattr(t, "path", None)), None)
        self.journal = EventJournal(journal_path, self.registry)
        self.last_elastic_report: ElasticReport | None = None  # of the last N-to-M restore
        self.codec = codec_mod.make_codec(cfg)
        # Per-entity codec overrides at the engine's group size (the adaptive
        # policy's surface): only the blob math differs, the group layout is
        # shared. Restores resolve each entity's codec from the payload's
        # codec record, so a change between capture and restore cannot desync.
        self.entity_codecs: dict[str, codec_mod.RedundancyCodec] = {}
        self._spec_codecs: dict[str, codec_mod.RedundancyCodec] = {}
        # the failure-domain topology, sized to this world (resized with it by
        # the elastic path), and the domain-aware layout's cache
        self.topology = cfg.topology.resized(n_ranks) if cfg.topology is not None else None
        self._groups_cache: tuple | None = None
        self._commit_hooks: list[Callable[[Any], None]] = []  # run after every commit
        if cfg.gf_backend:
            gf256.set_backend(cfg.gf_backend)

    def _new_stores(self, n_ranks: int) -> dict[int, HostStore]:
        """One store per rank, leasing pinned arenas when the engine's device
        is a card."""
        return {r: HostStore(r, pinned=self.device.type == "cuda") for r in range(n_ranks)}

    def _codec_spec(self, c: codec_mod.RedundancyCodec) -> str:
        """Compact codec descriptor recorded per entity in every payload."""
        m = getattr(c, "m", getattr(c, "global_parity", 0))
        l = getattr(c, "local", 0)
        return f"{c.name}:{m}:{l}"

    # ------------------------------------------------------------------ #
    # per-entity protection (the adaptive policy's surface)
    # ------------------------------------------------------------------ #
    def set_entity_codec(self, name: str, codec: str, m: int | None = None) -> None:
        """Protect entity ``name`` with ``codec`` from the NEXT capture on, at
        the engine's group size (layout, placement and recovery plans stay
        shared); ``m`` sets rs_parity for "rs"/"lrc"."""
        cand = replace(self.cfg, codec=codec, rs_parity=m if m is not None else self.cfg.rs_parity)
        new = codec_mod.make_codec(cand)
        assert new.group_size(self.n_ranks) == self.codec.group_size(self.n_ranks), (
            f"entity codec {codec!r} changes the group size; per-entity "
            f"overrides must keep the engine layout"
        )
        self.entity_codecs[name] = new

    def clear_entity_codec(self, name: str) -> None:
        self.entity_codecs.pop(name, None)

    def _codec_for(self, name: str) -> codec_mod.RedundancyCodec:
        """The codec the next capture encodes entity ``name`` with."""
        return self.entity_codecs.get(name, self.codec)

    def _codec_from_spec(self, spec: str) -> codec_mod.RedundancyCodec:
        """The codec a payload's codec record names (cached per spec)."""
        name, m, l = spec.split(":")
        if self._codec_spec(self.codec) == spec:
            return self.codec
        cached = self._spec_codecs.get(spec)
        if cached is None:
            cand = replace(self.cfg, codec=name, rs_parity=max(int(m), 1),
                           lrc_locals=int(l) if int(l) else self.cfg.lrc_locals)
            cached = self._spec_codecs[spec] = codec_mod.make_codec(cand)
        return cached

    def _restore_codec(self, name: str) -> codec_mod.RedundancyCodec:
        """The codec that encoded entity ``name`` in the committed generation:
        read from the codec record any valid store carries, so an override
        set between capture and restore never changes the decode; the live
        choice for a payload without a record."""
        for st in self.stores.values():
            if st.alive and st.buffer.valid:
                spec = st.buffer.read_only.meta.get("codecs", {}).get(name)
                if spec:
                    return self._codec_from_spec(spec)
        return self._codec_for(name)

    def add_commit_hook(self, fn: Callable[[Any], None]) -> None:
        """``fn(engine)`` runs after every commit (the pointer swap and the
        tier flush's scheduling): the adaptive policy's evaluation point."""
        self._commit_hooks.append(fn)

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

    def checkpoint_async(self, meta: dict[str, Any] | None = None, background: bool | None = None) -> bool:
        """Phase A: capture a consistent snapshot of every entity straight
        into the writable-bank arenas; every copy out of the live state is
        complete when this returns, so the caller may update the state. The
        encode + transfer + verify drain is deferred to a background worker
        when ``background`` (default: ``cfg.async_workers > 0``), else to
        ``finalize_async``. Nothing touches the read-only buffers until the
        handshake succeeds and the buffers swap."""
        if self._pending is not None:
            # Two captures without a finalize: the first snapshot was never
            # committed — drain and drop it before its arenas are re-leased.
            self.discard_pending()
        self.kick_tier_flush()  # a staged flush runs behind this capture (disjoint banks)
        queued = self._flush_pending  # local reference: the flush worker may take it
        if (self._flush_future is not None and self.stats.created > self._flush_created) or (
                queued is not None and self.stats.created > queued[1].created):
            # A commit happened since the running flush started (or since a
            # queued flush captured its snapshot), so the bank this capture
            # stages into is the bank that flush still reads (the generation
            # parity rule): join it before the arenas are re-leased.
            t_w = time.perf_counter()
            with _TR.span("flush_wait", eng=self._obs_id, gen=self.stats.created + 1):
                self._join_flush()
            self.stats.last_flush_wait_s = time.perf_counter() - t_w
        else:
            self.stats.last_flush_wait_s = 0.0
        gen = self.stats.created + 1  # generation this capture becomes on commit
        t0 = time.perf_counter()
        alive0 = self._alive_fn()
        try:
            with _TR.span("capture", eng=self._obs_id, gen=gen):
                self._fault_hook("before_create")
                packed_partner, manifests, exch_sums, chunk_sums = self._capture(alive0, meta)
                self._fault_hook("after_create")
        except FaultDuringCheckpoint as e:
            log.warning("checkpoint aborted during create: %s", e)
            for s in self.stores.values():
                s.buffer.discard_writable()
            self.stats.aborted += 1
            self.journal.record("abort", phase="capture", gen=gen, cause=str(e))
            return False

        self.stats.last_capture_s = time.perf_counter() - t0
        self._h_stage.observe(self.stats.last_capture_s, phase="capture")
        if self.stats.last_capture_s > 0:
            self._h_rate.observe(self.stats.last_bytes_staged / self.stats.last_capture_s, phase="capture")
        pending = _PendingCheckpoint(packed_partner, manifests, alive0, t0, exch_sums=exch_sums,
                                     chunk_sums=chunk_sums, gen=gen)
        self._pending = pending
        if background is None:
            background = self.cfg.async_workers > 0
        if background:
            pending.future = self._executor().submit(self._drain, pending)
        return True

    def _capture(
        self, alive0: set[int], meta: dict[str, Any] | None
    ) -> tuple[dict[str, list[tuple[Any, Manifest]]], dict[tuple[int, str], Any], dict, dict]:
        """Serialize every entity's per-rank shards directly into host-store
        arenas (one copy per leaf, zero steady-state allocation; shards on
        the card are copied straight into pinned arenas) and stage
        the writable payloads. Returns the exchange buffers the drain
        encodes, the replicated manifest table and the (empty, shared)
        exchange-checksum and chunk-checksum tables the drain fills."""
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
            rows: list[tuple[Any, Manifest]] = []
            for r, shard in enumerate(ent.snapshot_shards(self.n_ranks)):
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
                # exist on every rank already — paper §5.2.1), copied on the
                # host from the own arena just written: each byte of the
                # live state crosses the link once.
                sub_rows: list[tuple[Any, Manifest]] = []
                for r, (flat, man) in enumerate(rows):
                    subset = ent.partner_payload(arena_views(flat, man), self.n_ranks)
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
        # Per-chunk Fletcher partials of the same exchange payloads (under
        # cfg.delta), replicated and filled the same way: the next capture's
        # dirty-map baseline, carried by any survivor.
        chunk_sums: dict[tuple[int, str], Any] = {}
        # each entity's codec, replicated with every store's meta: a restore
        # decodes with the codec that encoded, whatever the policy says since
        codec_specs = {name: self._codec_spec(self._codec_for(name)) for name in packed}
        for r in alive0:
            payload = StorePayload(meta=dict(meta or {}))
            if coords_tables:
                payload.meta["coords"] = dict(coords_tables)
            payload.meta["manifests"] = manifests
            payload.meta["codecs"] = codec_specs
            for name, rows in packed.items():
                flat, man = rows[r]
                payload.own[name] = (flat, man)
                if self._codec_for(name).striped and packed_partner[name] is not packed[name]:
                    # survivors present their exchange subset to the decode
                    payload.own_exch[name] = packed_partner[name][r]
                if self.cfg.validate:
                    payload.meta.setdefault("checksums", {})[name] = np_checksum(flat.numpy())
            if self.cfg.validate:
                payload.meta["exch_checksums"] = exch_sums
            if self.cfg.delta:
                payload.meta["exch_chunk_sums"] = chunk_sums
            self.stores[r].buffer.write(payload)
        self.stats.last_bytes_staged = bytes_staged
        return packed_partner, manifests, exch_sums, chunk_sums

    # ------------------------------------------------------------------ #
    # the drain: encode / transfer / verify per (group, entity) unit
    # ------------------------------------------------------------------ #
    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=max(1, self.cfg.async_workers),
                                            thread_name_prefix="ckpt-pipeline")
        return self._pool

    @contextlib.contextmanager
    def _worker_stream(self):
        """The calling thread's own CUDA stream for the drain's and the
        restore's work on the card (the compressed encode, the GF(2^8)
        products), so the training step, on the default stream, never waits
        on it; yields None on the CPU. Inside, the ``torch`` GF backend runs
        on the engine's device."""
        with gf256.compute_device(self.device):
            if self.device.type != "cuda":
                yield None
                return
            tid = threading.get_ident()
            stream = self._streams.get(tid)
            if stream is None:
                stream = self._streams[tid] = torch.cuda.Stream(self.device)
            with torch.cuda.stream(stream):
                yield stream

    def _pipeline_units(self, packed) -> list[tuple]:
        """One work unit per (group, entity); placement is per entity (an
        override changes the blob count, the shared layout keeps the
        holders aligned)."""
        groups = self._groups()
        units = []
        for gi, grp in enumerate(groups):
            for name in packed:
                if name in self._replicated:
                    continue  # equal on all ranks: no redundancy needed
                placements = self._codec_for(name).placement(groups, gi, self.n_ranks)
                if not placements:
                    continue
                units.append((gi, grp, placements, name))
        return units

    def _drain(self, pending: _PendingCheckpoint) -> tuple[int, set]:
        """Run the drain to completion. With ``async_workers > 1`` the units
        shard across the worker pool, each worker draining its own
        three-stage sub-pipeline (holder stores synchronize their payload
        writes on the store lock; the copies land in disjoint arenas). This
        thread keeps one shard, so the pool never deadlocks when the drain is
        itself a background submission. Nothing here touches a read-only
        buffer; a fault raises ``FaultDuringCheckpoint`` and the whole
        snapshot aborts."""
        units = self._pipeline_units(pending.packed)
        n = len(units)
        n_shards = max(1, min(self.cfg.async_workers, n))
        if n_shards == 1:
            total, verified = self._drain_shard(units, pending)
        else:
            shards = [units[w::n_shards] for w in range(n_shards)]
            futures = [self._executor().submit(self._drain_shard, shard, pending) for shard in shards[1:]]
            # Join EVERY sibling before raising: an abandoned worker would
            # keep writing into arenas that the abort discards.
            err: BaseException | None = None
            total, verified = 0, set()
            try:
                total, verified = self._drain_shard(shards[0], pending)
            except BaseException as e:
                err = e
            for f in futures:
                try:
                    sub_total, sub_verified = f.result()
                    total += sub_total
                    verified |= sub_verified
                except BaseException as e:
                    err = err or e
            if err is not None:
                raise err
        self.stats.last_pipeline_chunks = n
        return total, verified

    def _drain_shard(self, units: list[tuple], pending: _PendingCheckpoint) -> tuple[int, set]:
        """One worker's share of the drain, in pipeline order: unit *i*
        ENCODEs, unit *i−1*'s copies TRANSFER to their holder stores, unit
        *i−2* VERIFYs its members' staged checksums."""
        n = len(units)
        total = 0
        verified: set = set()
        encoded: dict[int, list[torch.Tensor]] = {}
        eng, gen = self._obs_id, pending.gen
        with self._worker_stream() as stream:
            for i in range(n + 2):
                if i < n:
                    u = units[i]
                    with _TR.span("encode", eng=eng, gen=gen, group=u[0], entity=u[3]):
                        t = time.perf_counter()
                        encoded[i] = self._encode_unit(u, pending)
                        if stream is not None:
                            stream.synchronize()  # the encoded bytes are on the host
                        self._h_stage.observe(time.perf_counter() - t, phase="encode")
                if 0 <= i - 1 < n:
                    u = units[i - 1]
                    with _TR.span("transfer", eng=eng, gen=gen, group=u[0], entity=u[3]):
                        t = time.perf_counter()
                        nb = self._transfer_unit(u, encoded.pop(i - 1), pending)
                        dt = time.perf_counter() - t
                        self._h_stage.observe(dt, phase="transfer")
                        if dt > 0:
                            self._h_rate.observe(nb / dt, phase="transfer")
                        total += nb
                if 0 <= i - 2 < n:
                    u = units[i - 2]
                    with _TR.span("verify", eng=eng, gen=gen, group=u[0], entity=u[3]):
                        t = time.perf_counter()
                        self._verify_unit(u, verified)
                        self._h_stage.observe(time.perf_counter() - t, phase="verify")
                self._fault_hook("pipeline_chunk")
        return total, verified

    def _encode_unit(self, unit, pending: _PendingCheckpoint) -> list[torch.Tensor]:
        """ENCODE stage: one group's exchange buffers of one entity into
        redundancy blobs (under ``compress``, each member's buffer is first
        int8-compressed on the engine's device and its manifest replaced by
        the tagged compressed one; a striped codec's members also keep the
        compressed bytes in ``own_exch``, the only bytes its parity decodes
        against). Also records each uncompressed member's exchange checksum
        into the replicated ``exch_sums`` table. A codec with a GF(2^8)
        generator encodes in planned byte ranges into the scratch arenas.

        Under ``cfg.delta`` the member checksums are taken per chunk of the
        dirty-map grid (one host pass: the partials combine to the exact
        whole-buffer sums) and diffed against the committed generation's
        table; when the scratch arenas still hold the committed parity and
        the dirty fraction is under the crossover, the blobs are patched in
        place over the merged dirty ranges instead of re-encoded."""
        gi, grp, placements, name = unit
        codec = self._codec_for(name)
        n_out = len(placements)
        delta_on = self.cfg.delta and codec.striped and not (self.cfg.compress and codec.compressible)
        step = self._delta_step()
        prev_chunks = self._committed_chunk_sums() if delta_on else {}
        bufs = []
        # per member: merged dirty [lo, hi) ranges, or None (no baseline:
        # the first capture, a layout change), which counts as all dirty
        dirty: list[Any] = []
        dirty_bytes = logical = 0
        for m in grp.members:
            flat, man = pending.packed[name][m]
            if self.cfg.compress and codec.compressible:
                flat, man = self._compress(flat, man)
                pending.manifests[(m, name)] = man
                if codec.striped:
                    st = self.stores.get(m)
                    payload = st.buffer.writable if st is not None and st.alive else None
                    if payload is not None:
                        with st.lock:
                            payload.own_exch[name] = (flat, man)
            elif delta_on:
                parts = _chunk_checksums(flat, step)
                pending.chunk_sums[(m, name)] = (step, flat.numel(), parts)
                if self.cfg.validate:
                    # np_checksum(flat) from the partials in hand (no second pass)
                    pending.exch_sums[(m, name)] = _combine_checksums(parts, step)
                prev = prev_chunks.get((m, name))
                if prev is not None and prev[0] == step and prev[1] == flat.numel():
                    idx = [ci for ci, (a, b) in enumerate(zip(parts, prev[2])) if a != b]
                    ranges = _merge_chunk_ranges(idx, step, flat.numel())
                    dirty.append(ranges)
                    dirty_bytes += sum(hi - lo for lo, hi in ranges)
                else:
                    dirty.append(None)
                    dirty_bytes += flat.numel()
                logical += flat.numel()
            elif self.cfg.validate:
                # Compressed blobs skip restore-verify (their manifest is
                # tagged); everything else gets a capture-state reference.
                pending.exch_sums[(m, name)] = np_checksum(flat.numpy())
            bufs.append(flat)
        if delta_on:
            with self._delta_lock:
                pending.dirty_bytes += dirty_bytes
                pending.logical_bytes += logical
        key = (gi, name)

        def lease(b: int, nbytes: int) -> torch.Tensor:
            buf = self._enc_scratch.get((key, b))
            if buf is None or buf.numel() < nbytes:
                buf = pinned_empty(nbytes) if self.device.type == "cuda" else torch.empty(nbytes, dtype=torch.uint8)
                self._enc_scratch[(key, b)] = buf
            return buf[:nbytes]

        G = codec.encode_matrix(len(bufs)) if self.cfg.encode_chunk_bytes >= 0 else None
        if G is not None and G.shape[0] < n_out:
            G = None  # the matrix cannot cover this layout
        if delta_on and G is not None:
            # Scratch arenas holding the committed parity under this codec
            # and member layout license a patch; the staged validity entry
            # commits with the snapshot.
            entry = (self._codec_spec(codec), tuple(b.numel() for b in bufs), n_out)
            blobs = self._try_delta_encode(gi, name, grp, bufs, dirty, dirty_bytes, logical,
                                           G[:n_out], n_out, lease, entry, pending)
            pending.delta_enc[key] = (pending.gen,) + entry
            if blobs is not None:
                self.stats.delta_encodes += 1
                return blobs
            self.stats.full_encodes += 1
        elif delta_on:
            self.stats.full_encodes += 1
        if G is not None and codec.striped:
            return self._encode_blobs_chunked(G[:n_out], bufs, n_out, lease)
        return codec.encode_into(bufs, n_out, lease)

    def _try_delta_encode(self, gi, name, grp, bufs, dirty, dirty_bytes, logical,
                          G, n_out, lease, entry, pending) -> list[torch.Tensor] | None:
        """The incremental parity patch: ``parity ^= G·(new ⊕ old)`` over the
        merged dirty ranges, exact by GF(2^8) linearity (addition is XOR),
        so the same bytes as a full re-encode of the new members. The XOR
        runs on the host; each range's product is one ``gf_matrix_addmul_into``
        call with one column of G (one B4 launch under the ``torch``
        backend on the card). Returns None when a precondition fails (the
        caller re-encodes in full): no committed baseline in the scratch
        parity, a member without its committed payload, a changed length, a
        member with no chunk-table baseline, or a dirty fraction past the
        crossover."""
        if logical == 0 or dirty_bytes > self.cfg.delta_crossover * logical:
            return None
        if self._delta_enc.get((gi, name)) != (pending.gen - 1,) + entry:
            return None
        if any(r is None for r in dirty):
            return None
        olds = []
        for i, m in enumerate(grp.members):
            st = self.stores.get(m)
            if st is None or not st.alive or not st.buffer.valid:
                return None
            ro = st.buffer.read_only
            old = ro.own_exch.get(name, ro.own.get(name))
            if old is None or old[0].numel() != bufs[i].numel():
                return None
            olds.append(old[0])
        n = gf256.padded_len(bufs)
        blobs = [lease(b, n) for b in range(n_out)]
        if any(blob.numel() != n for blob in blobs):
            return None
        t = time.perf_counter()
        patched = n_ranges = 0
        for i, ranges in enumerate(dirty):
            col = G[:, i : i + 1]
            for lo, hi in ranges:
                diff = torch.bitwise_xor(bufs[i][lo:hi], olds[i][lo:hi])
                gf256.gf_matrix_addmul_into([blob[lo:hi] for blob in blobs], [diff], col,
                                            0, hi - lo, accumulate=True)
                patched += hi - lo
                n_ranges += 1
        if patched:
            self._observe_encode_rate(patched, time.perf_counter() - t)
        with self._delta_lock:
            pending.delta_ranges += n_ranges
        return blobs

    # -- adaptive encode-chunk planner (the restore planner's create-side twin)
    def _encode_rate(self) -> float:
        """Sustained encode rate (range bytes/s) for the codec: this
        process's peak-with-decay record, else the GF backend probe (the
        same /4 seed as the decode planner: both run the same product)."""
        with _ENCODE_RATE_LOCK:
            prior = _ENCODE_RATE.get(self.codec.name)
        if prior is not None:
            return prior
        return max(gf256.probed_gbps() * 1e9 / 4.0, 1e6)

    def _observe_encode_rate(self, nbytes: int, dt: float) -> None:
        if nbytes <= 0 or dt <= 0.0:
            return
        rate = nbytes / dt
        with _ENCODE_RATE_LOCK:
            prev = _ENCODE_RATE.get(self.codec.name)
            _ENCODE_RATE[self.codec.name] = rate if prev is None else max(rate, 0.98 * prev)

    def _plan_encode_step(self) -> int:
        """Create-side chunk size, the restore planner's rule: a fixed
        ``encode_chunk_bytes``, else the measured rate times the overhead
        budget, a power of two within the clamps; with no realizable
        parallelism one range of the ceiling."""
        cb = self.cfg.encode_chunk_bytes
        if cb > 0:
            return max(4, cb) & ~3
        if self._effective_workers() <= 1:
            return self._CHUNK_MAX
        step = int(self._encode_rate() * self._CHUNK_OVERHEAD_S / self._CHUNK_OVERHEAD_FRAC)
        step = max(self._CHUNK_MIN, min(self._CHUNK_MAX, step))
        return 1 << (step - 1).bit_length()

    def _encode_blobs_chunked(self, G, bufs, n_out, lease) -> list[torch.Tensor]:
        """One unit's blobs as planned [lo, hi) ranges of the GF matrix
        product ``rs_encode`` runs whole (per-byte math: the same bytes),
        each range's rate fed back to the planner."""
        n = gf256.padded_len(bufs)
        blobs = [lease(b, n) for b in range(n_out)]
        step = self._plan_encode_step()
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            t = time.perf_counter()
            gf256.gf_matrix_addmul_into(blobs, bufs, G, lo, hi, accumulate=False)
            self._observe_encode_rate(hi - lo, time.perf_counter() - t)
        return blobs

    def _delta_step(self) -> int:
        """Dirty-map chunk grid (4-aligned: Fletcher partials combine only
        on word boundaries; floored so tiny configs cannot explode the
        table)."""
        return max(4096, self.cfg.delta_chunk_bytes) & ~3

    def _committed_chunk_sums(self) -> dict:
        """The committed generation's replicated chunk-checksum table (empty
        for the first capture: everything dirty)."""
        for st in self.stores.values():
            if st.alive and st.buffer.valid:
                table = st.buffer.read_only.meta.get("exch_chunk_sums")
                if table:
                    return table
        return {}

    def _transfer_unit(self, unit, blobs: list[torch.Tensor], pending: _PendingCheckpoint) -> int:
        """TRANSFER stage: a striped codec's blobs are cut into stripes
        (``parity.stripe_bounds`` over the holder group's size) and each is
        copied into an arena of its holder store (blobs live in transient
        scratch). Whole copies are stored by reference (the referenced flat
        is the origin's arena view from the same staging bank, so it commits
        and retires with the rest of the snapshot).

        Under ``cfg.delta`` a stripe copies only the dirty-grid chunks that
        differ from what the holder's arena holds (the bytes the last lease
        of the same staging bank left: garbage or an older generation simply
        copies)."""
        gi, grp, placements, name = unit
        by_ref = not self._codec_for(name).striped
        step = self._delta_step()
        skipped = 0
        total = 0
        for b, (blob, holders) in enumerate(zip(blobs, placements)):
            blob = blob.reshape(-1)
            if by_ref:
                stripes = [blob] * len(holders)
            else:
                stripes = [blob[lo:hi] for lo, hi in parity_mod.stripe_bounds(blob.numel(), len(holders))]
            for j, member in enumerate(holders):
                st = self.stores[member]
                # Capture the payload reference once: a kill wipes the store
                # (swaps its buffer out); the handshake then aborts.
                payload = st.buffer.writable if st.alive else None
                if payload is None:
                    continue
                piece = stripes[j]
                if not by_ref:
                    dst = st.lease(("parity", gi, name, b, j), piece.numel())
                    if self.cfg.delta:
                        skipped += _copy_dirty(dst, piece, step)
                    else:
                        dst.copy_(piece)
                    piece = dst
                with st.lock:
                    payload.parity.setdefault(gi, {})[(name, b, j)] = piece
                total += piece.nbytes
        if skipped:
            with self._delta_lock:
                pending.skipped_bytes += skipped
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
        """Drain the pipeline (or join the background worker), handshake, and
        **commit via the pointer swap** — the single commit point. Returns
        True on success, False on abort, None if nothing is pending. An error
        other than a fault (a bug, a failed pinning) propagates."""
        if self._pending is None:
            return None
        pending = self._pending
        self._pending = None
        eng, gen = self._obs_id, pending.gen
        t_wait0 = time.perf_counter()
        try:
            with _TR.span("finalize_wait", eng=eng, gen=gen):
                if pending.future is not None:
                    pending.bytes_exchanged, pending.verified = pending.future.result()
                else:
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
            # the drain may have overwritten scratch with the aborted
            # generation's parity: no committed baseline survives it
            self._delta_enc.clear()
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
        if self.cfg.delta:
            # the scratch arenas now hold THIS generation's parity: the staged
            # validity entries become the next capture's baseline
            self._delta_enc.update(pending.delta_enc)
            self.stats.last_dirty_fraction = (
                pending.dirty_bytes / pending.logical_bytes if pending.logical_bytes else 0.0)
            self.stats.last_transfer_bytes_skipped = pending.skipped_bytes
            self.stats.last_delta_ranges = pending.delta_ranges
        self._maybe_flush_tiers()
        # after the swap, so a hook (the adaptive policy) can never tear a
        # snapshot; its overrides apply from the next capture
        for hook in self._commit_hooks:
            hook(self)
        return True

    # ------------------------------------------------------------------ #
    # the storage-tier ladder: background flush of committed generations
    # ------------------------------------------------------------------ #
    @property
    def persistent_tiers(self) -> list:
        return [t for t in self.tiers if t.persistent]

    def _maybe_flush_tiers(self) -> None:
        """Stage a flush of the just-committed generation for every due
        persistent tier. The payload references are captured here, at the
        commit point, so neither a kill nor the next capture's arena
        re-lease can tear the flush's source bytes; the submission waits for
        ``kick_tier_flush`` (the next ``drain_done`` poll, the next capture,
        or any join point), so not even the worker's wake-up lands on the
        blocked path. At most one flush runs, plus one queued in the single
        slot: a cadence point arriving while a flush runs is chained behind
        it (``tier_flush_queued``), and only when the slot is taken is the
        older staged snapshot dropped for the newer one
        (``tier_flush_skipped``): back-pressure lowers the disk frequency,
        it never blocks training."""
        due = [t for t in self.persistent_tiers if t.due(self.stats.created)]
        if not due:
            return
        with self._flush_lock:
            in_flight = self._flush_future is not None and not self._flush_future.done()
            if self._flush_pending is not None:
                # the queue slot is taken: drop the OLDER staged snapshot
                old_due, old_snap = self._flush_pending
                self.stats.tier_flush_skipped += len(old_due)
                self.journal.record("flush_skipped", gen=old_snap.created, superseded_by=self.stats.created)
                log.warning("tier flush of commit %d dropped: superseded by commit %d while a flush is "
                            "still in flight", old_snap.created, self.stats.created)
            self._flush_pending = (due, storage_mod.capture_snapshot(self))
            if in_flight:
                self.stats.tier_flush_queued += len(due)
                self.journal.record("flush_queued", gen=self.stats.created, tiers=",".join(t.name for t in due))

    def kick_tier_flush(self) -> None:
        """Submit a staged tier flush to the worker pool: the overlap-window
        probe callers (the trainer's step loop, ``drain_done``) invoke
        between the commit and the next blocked window. Every join point
        kicks first, so a staged generation is never lost. While a flush
        runs the staged one stays queued; the worker chains it."""
        with self._flush_lock:
            if self._flush_pending is None:
                return
            if self._flush_future is not None:
                if not self._flush_future.done():
                    return  # stays queued: the flush worker chains it
                self._reap_flush_future()
            submit, self._flush_pending = self._flush_pending, None
            self._flush_created = submit[1].created
        self._flush_future = self._executor().submit(self._run_flush, *submit)

    def _reap_flush_future(self) -> None:
        """Clear a finished flush future, logging (never raising) a failure:
        losing one disk generation must not kill the job; the previous
        generation stays valid by the commit protocol."""
        future, self._flush_future = self._flush_future, None
        if future is not None:
            try:
                future.result()
            except Exception as e:  # noqa: BLE001 - a failed flush is not fatal
                log.warning("tier flush failed (previous generation intact): %s", e)

    def _run_flush(self, tiers: list, snap) -> int:
        """Flush worker: write one staged generation to every due tier, then
        chain any flush queued behind it (under the lock, so the hand-off
        races neither ``kick_tier_flush`` nor a new staging)."""
        grand_total = 0
        while True:
            t0 = time.perf_counter()
            total = 0
            try:
                for tier in tiers:
                    with _TR.span("flush", eng=self._obs_id, gen=snap.created, tier=tier.name):
                        total += tier.flush(snap)
            except Exception as e:
                self.journal.record("flush", ok=False, gen=snap.created, cause=str(e))
                raise
            self.stats.tier_flushes += len(tiers)
            self.stats.last_flush_s = time.perf_counter() - t0
            self.stats.last_flush_bytes = total
            dedup = next((t.last_dedup for t in tiers if getattr(t, "last_dedup", None)), None)
            if dedup is not None:
                self.stats.last_flush_chunks_written = dedup["chunks_written"]
                self.stats.last_flush_chunks_reused = dedup["chunks_reused"]
                self.stats.last_dedup_ratio = (
                    dedup["stored_bytes"] / dedup["logical_bytes"] if dedup["logical_bytes"] else 0.0)
            self.journal.record("flush", ok=True, gen=snap.created, bytes=total,
                                duration_s=self.stats.last_flush_s, n_ranks=snap.n_ranks,
                                tiers=",".join(t.name for t in tiers))
            grand_total += total
            with self._flush_lock:
                if self._flush_pending is None:
                    return grand_total
                (tiers, snap), self._flush_pending = self._flush_pending, None
                self._flush_created = snap.created

    def _join_flush(self) -> None:
        """Kick any staged flush, then join (and clear) the running one,
        looping, since the worker may chain a flush queued after its last
        hand-off check. Returns with no flush staged, queued or running."""
        while True:
            self.kick_tier_flush()
            if self._flush_future is None:
                with self._flush_lock:
                    if self._flush_pending is None:
                        return
                continue  # a late staging slipped in: kick it too
            self._reap_flush_future()

    def has_tier_data(self) -> bool:
        """True when some persistent tier holds a committed generation (or
        one is staged or being flushed: escalation joins it first)."""
        if self._flush_pending is not None or self._flush_future is not None:
            return True
        return any(t.has_data() for t in self.persistent_tiers)

    def _store_alive(self) -> set[int]:
        """Liveness as the stores see it (after a tier load, when the
        cluster's view predates the rehydration)."""
        return {r for r, s in self.stores.items() if s.alive and s.buffer.valid}

    def escalate_from_tiers(self) -> None:
        """Load the newest valid persistent-tier generation into the
        in-memory stores (a cold start, or a burst beyond the codec's
        tolerance). Tiers are tried in ladder order; each falls back to
        older generations when its newest fails validation. Raises
        ``distribution.DataLostError`` when no rung holds a loadable
        generation. May resize the engine to the stored world size: the
        elastic path maps it back onto the caller's world."""
        self._join_flush()  # a running flush may be committing the newest generation
        # the loaded payloads replace the committed ones: the scratch parity
        # no longer matches them
        self._delta_enc.clear()
        errors: list[str] = []
        for tier in self.persistent_tiers:
            try:
                t0 = time.perf_counter()
                with _TR.span("escalate", eng=self._obs_id, tier=tier.name):
                    gen = tier.load(self)
            except dist.DataLostError as e:
                errors.append(str(e))
                continue
            self._restore_plan_cache = None  # its units hold the replaced payloads
            self.stats.tier_escalations += 1
            self.journal.record("escalation", tier=tier.name, gen=gen, n_ranks=self.n_ranks,
                                duration_s=time.perf_counter() - t0)
            log.warning("recovery escalated to the %s tier (generation %s, %d ranks)",
                        tier.name, gen, self.n_ranks)
            return
        raise dist.DataLostError("no persistent tier holds a loadable generation"
                                 + (f": {'; '.join(errors)}" if errors else " (none configured)"))

    def discard_pending(self) -> None:
        """Drop an un-finalized snapshot (e.g. before a restore): it counts as
        an aborted checkpoint (captured but never committed). Joins a
        still-running background drain first, so no worker writes into
        buffers after they are discarded."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            if pending.future is not None:
                try:
                    pending.future.result()
                except FaultDuringCheckpoint:
                    pass
            for s in self.stores.values():
                s.buffer.discard_writable()
            self._delta_enc.clear()  # the discarded drain may have left its parity in scratch
            self.stats.aborted += 1

    def drain_done(self) -> bool:
        """True when ``finalize_async`` would not block on a worker: nothing
        pending, a background drain already finished, or a drain that
        ``finalize_async`` runs itself. A poll point, so it also kicks a
        staged tier flush."""
        self.kick_tier_flush()
        pending = self._pending
        if pending is None or pending.future is None:
            return True
        return pending.future.done()

    def close(self) -> None:
        """Join and drop any pending snapshot and any tier flush, and shut
        the worker pool down. The engine stays usable (the pool is made
        again when needed)."""
        self.discard_pending()
        self._join_flush()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _groups(self) -> list[dist.ParityGroup]:
        """The group layout: contiguous in rank order without a topology;
        with one, domain-aware (no group holds two members of one failure
        domain), cached per (world, k, labels, placement level)."""
        k = self.codec.group_size(self.n_ranks)
        if self.topology is None:
            return dist.parity_groups(self.n_ranks, k)
        key = (self.n_ranks, k, self.topology.labels, self.topology.placement_level)
        if self._groups_cache is None or self._groups_cache[0] != key:
            groups = dist.domain_parity_groups(self.n_ranks, k, self.topology)
            self._groups_cache = (key, groups, dist.rank_group_map(groups))
        return self._groups_cache[1]

    def _group_of(self, rank: int) -> int:
        if self.topology is None:
            return dist.group_of(rank, self.codec.group_size(self.n_ranks))
        self._groups()
        return self._groups_cache[2][rank]

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
            recovered = self._recover_all(alive, failed)
            for name, ent in self._entities.items():
                ent.restore_shards(recovered[name])
        meta = self.checkpoint_step()
        self.stats.restored += 1
        self.stats.last_restore_s = time.perf_counter() - t0
        # the failure set's domain labels: fit_failure_stats clusters
        # recoveries by rack or pod, the signal the adaptive policy reads
        domains = (",".join(sorted({self.topology.domain_label(r) for r in failed}))
                   if self.topology is not None and failed else "")
        self.journal.record(
            "recovery", mode=self.cfg.restore_mode, failed=len(failed),
            n_ranks=self.n_ranks, duration_s=self.stats.last_restore_s,
            bytes_rebuilt=self.stats.last_restore_bytes_rebuilt, escalations=self.stats.tier_escalations,
            step=meta.get("step") if isinstance(meta, dict) else None,
            domains=domains,
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

        With nothing in memory and a persistent tier holding data, the stores
        are rehydrated from the newest valid generation first (the engine
        resizes to its N), then repartitioned onto ``new_n_ranks``: the cold
        N-to-M restart, with B6 reading the loaded origin shards in place.
        """
        if new_n_ranks < 1:
            raise ValueError(f"new_n_ranks must be >= 1, got {new_n_ranks}")
        self.discard_pending()
        t0 = time.perf_counter()
        if not self.has_valid_checkpoint and self.has_tier_data():
            # cold N-to-M restart: rehydrate the stored world first
            self.escalate_from_tiers()
            alive = self._store_alive()
        else:
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
            recovered = self._recover_all(alive, failed)  # pipelined or sync
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
        self.stores = self._new_stores(new_n_ranks)
        self._restore_plan_cache = None  # its units hold the old world's copies
        self._delta_enc.clear()  # scratch parity belongs to the old world
        if self.topology is not None:
            # the domain map resizes with the world; _groups re-packs it
            self.topology = self.topology.resized(new_n_ranks)
            self._groups_cache = None
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

    def _recover_all(self, alive: set[int], failed: set[int]) -> dict[str, dict[int, Any]]:
        """Recover every entity's every shard without mutating an entity,
        escalating down the tier ladder: the in-memory codec path first
        (failures within tolerance never touch disk), and only when it
        cannot succeed (``DataLostError``: a burst beyond ``m``, lost blob
        holders, or a cold start with nothing in memory) are the stores
        rehydrated from the newest valid generation and recovery run again
        against the loaded world (every rank a survivor, but for ranks the
        generation itself lacked, which the codec rebuilds)."""
        try:
            return self._recover_all_memory(alive, failed)
        except dist.DataLostError as e:
            if not self.has_tier_data():
                raise
            log.warning("in-memory recovery impossible (%s); escalating down the storage-tier ladder", e)
            self.escalate_from_tiers()
            alive = self._store_alive()
            return self._recover_all_memory(alive, set(range(self.n_ranks)) - alive)

    def _recover_all_memory(self, alive: set[int], failed: set[int]) -> dict[str, dict[int, Any]]:
        """One recovery attempt against the in-memory stores: the
        restore-mode dispatch shared by ``restore`` and ``restore_elastic``.
        Under the adaptive planner a payload below the crossover takes the
        serial sync path, whose fixed cost is lower (the same bytes either
        way). The ``torch`` GF backend runs on the engine's device here."""
        with gf256.compute_device(self.device):
            if self.cfg.restore_mode == "sync" or (
                self.cfg.restore_chunk_bytes <= 0
                and self._estimate_restore_bytes() <= self._sync_crossover_bytes()
            ):
                return {name: self._recover_entity_shards(name, ent, alive, failed)
                        for name, ent in self._entities.items()}
            return self._recover_all_pipelined(alive, failed)

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
        # decode adopts any surviving whole copy (communication!); a striped
        # blob is joined from its stripes.
        groups = self._groups()
        gi = self._group_of(origin)
        grp = groups[gi]
        codec = self._restore_codec(name)  # the codec that encoded, from the payload's record

        def _has_data(m: int) -> bool:
            st = self.stores.get(m)
            return st is not None and st.alive and st.buffer.valid

        rebuilt_map = decode_cache.get(gi) if decode_cache is not None else None
        if rebuilt_map is None:
            # Missing = dead ranks AND alive-but-empty ones (revived spares).
            missing_idx = [i for i, m in enumerate(grp.members) if not _has_data(m)]
            if len(missing_idx) > codec.tolerance():
                raise dist.DataLostError(
                    f"group {gi} lost {len(missing_idx)} members; "
                    f"codec {codec.name!r} tolerates {codec.tolerance()}"
                )
            stripe_sets: dict[int, list[torch.Tensor]] = {}
            for b, holders in enumerate(codec.placement(groups, gi, self.n_ranks)):
                stripes = [
                    self.stores[member].buffer.read_only.parity.get(gi, {}).get((name, b, j))
                    if _has_data(member) else None
                    for j, member in enumerate(holders)
                ]
                if all(s is not None for s in stripes):  # any lost stripe kills the blob
                    stripe_sets[b] = stripes
            present = {}
            for i, m in enumerate(grp.members):
                if i not in missing_idx:
                    ro = self.stores[m].buffer.read_only
                    present[i] = ro.own_exch.get(name, ro.own[name])[0]
            # join only the blobs the codec's row selection reads (None: all)
            needed = codec.blobs_needed(sorted(present), sorted(stripe_sets), missing_idx)
            if needed is not None:
                stripe_sets = {b: st for b, st in stripe_sets.items() if b in needed}
            # a single-stripe blob (a whole copy) is adopted by reference
            blobs = {b: st[0] if len(st) == 1 else parity_mod.join_stripes(st) for b, st in stripe_sets.items()}
            try:
                rebuilt_map = codec.decode(present, blobs, missing_idx)
            except codec_mod.CodecDecodeError as e:
                raise dist.DataLostError(
                    f"rank {origin} (group {gi}) unrecoverable under codec "
                    f"{codec.name!r}, entity {name!r}: {e}"
                ) from e
            if decode_cache is not None:
                decode_cache[gi] = rebuilt_map
        rebuilt = rebuilt_map[grp.members.index(origin)].reshape(-1)
        if codec.striped:
            self.stats.reconstructed_restores += 1
        else:
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

    # ------------------------------------------------------------------ #
    # the pipelined restore: plan, then drain TRANSFER i ‖ DECODE i−1 ‖
    # VERIFY i−2 (+ DEQ) per (group, entity) unit, units and chunks in
    # parallel across the worker pool
    # ------------------------------------------------------------------ #
    def _recover_all_pipelined(self, alive: set[int], failed: set[int]) -> dict[str, dict[int, Any]]:
        t0 = time.perf_counter()
        groups = self._groups()
        shards: dict[str, dict[int, Any]] = {n: {} for n in self._entities}
        partials: dict[str, dict[int, Any]] = {n: {} for n in self._entities}

        # -- plan: survivor unpacks are local jobs, each failed origin's
        # (group, entity) one reconstruction unit
        local_jobs: list[tuple[str, int, Any, Any]] = []  # (name, origin, flat, man)
        units: list[_RestoreUnit] = []
        seen_units: set[tuple[int, str]] = set()
        ref_table = self._restore_ref_sums()
        # Committed copies are immutable: a repeat restore of the same
        # topology (survivors, failures, store generations) reuses the
        # prepped units. The store epochs guard against a wiped and revived
        # store whose generation count restarted.
        plan_key = (
            frozenset(alive), frozenset(failed),
            tuple((r, st.epoch, st.buffer.generation) for r, st in sorted(self.stores.items())
                  if st.alive and st.buffer.valid),
        )
        cached = (self._restore_plan_cache[1]
                  if self._restore_plan_cache and self._restore_plan_cache[0] == plan_key else None)
        for name in self._entities:
            if name in self._replicated:
                donor = next((r for r in sorted(alive) if self.stores[r].buffer.valid), None)
                if donor is None:
                    raise dist.DataLostError(f"replicated entity {name!r} lost everywhere")
                flat, man = self.stores[donor].buffer.read_only.own[name]
                local_jobs.append((name, -1, flat, man))  # -1: fan out to all
                self.stats.zero_comm_restores += self.n_ranks
                continue
            for origin in range(self.n_ranks):
                if origin in alive and self.stores[origin].buffer.valid:
                    flat, man = self.stores[origin].buffer.read_only.own[name]
                    local_jobs.append((name, origin, flat, man))
                    self.stats.zero_comm_restores += 1
                    continue
                gi = self._group_of(origin)
                if (gi, name) in seen_units:
                    continue
                seen_units.add((gi, name))
                u = cached.get((gi, name)) if cached else None
                if u is not None:
                    self.stats.restore_plan_reuses += 1
                else:
                    u = self._prep_restore_unit(gi, groups, name, alive, ref_table)
                units.append(u)

        # -- drain: chunk tasks and survivor unpacks across the worker pool
        chunk_tasks = [(u, ci) for u in units for ci in range(len(u.bounds))]
        results: dict[tuple[str, int], Any] = {}
        workers = max(1, min(self.cfg.async_workers, len(chunk_tasks) + len(local_jobs)))
        if self.cfg.restore_chunk_bytes <= 0:
            workers = min(workers, self._effective_workers())
        if workers > 1:
            futures = [self._executor().submit(self._restore_chunk_task, u, ci) for u, ci in chunk_tasks]
            futures += [self._executor().submit(unpack_bytes, flat, man, self.device)
                        for _, _, flat, man in local_jobs]
            # Join EVERY future before raising (as in the create drain): an
            # abandoned task would keep writing into buffers a retry reuses.
            err: BaseException | None = None
            for f, task in zip(futures, chunk_tasks + local_jobs):
                try:
                    out = f.result()
                    if len(task) == 4:  # a local unpack
                        results[(task[0], task[1])] = out
                except BaseException as e:
                    err = err or e
            if err is not None:
                raise err
        else:
            # Serial drain: the literal pipeline per unit, then the local
            # unpacks, in a fixed chunk order (the mid-restore kill tests'
            # form).
            for u in units:
                nc = len(u.bounds)
                for i in range(nc + 2):
                    if i < nc:
                        self._restore_stage(u, i, "r_transfer")
                    if 0 <= i - 1 < nc:
                        self._restore_stage(u, i - 1, "decode")
                    if 0 <= i - 2 < nc:
                        self._restore_stage(u, i - 2, "r_verify")
                        self._restore_stage(u, i - 2, "deq")
                    self._fault_hook("restore_chunk")
            for name, origin, flat, man in local_jobs:
                results[(name, origin)] = unpack_bytes(flat, man, device=self.device)

        # -- finalize: checksum verdicts, unpack rebuilt shards, merge
        for name, origin, _, _ in local_jobs:
            payload = results[(name, origin)]
            if origin < 0:
                shards[name] = {r: payload for r in range(self.n_ranks)}
            else:
                shards[name][origin] = payload
        for u in units:
            self._finalize_restore_unit(u, shards, partials)
        for name, ent in self._entities.items():
            if name in self._replicated:
                continue
            if not shards[name]:
                raise dist.DataLostError(f"no shard of entity {name!r} recoverable")
            if partials[name]:
                ref = shards[name][min(shards[name])]
                for origin, subset in partials[name].items():
                    shards[name][origin] = ent.merge_payload(subset, ref, self.n_ranks)

        self.stats.last_restore_decode_s = time.perf_counter() - t0
        self.stats.last_restore_chunks = len(chunk_tasks)
        self.stats.last_restore_bytes_rebuilt = sum(b.numel() for u in units for b in u.rebuilt.values())
        self.stats.last_restore_decompressed_bytes = sum(
            4 * leaf.out.numel() for u in units if u.decomp for plan in u.decomp.values() for leaf in plan)
        # every unit finalized clean: admit the plan to the one-slot cache
        for u in units:
            u.staged = u.verified = True
        self._restore_plan_cache = (plan_key, {(u.gi, u.name): u for u in units})
        return shards

    # -- adaptive restore-chunk planner ----------------------------------- #
    # Fixed per-chunk overhead and the share of a chunk's time it may take:
    # together they set the chunk floor, step >= rate * OVERHEAD_S / FRAC.
    _CHUNK_OVERHEAD_S = 5e-5
    _CHUNK_OVERHEAD_FRAC = 0.05
    _CHUNK_MIN = 1 << 16
    _CHUNK_MAX = 1 << 24
    # the pipelined path's fixed setup; restores that decode faster than
    # this are cheaper on the serial sync path
    _PIPELINE_SETUP_S = 1e-4

    def _effective_workers(self) -> int:
        """Parallelism the restore drain can realize: min(workers, cores)."""
        return max(1, min(self.cfg.async_workers, os.cpu_count() or 1))

    def _decode_rate(self) -> float:
        """Sustained chunk-decode rate (range bytes/s) for the codec: this
        process's peak-with-decay record, else the GF backend probe
        (``probed_gbps`` measures k=4 sources' bytes per second, so /4 is
        the per-range rate)."""
        with _DECODE_RATE_LOCK:
            prior = _DECODE_RATE.get(self.codec.name)
        if prior is not None:
            return prior
        return max(gf256.probed_gbps() * 1e9 / 4.0, 1e6)

    def _observe_decode_rate(self, nbytes: int, dt: float) -> None:
        if nbytes <= 0 or dt <= 0.0:
            return
        rate = nbytes / dt
        self._h_restore_rate.observe(rate, codec=self.codec.name)
        with _DECODE_RATE_LOCK:
            prev = _DECODE_RATE.get(self.codec.name)
            # peak with slow decay: immune to one-off slow chunks
            _DECODE_RATE[self.codec.name] = rate if prev is None else max(rate, 0.98 * prev)

    def _plan_chunk_step(self) -> int:
        """Adaptive chunk size: fixed per-chunk overhead under
        ``_CHUNK_OVERHEAD_FRAC`` of decode time at the measured rate,
        rounded up to a power of two; with no realizable parallelism,
        chunking is pure overhead and the step is the ceiling."""
        if self._effective_workers() <= 1:
            return self._CHUNK_MAX
        step = int(self._decode_rate() * self._CHUNK_OVERHEAD_S / self._CHUNK_OVERHEAD_FRAC)
        step = max(self._CHUNK_MIN, min(self._CHUNK_MAX, step))
        return 1 << (step - 1).bit_length()

    def _sync_crossover_bytes(self) -> int:
        """Payload below which the pipelined setup cannot pay for itself."""
        est = int(self._decode_rate() * self._PIPELINE_SETUP_S)
        return max(1 << 14, min(1 << 18, est))

    def _estimate_restore_bytes(self) -> int:
        """One valid survivor's own bytes times the world size."""
        donor = next((st for st in self.stores.values() if st.alive and st.buffer.valid), None)
        if donor is None:
            return 1 << 62  # nothing valid: the pipelined path raises DataLostError
        per_rank = sum(flat.numel() for flat, _ in donor.buffer.read_only.own.values())
        return per_rank * max(1, self.n_ranks)

    def _prep_restore_unit(self, gi: int, groups: list, name: str, alive: set[int],
                           ref_table: dict) -> _RestoreUnit:
        """Capture what one unit's chunks need: references to the surviving
        copies (a rank dying mid-restore cannot pull bytes from under the
        drain), blob arenas on the recovering host, the codec's chunk
        decoder, the chunk grid, and the DEQ plan of compressed origins. The
        codec is the one the payload's codec record names."""
        codec = self._restore_codec(name)
        grp = groups[gi]

        def _has_data(m: int) -> bool:
            st = self.stores.get(m)
            return st is not None and st.alive and st.buffer.valid

        missing_idx = [i for i, m in enumerate(grp.members) if not _has_data(m)]
        if len(missing_idx) > codec.tolerance():
            raise dist.DataLostError(f"group {gi} lost {len(missing_idx)} members; "
                                     f"codec {codec.name!r} tolerates {codec.tolerance()}")
        first_missing = grp.members[missing_idx[0]]
        stripe_srcs: dict[int, list[torch.Tensor]] = {}
        for b, holders in enumerate(codec.placement(groups, gi, self.n_ranks)):
            stripes: list[torch.Tensor] | None = []
            for j, member in enumerate(holders):
                stripe = (self.stores[member].buffer.read_only.parity.get(gi, {}).get((name, b, j))
                          if _has_data(member) else None)
                if stripe is None:
                    stripes = None  # any lost stripe kills the whole blob
                    break
                stripes.append(stripe)
            if stripes is not None:
                stripe_srcs[b] = stripes
        present = {}
        for i, m in enumerate(grp.members):
            if i not in missing_idx:
                ro = self.stores[m].buffer.read_only
                present[i] = ro.own_exch.get(name, ro.own[name])[0]
        # repair locality: the blobs the codec's decode will not read are
        # neither leased nor transferred (an LRC single loss moves one local
        # parity)
        needed = codec.blobs_needed(sorted(present), sorted(stripe_srcs), missing_idx)
        if needed is not None:
            stripe_srcs = {b: s for b, s in stripe_srcs.items() if b in needed}

        # blob arenas live in the recovering host's staging bank (never the
        # read-only one); a single-stripe blob is adopted by reference
        host = codec.rebuilder(groups, gi, first_missing, alive)
        store = self.stores.get(host) if host is not None else None
        if store is None or not store.alive:
            cand = [r for r in alive if self.stores[r].alive]
            if not cand:
                raise dist.DataLostError(f"no surviving rank can rebuild rank {first_missing}")
            store = self.stores[min(cand)]
        blobs: dict[int, torch.Tensor] = {}
        for b, stripes in stripe_srcs.items():
            if len(stripes) == 1:
                blobs[b] = stripes[0].reshape(-1)
            else:
                blobs[b] = store.lease(("restore", gi, name, "blob", b), sum(s.numel() for s in stripes))
        multi = {b: s for b, s in stripe_srcs.items() if len(s) > 1}
        if multi and not codec.decode_chunked():
            # a codec that decodes eagerly inside decode_into reads its blobs
            # now: join them up front (TRANSFER then has nothing to copy)
            for b, stripes in multi.items():
                blobs[b].copy_(parity_mod.join_stripes(stripes))
            multi = {}
        try:
            rebuilt, decode_chunk = codec.decode_into(
                present, blobs, missing_idx, lambda i, nb: store.lease(("restore", gi, name, "out", i), nb))
        except codec_mod.CodecDecodeError as e:
            raise dist.DataLostError(f"rank {first_missing} (group {gi}) unrecoverable under codec "
                                     f"{codec.name!r}, entity {name!r}: {e}") from e

        n = max((bb.numel() for bb in blobs.values()), default=0)
        cb = self.cfg.restore_chunk_bytes
        step = self._plan_chunk_step() if cb <= 0 else max(4, cb) & ~3
        bounds = [(lo, min(lo + step, n)) for lo in range(0, n, step)] or [(0, 0)]
        manifests = {i: self._redundancy_manifest(grp.members[i], name) for i in missing_idx}
        ref_sums: dict[int, Any] = {}
        decomp: dict[int, list] = {}
        for i in missing_idx:
            compressed = isinstance(manifests[i], tuple) and manifests[i][0] == "compressed"
            ref_sums[i] = None if compressed else ref_table.get((grp.members[i], name))
            if compressed and not codec.striped:
                # the whole compressed copy is adopted at prep, so its scales
                # are readable now; the int8 -> f32 expansion streams through
                # the drain's DEQ stage, chunk by chunk
                plan = self._prep_decomp_plan(manifests[i][1], rebuilt[i].reshape(-1))
                if plan:
                    decomp[i] = plan
        return _RestoreUnit(gi=gi, grp=grp, name=name, missing_idx=missing_idx, stripe_srcs=multi,
                            blobs=blobs, rebuilt=rebuilt, decode_chunk=decode_chunk, bounds=bounds,
                            manifests=manifests, ref_sums=ref_sums,
                            sums={i: [None] * len(bounds) for i in missing_idx}, decomp=decomp or None)

    def _prep_decomp_plan(self, cman: Manifest, flat: torch.Tensor) -> list[_DeqLeaf]:
        """One ``_DeqLeaf`` per quantized leaf (``_q``/``_scale`` pairs in the
        packed manifest), its scales and f32 destination on the engine's
        device; empty (the monolithic decompress then runs) if any pair is
        unresolvable."""
        plan: list[_DeqLeaf] = []
        by_name = {n: k for k, n in enumerate(cman.names)}
        for k, n in enumerate(cman.names):
            if not n.endswith("_q") or cman.dtypes[k] != "int8":
                continue
            sk = by_name.get(n[: -len("_q")] + "_scale")
            if sk is None or cman.dtypes[sk] != "float32":
                return []
            q_n = int(torch.Size(cman.shapes[k]).numel())
            s_off, s_n = cman.offsets[sk], int(torch.Size(cman.shapes[sk]).numel())
            scales = flat[s_off : s_off + 4 * s_n].clone().view(torch.float32).to(self.device)
            plan.append(_DeqLeaf(q_off=cman.offsets[k], q_n=q_n, block=q_n // max(s_n, 1), scales=scales,
                                 out=torch.empty(q_n, dtype=torch.float32, device=self.device)))
        return plan

    def _restore_ref_sums(self) -> dict:
        """The replicated capture-time exchange checksums."""
        for st in self.stores.values():
            if st.alive and st.buffer.valid:
                table = st.buffer.read_only.meta.get("exch_checksums")
                if table:
                    return table
        return {}

    def _restore_stage(self, u: _RestoreUnit, ci: int, phase: str) -> None:
        """One stage of one chunk, timed into ``restore_stage_seconds`` (and
        a span while the tracer is on); DECODE also feeds the planner's
        rate."""
        lo, hi = u.bounds[ci]
        fn, hist = {
            "r_transfer": (lambda: self._restore_transfer_chunk(u, lo, hi), self._hr_transfer),
            "decode": (lambda: u.decode_chunk(lo, hi), self._hr_decode),
            "r_verify": (lambda: self._restore_verify_chunk(u, ci), self._hr_verify),
            "deq": (lambda: self._restore_decompress_chunk(u, ci), self._hr_deq),
        }[phase]
        t = time.perf_counter()
        if _TR.enabled:
            with _TR.span(phase, eng=self._obs_id, group=u.gi, entity=u.name, chunk=ci):
                fn()
        else:
            fn()
        dt = time.perf_counter() - t
        hist.observe(dt)
        if phase == "decode":
            self._observe_decode_rate(hi - lo, dt)

    def _restore_chunk_task(self, u: _RestoreUnit, ci: int) -> None:
        """The parallel drain's form of one chunk: its own TRANSFER, DECODE,
        VERIFY and DEQ on the worker's own stream (chunks are range-disjoint,
        so any interleaving gives the serial pipeline's bytes)."""
        with self._worker_stream() as stream:
            for phase in ("r_transfer", "decode", "r_verify", "deq"):
                self._restore_stage(u, ci, phase)
            if stream is not None:
                stream.synchronize()  # the caller reads the DEQ outputs on its own stream
        self._fault_hook("restore_chunk")

    def _restore_transfer_chunk(self, u: _RestoreUnit, lo: int, hi: int) -> None:
        """TRANSFER: copy the stripe segments covering [lo, hi) into the blob
        arenas (nothing to move for adopted whole copies, or on a plan-cache
        hit, whose arenas hold these immutable committed bytes already)."""
        if u.staged:
            return
        for b, stripes in u.stripe_srcs.items():
            dst, off = u.blobs[b], 0
            for s in stripes:
                s = s.reshape(-1)
                a, z = max(lo, off), min(hi, off + s.numel())
                if a < z:
                    dst[a:z].copy_(s[a - off : z - off])
                off += s.numel()

    def _restore_decompress_chunk(self, u: _RestoreUnit, ci: int) -> None:
        """DEQ: this chunk's slice of every compressed origin's int8 codes,
        dequantized on the engine's device by ``dequantize_into`` (B5b on the
        card) over the whole blocks that cover it; only the slice is written,
        so chunks write disjoint ranges. The same ``codes · scale`` in f32 as
        the monolithic decompress, so the same bytes."""
        if not u.decomp:
            return
        lo, hi = u.bounds[ci]
        for i, plan in u.decomp.items():
            flat = u.rebuilt[i].reshape(-1)
            for leaf in plan:
                a, z = max(lo, leaf.q_off), min(hi, leaf.q_off + leaf.q_n)
                if a >= z:
                    continue
                e0, e1 = a - leaf.q_off, z - leaf.q_off
                b0, b1 = e0 // leaf.block, -(-e1 // leaf.block)
                codes = flat[leaf.q_off + b0 * leaf.block : leaf.q_off + b1 * leaf.block]
                codes = codes.view(torch.int8).to(self.device)
                out = torch.empty(codes.numel(), dtype=torch.float32, device=self.device)
                qk.dequantize_into(codes, leaf.scales[b0:b1], out)
                leaf.out[e0:e1] = out[e0 - b0 * leaf.block : e1 - b0 * leaf.block]

    def _restore_verify_chunk(self, u: _RestoreUnit, ci: int) -> None:
        """VERIFY: Fletcher partials of the rebuilt chunk; both sums are
        linear, so partials at word offset *o* recombine to the monolithic
        ``np_checksum``. A plan-cache hit carries its clean partials."""
        if u.verified:
            return
        lo, hi = u.bounds[ci]
        for i in u.missing_idx:
            if u.ref_sums[i] is None:
                continue
            end = min(hi, u.manifests[i].total)
            if lo < end:
                c1, c2 = np_checksum(u.rebuilt[i].reshape(-1)[lo:end].numpy())
                u.sums[i][ci] = (lo // 4, c1, c2)

    def _finalize_restore_unit(self, u: _RestoreUnit, shards: dict, partials: dict) -> None:
        """Checksum verdict and unpack of every rebuilt origin in the unit."""
        has_subset = hasattr(self._entities[u.name], "partner_payload")
        for i in u.missing_idx:
            origin = u.grp.members[i]
            ref = u.ref_sums[i]
            if ref is not None:
                s1 = s2 = 0
                for part in u.sums[i]:
                    if part is None:
                        continue
                    o, c1, c2 = part
                    s1 = (s1 + c1) & 0xFFFFFFFF
                    s2 = (s2 + c2 + o * c1) & 0xFFFFFFFF
                if (s1, s2) != tuple(ref):
                    raise IntegrityError(f"reconstructed shard failed checksum validation: "
                                         f"rank {origin} entity {u.name!r} (group {u.gi})")
            if self._restore_codec(u.name).striped:
                self.stats.reconstructed_restores += 1
            else:
                self.stats.adopted_restores += 1
            man = u.manifests[i]
            rebuilt = u.rebuilt[i].reshape(-1)
            if isinstance(man, tuple) and man[0] == "compressed":
                if u.decomp and i in u.decomp:
                    payload = self._finalize_decompressed(rebuilt, man[1], u.decomp[i])
                else:
                    payload = self._decompress(rebuilt, man)
            else:
                payload = unpack_bytes(rebuilt[: man.total], man, device=self.device)
            (partials if has_subset else shards)[u.name][origin] = payload

    def _finalize_decompressed(self, flat: torch.Tensor, cman: Manifest, plan: list[_DeqLeaf]) -> Any:
        """A compressed origin's payload from the DEQ stage's outputs:
        ``decompress_tree``'s walk, each packed node taking its dequantized
        leaf (cast to its recorded dtype and shape); the other leaves are
        copied out of the arena onto the engine's device."""
        it = iter(plan)

        def assemble(x: Any) -> torch.Tensor:
            if not _is_packed(x):
                return x.to(self.device, copy=True)
            meta = [int(v) for v in x["_meta"].reshape(-1).tolist()]
            shape, dtype, size = tuple(meta[:-2]), _DTYPES[meta[-2]], meta[-1]
            return next(it).out[:size].reshape(shape).to(dtype_from_name(dtype))

        return _map(assemble, arena_views(flat, cman), _is_packed)

    # ------------------------------------------------------------------ #
    # memory accounting (paper eq. 2)
    # ------------------------------------------------------------------ #
    def memory_report(self) -> dict[str, Any]:
        """Eq.-2-style accounting, itemized per redundancy kind: ``by_kind[r]``
        splits each rank's bytes into own snapshots, exchange subsets and
        redundancy (copies, xor stripes, rs or lrc blobs), and
        ``redundancy_bytes`` totals the latter under the engine's codec."""
        per_rank = {r: s.nbytes for r, s in self.stores.items() if s.alive}
        by_kind = {r: s.nbytes_by_kind() for r, s in self.stores.items() if s.alive}
        group = self.codec.group_size(self.n_ranks)
        return {
            "bytes_per_rank": per_rank,
            "by_kind": by_kind,
            "total_bytes": sum(per_rank.values()),
            "n_ranks": self.n_ranks,
            "codec": self.codec.name,
            "tolerance": self.codec.tolerance(),
            "redundancy_bytes": {self.codec.name: sum(k["redundancy"] for k in by_kind.values())},
            "exchange_bytes": sum(k["exchange"] for k in by_kind.values()),
            # redundancy bytes per data byte the codec promises (copies: R;
            # xor: 1/g; rs: m/g; lrc: (l+g)/g)
            "redundancy_overhead": self.codec.memory_overhead(group, self.n_ranks),
            "topology": repr(self.topology) if self.topology is not None else None,
            "entity_codecs": {n: self._codec_spec(c) for n, c in sorted(self.entity_codecs.items())},
        }


def _row_nbytes(leaves: list[torch.Tensor], coords: list[Any]) -> list[int]:
    """Bytes per planner row for each leaf: a slice along the leaf's data
    axis, or the full leaf for replicated ones (one logical row)."""
    out = []
    for leaf, ls in zip(leaves, coords):
        nbytes = leaf.numel() * leaf.element_size()
        out.append(nbytes if ls.axis is None else nbytes // max(leaf.shape[ls.axis], 1))
    return out
