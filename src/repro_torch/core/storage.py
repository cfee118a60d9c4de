"""Multi-level storage tiers, the tier ladder behind the diskless engine
(port of ``repro.core.storage``).

The paper's scheme is extensible past the diskless level: "one could for
instance additionally implement checkpointing to disk at a lower frequency
to protect the simulation against failures that strike the whole system"
(§5.2.1). This module is that extension:

  * ``TierSpec`` / ``diskless`` / ``disk`` / ``shared_dir``: the declarative
    ladder carried on ``EngineConfig.tiers`` (e.g. ``(disk(path, every=4),)``:
    diskless in-memory checkpoints every interval, a disk generation every
    4th commit).
  * ``DisklessTier``: rung 0, a descriptor for the in-memory ``HostStore``
    set the engine already owns (codec reconstruction is its recovery path).
  * ``DiskTier`` / ``SharedDirTier``: persistent rungs. ``flush`` serializes
    the committed (read-only) generation chunked and checksummed (optionally
    zlib-compressed) into a new generation directory; ``load`` rehydrates
    the engine's stores from the newest valid generation, falling back to
    older generations when the newest fails validation.

**Commit protocol.** A flush writes every rank file into a staging
directory, fsyncs, then atomically renames it to ``gen-N`` and rewrites the
``LATEST`` pointer file with ``os.replace``: the disk mirror of the engine's
double-buffer pointer swap. A crash at any point mid-flush leaves either a
stale staging directory (ignored and collected) or a fully committed
generation; the previous generation is never touched. Rank files validate
themselves: the chunk stream carries a combined Fletcher checksum, so torn
or bit-rotten files raise ``IntegrityError`` at load and the loader falls
back to the previous generation.

**Escalating recovery.** The engine first reconstructs from the surviving
hosts; only when the failure set exceeds the codec's tolerance (or after a
cold start with no survivor) does ``CheckpointEngine.escalate_from_tiers``
load the newest generation whose missing ranks the codec can still cover.

The formats are the reference's, byte for byte in what they hold: the raw
chunk stream, the blob table, the stream checksum, the generation layout
(``gen-N``, ``LATEST``, ``rank%05d.tier`` / ``.delta``) and the chunk
store's object names and bytes. The pickled headers name this package's
classes, so a generation is read back by the package that wrote it.

Payload tensors are ``torch.uint8`` CPU arenas (pinned when the engine runs
on the card). The flush streams them out through numpy views of the same
memory, yielding the GIL between chunks (BLAKE2b, zlib and the file writes
release it); a dedup flush digests and checksums its chunks on a few
threads and consumes the results in stream order, and a dedup load fetches
and verifies its chunks the same way. A load reads each rank file straight
into one arena per rank
file, allocated as the engine's stores lease theirs (page-locked when the
engine is on the card, timed as the span ``tier_pin``), with ``readinto``
for uncompressed chunks; the payload's tensors are views of that arena.

The legacy pickle layout lives on as ``save_to_disk`` / ``load_from_disk``
(with the pre-codec layout migration), writing and reading this package's
own pickles; ``DiskTier.load`` falls back to it when a directory holds only
``index.pkl``.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import re
import shutil
import struct
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import distribution as dist
from repro_torch.core.hoststore import StorePayload, pinned_empty
from repro_torch.core.integrity import IntegrityError, np_checksum
from repro_torch.core.serialization import dtype_from_name, dtype_name
from repro_torch.obs.trace import tracer
from repro_torch.utils.logging import get_logger

log = get_logger("core.storage")

_TR = tracer()  # tier flush / load spans land on the engine's timeline

_MASK = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Tier specs: the declarative ladder on EngineConfig.tiers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TierSpec:
    """One rung of the storage ladder (hashable: rides on the frozen
    EngineConfig). ``every`` counts committed level-0 checkpoints between
    flushes of this tier."""

    kind: str                      # "diskless" | "disk" | "shared"
    path: str | None = None
    every: int = 1
    compress: bool = False
    chunk_bytes: int = 4 << 20     # flush/verify chunk granularity
    keep: int = 2                  # committed generations retained (>= 2)
    dedup: bool = False            # content-addressed delta generations


def diskless() -> TierSpec:
    """Rung 0: the in-memory HostStore set (implicit; listed for clarity)."""
    return TierSpec(kind="diskless")


def disk(path: str, every: int = 4, *, compress: bool = False,
         chunk_bytes: int = 4 << 20, keep: int = 2,
         dedup: bool = False) -> TierSpec:
    """Node-local (or job-local) disk rung: survives beyond-tolerance bursts
    and full-job restarts on the same storage. ``dedup=True`` writes
    content-addressed delta generations: each flush stores only the chunk
    objects absent from the store plus a small manifest."""
    return TierSpec(kind="disk", path=path, every=every, compress=compress,
                    chunk_bytes=chunk_bytes, keep=keep, dedup=dedup)


def shared_dir(path: str, every: int = 16, *, compress: bool = False,
               chunk_bytes: int = 4 << 20, keep: int = 2,
               dedup: bool = False) -> TierSpec:
    """Shared-filesystem rung: slowest, survives node loss, the last line
    of the ladder."""
    return TierSpec(kind="shared", path=path, every=every, compress=compress,
                    chunk_bytes=chunk_bytes, keep=keep, dedup=dedup)


# ---------------------------------------------------------------------------
# Flush snapshot: references captured on the caller thread
# ---------------------------------------------------------------------------

@dataclass
class TierSnapshot:
    """One committed generation, captured at the commit point so the
    background flush never races a concurrent kill (``wipe`` swaps the
    store's buffer out; the captured payloads stay alive through these
    references) or the next capture's arena re-lease."""

    n_ranks: int
    created: int                           # engine commit counter at capture
    payloads: dict[int, StorePayload]      # alive+valid ranks only
    step: Any = None                       # checkpoint meta step, if recorded


def capture_snapshot(engine: Any) -> TierSnapshot:
    payloads = {
        r: st.buffer.read_only
        for r, st in engine.stores.items()
        if st.alive and st.buffer.valid
    }
    step = None
    for p in payloads.values():
        step = p.meta.get("step", p.meta.get("pos"))
        break
    return TierSnapshot(n_ranks=engine.n_ranks, created=engine.stats.created, payloads=payloads, step=step)


# ---------------------------------------------------------------------------
# StorageTier: the ladder interface
# ---------------------------------------------------------------------------

class StorageTier:
    """One rung of the ladder. ``persistent`` rungs implement flush/load;
    the diskless rung is a descriptor for the engine's own HostStores."""

    name: str = "?"
    kind: str = "?"
    persistent: bool = False
    every: int = 1     # flush every k-th committed level-0 checkpoint

    def due(self, created: int) -> bool:
        return self.persistent and self.every >= 1 and created > 0 and created % self.every == 0

    def has_data(self) -> bool:
        return False

    def flush(self, snap: TierSnapshot) -> int:
        """Persist one committed generation; returns bytes written."""
        raise NotImplementedError

    def load(self, engine: Any) -> int:
        """Rehydrate ``engine``'s stores from the newest valid generation
        (resizing the engine to the stored world if it differs). Returns the
        generation number; raises ``distribution.DataLostError`` when no
        generation is loadable."""
        raise NotImplementedError


class DisklessTier(StorageTier):
    """Rung 0: the double-buffered in-memory HostStore set. Recovery at this
    rung is the engine's codec reconstruction; this object only anchors the
    ladder's order."""

    name = "diskless"
    kind = "diskless"
    persistent = False


# ---------------------------------------------------------------------------
# Rank-file format: chunked, checksummed, optionally compressed
# ---------------------------------------------------------------------------
#
# [chunk stream][header pickle][tail]
#   chunk  = <u32 raw_len><u32 stored_len><stored bytes>
#   tail   = <u64 header_len><8s magic>
#
# The header holds the tensor-stripped payload (tensors replaced by _BlobRef
# placeholders), the blob table (8-aligned offsets into the logical raw
# stream) and the combined Fletcher checksum of the raw stream. The loader
# re-chunks identically, re-combines the checksum and rejects a mismatch
# with IntegrityError.

_MAGIC = b"RTIER001"
_MAGIC_DELTA = b"RTIERD01"   # delta rank file: header+tail only, chunks by reference
_CHUNK_HDR = struct.Struct("<II")
_TAIL = struct.Struct("<Q8s")
_ALIGN = 8  # blob starts are 8-aligned so loaded views never misalign
_DIGEST_BYTES = 16  # BLAKE2b-128 chunk identity in the content-addressed store

Alloc = Callable[[int], torch.Tensor]


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """The bytes of a CPU tensor as a flat uint8 numpy view (no copy for a
    contiguous tensor)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def _iter_stream_chunks(blobs: list[torch.Tensor], step: int):
    """The canonical chunk stream of a blob list: each blob's bytes in
    ``step``-sized pieces, the <8-byte alignment pad folded into the blob's
    final piece. The one chunking rule of the full (``.tier``) and delta
    (``.delta``) rank formats: their stream checksums recombine identically,
    and a chunk's digest names the same bytes in either format."""
    for b in blobs:
        flat = _host_bytes(b)
        pad = (-flat.nbytes) % _ALIGN
        for lo in range(0, flat.nbytes, step) or [0]:
            chunk = flat[lo : lo + step]
            if chunk.nbytes == 0:
                continue
            if pad and lo + step >= flat.nbytes:
                # fold the <8 alignment pad bytes into the final chunk only
                chunk = np.concatenate([chunk, np.zeros(pad, np.uint8)])
            yield chunk


@dataclass(frozen=True)
class _BlobRef:
    idx: int


def _strip_arrays(obj: Any, blobs: list[torch.Tensor]) -> Any:
    """Replace every tensor in a payload structure by a ``_BlobRef`` and
    collect the tensors (in traversal order: the dicts' insertion order) for
    the chunked byte stream; the header pickle stays tiny."""
    if isinstance(obj, torch.Tensor):
        blobs.append(obj)
        return _BlobRef(len(blobs) - 1)
    if isinstance(obj, dict):
        return {k: _strip_arrays(v, blobs) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_strip_arrays(v, blobs) for v in obj)
    if isinstance(obj, list):
        return [_strip_arrays(v, blobs) for v in obj]
    return obj


def _fill_arrays(obj: Any, views: list[torch.Tensor]) -> Any:
    if isinstance(obj, _BlobRef):
        return views[obj.idx]
    if isinstance(obj, dict):
        return {k: _fill_arrays(v, views) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_fill_arrays(v, views) for v in obj)
    if isinstance(obj, list):
        return [_fill_arrays(v, views) for v in obj]
    return obj


def _fold(sums: tuple[int, int], part: tuple[int, int], nbytes: int, words: int) -> tuple[int, int, int]:
    """Fold one chunk's Fletcher pair into the running stream checksum by the
    restore pipeline's linear-combination rule: s1 = Σ c1,
    s2 = Σ (c2 + o·c1) at word offset o."""
    c1, c2 = part
    s1 = (sums[0] + c1) & _MASK
    s2 = (sums[1] + c2 + words * c1) & _MASK
    return s1, s2, words + (nbytes + 3) // 4


#: Threads that checksum, digest and (de)compress a rank file's chunks, on a
#: flush and on a load (numpy, BLAKE2b and zlib release the GIL; on one
#: thread they, not the disk, bound a flush). Results are consumed in stream
#: order, so the file, the chunk store's puts and the checksums are those of
#: one thread.
_HASH_WORKERS = max(1, min(6, (os.cpu_count() or 1) - 2))


def _in_order(fn: Callable, items):
    """``fn`` over ``items`` (an iterable, drawn lazily) on a pool of
    ``_HASH_WORKERS`` threads that lives for the call, at most two tasks per
    thread ahead of the consumer, yielding the results in order; on an
    early exit the tasks not yet started are cancelled and the running ones
    joined."""
    ahead: deque = deque()
    with ThreadPoolExecutor(_HASH_WORKERS, thread_name_prefix="tier-hash") as pool:
        try:
            for x in items:
                ahead.append(pool.submit(fn, x))
                if len(ahead) >= 2 * _HASH_WORKERS:
                    yield ahead.popleft().result()
            while ahead:
                yield ahead.popleft().result()
        finally:
            for f in ahead:
                f.cancel()


def _digest(chunk: np.ndarray) -> str:
    return hashlib.blake2b(memoryview(chunk), digest_size=_DIGEST_BYTES).hexdigest()


def _stripped(payload: StorePayload) -> tuple[Any, list[torch.Tensor], list, int]:
    """(light payload, blobs, blob table, raw stream bytes): the reference's
    field order, so the blobs number as the reference's do."""
    blobs: list[torch.Tensor] = []
    light = _strip_arrays(
        {"own": payload.own, "own_exch": payload.own_exch,
         "parity": payload.parity, "meta": payload.meta},
        blobs,
    )
    table: list[tuple[int, int, str, tuple[int, ...]]] = []
    off = 0
    for b in blobs:
        nbytes = b.numel() * b.element_size()
        table.append((off, int(nbytes), dtype_name(b.dtype), tuple(b.shape)))
        off += nbytes + (-nbytes) % _ALIGN
    return light, blobs, table, off


def write_rank_file(
    path: str, payload: StorePayload, *, chunk_bytes: int = 4 << 20,
    compress: bool = False,
) -> tuple[int, tuple[int, int]]:
    """Serialize one rank's committed payload. Returns (raw stream bytes,
    stream checksum). The byte stream is written in ``chunk_bytes`` pieces,
    each verifiable on its own; ``compress`` zlib-packs each chunk
    (level 1: the flush is bound by bandwidth, not ratio)."""
    light, blobs, table, raw_total = _stripped(payload)
    sums = (0, 0)
    words = 0
    step = max(4, chunk_bytes) & ~3

    def prepare(chunk):
        # memoryview: no tobytes() copy, which would hold the GIL for a
        # multi-MiB copy (io and zlib release it)
        return chunk, np_checksum(chunk), zlib.compress(chunk, 1) if compress else memoryview(chunk)

    with open(path, "wb") as f:
        for chunk, part, data in _in_order(prepare, _iter_stream_chunks(blobs, step)):
            s1, s2, words = _fold(sums, part, chunk.nbytes, words)
            sums = (s1, s2)
            f.write(_CHUNK_HDR.pack(chunk.nbytes, len(data)))
            f.write(data)
            time.sleep(0)  # yield the GIL between chunks
        header = pickle.dumps(
            {"payload": light, "table": table, "raw_total": raw_total,
             "checksum": sums, "compress": compress},
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        f.write(header)
        f.write(_TAIL.pack(len(header), _MAGIC))
        f.flush()
        os.fsync(f.fileno())
    return raw_total, sums


def _read_tail(f, path: str, magic: bytes) -> dict:
    f.seek(0, os.SEEK_END)
    size = f.tell()
    if size < _TAIL.size:
        raise IntegrityError(f"{path}: truncated (no tail)")
    f.seek(size - _TAIL.size)
    header_len, got = _TAIL.unpack(f.read(_TAIL.size))
    if got != magic:
        raise IntegrityError(f"{path}: bad magic {got!r}")
    header_off = size - _TAIL.size - header_len
    if header_off < 0:
        raise IntegrityError(f"{path}: truncated header")
    f.seek(header_off)
    try:
        return pickle.loads(f.read(header_len))
    except Exception as e:  # noqa: BLE001 - a torn pickle is a corruption verdict
        raise IntegrityError(f"{path}: corrupt header: {e}") from e


def _arena(header: dict, alloc: Alloc | None) -> torch.Tensor:
    total = int(header["raw_total"])
    if alloc is None:
        return torch.empty(total, dtype=torch.uint8)
    return alloc(total)


def _payload_from(arena: torch.Tensor, header: dict) -> StorePayload:
    views = [
        arena[off : off + nbytes].view(dtype_from_name(dt)).reshape(shape)
        for off, nbytes, dt, shape in header["table"]
    ]
    d = _fill_arrays(header["payload"], views)
    return StorePayload(own=d["own"], own_exch=d["own_exch"], parity=d["parity"], meta=d["meta"])


def read_rank_file(path: str, alloc: Alloc | None = None) -> StorePayload:
    """Inverse of ``write_rank_file``: stream the chunks into one arena
    (``alloc(nbytes)``, default a pageable tensor; uncompressed chunks are
    read in place), verifying the combined checksum, then rebuild the
    payload from views of the arena. The chunks are read in order on this
    thread and checksummed (decompressed first) on the hash threads. Raises
    ``IntegrityError`` on any mismatch."""
    with open(path, "rb") as f:
        header = _read_tail(f, path, _MAGIC)
        total = int(header["raw_total"])
        arena = _arena(header, alloc)
        raw_np = arena.numpy()
        f.seek(0)

        def frames():
            """(raw offset, raw length, stored bytes or None when read in place)."""
            pos = 0
            while pos < total:
                # Malformed framing is a corruption verdict, not a crash: the
                # loader falls back a generation.
                try:
                    raw_len, stored_len = _CHUNK_HDR.unpack(f.read(_CHUNK_HDR.size))
                except struct.error as e:
                    raise IntegrityError(f"{path}: corrupt chunk at {pos}: {e}") from e
                if pos + raw_len > total:
                    raise IntegrityError(f"{path}: chunk overruns raw stream at {pos}")
                if header["compress"]:
                    data = f.read(stored_len)
                    if len(data) != stored_len:
                        raise IntegrityError(f"{path}: short chunk at raw offset {pos}")
                else:
                    if stored_len != raw_len:
                        raise IntegrityError(f"{path}: chunk length mismatch at {pos}")
                    if f.readinto(memoryview(raw_np[pos : pos + raw_len])) != raw_len:
                        raise IntegrityError(f"{path}: short chunk at raw offset {pos}")
                    data = None
                yield pos, raw_len, data
                pos += raw_len

        def verify(frame):
            pos, raw_len, data = frame
            dst = raw_np[pos : pos + raw_len]
            if data is not None:
                try:
                    raw = zlib.decompress(data)
                except zlib.error as e:
                    raise IntegrityError(f"{path}: corrupt chunk at {pos}: {e}") from e
                if len(raw) != raw_len:
                    raise IntegrityError(f"{path}: chunk length mismatch at {pos}")
                dst[:] = np.frombuffer(raw, np.uint8)
            return raw_len, np_checksum(dst)

        sums = (0, 0)
        words = 0
        for raw_len, part in _in_order(verify, frames()):
            s1, s2, words = _fold(sums, part, raw_len, words)
            sums = (s1, s2)
    if sums != tuple(header["checksum"]):
        raise IntegrityError(f"{path}: stream checksum mismatch")
    return _payload_from(arena, header)


# ---------------------------------------------------------------------------
# Content-addressed chunk store + delta rank files
# ---------------------------------------------------------------------------
#
# A dedup-enabled tier stores the chunk stream once, content-addressed: every
# stream chunk is an object named by the BLAKE2b-128 digest of its raw bytes
# under <tier>/chunks/<2-hex-prefix>/, and the rank file is a header-only
# manifest (``rank%05d.delta``) naming its chunks by digest. Identical chunks
# across generations and ranks collapse to one object, so a low-churn commit
# writes only the dirty chunks plus manifests.

class ChunkStore:
    """Digest-named chunk objects with atomic publication: writers go
    through tmp + fsync + ``os.replace``, so a reader never sees a torn
    object, and a racing writer of the same digest is harmless. Raw and
    zlib-packed objects carry distinct suffixes."""

    def __init__(self, root: str) -> None:
        self.root = root

    def _obj_path(self, digest: str, compressed: bool) -> str:
        suffix = ".z" if compressed else ".chunk"
        return os.path.join(self.root, digest[:2], digest + suffix)

    def put(self, digest: str, chunk: np.ndarray, *, compress: bool = False) -> int:
        """Publish one chunk; returns object bytes written: 0 on a dedup hit
        (the object's mtime is refreshed so the GC grace window re-arms)."""
        path = self._obj_path(digest, compress)
        if os.path.exists(path):
            try:
                os.utime(path)
            except OSError:
                pass
            return 0
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = zlib.compress(chunk, 1) if compress else memoryview(chunk)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return len(data)

    def get(self, digest: str, raw_len: int, *, compressed: bool = False,
            out: np.ndarray | None = None) -> np.ndarray:
        """Fetch and verify one chunk (length and digest recomputed: bit-rot
        in a shared store surfaces as IntegrityError). Read into ``out``
        (``raw_len`` bytes, in place for a raw object) when given."""
        path = self._obj_path(digest, compressed)
        if out is None:
            out = np.empty(raw_len, np.uint8)
        try:
            with open(path, "rb") as f:
                if compressed:
                    data = f.read()
                else:
                    got = f.readinto(memoryview(out))
                    if got != raw_len or f.read(1):
                        raise IntegrityError(f"chunk {digest}: length differs from manifest {raw_len}")
        except OSError as e:
            raise IntegrityError(f"chunk {digest} missing from {self.root}: {e}") from e
        if compressed:
            try:
                raw = zlib.decompress(data)
            except zlib.error as e:
                raise IntegrityError(f"chunk {digest}: corrupt object body: {e}") from e
            if len(raw) != raw_len:
                raise IntegrityError(f"chunk {digest}: length {len(raw)} != manifest {raw_len}")
            out[:] = np.frombuffer(raw, np.uint8)
        if _digest(out) != digest:
            raise IntegrityError(f"chunk {digest}: content does not match its name")
        return out


def write_rank_delta_file(
    path: str, payload: StorePayload, store: ChunkStore, *,
    chunk_bytes: int = 4 << 20, compress: bool = False,
) -> tuple[int, tuple[int, int], int, int, int]:
    """Delta form of ``write_rank_file``: the chunk stream lands in the
    content-addressed store (objects written only when absent) and the rank
    file is a header-only manifest. Returns (raw stream bytes, stream
    checksum, chunk-store bytes written, total chunks, new chunks)."""
    light, blobs, table, raw_total = _stripped(payload)
    sums = (0, 0)
    words = 0
    step = max(4, chunk_bytes) & ~3
    refs: list[tuple[str, int]] = []
    new_bytes = 0
    n_new = 0
    for chunk, digest, part in _in_order(lambda c: (c, _digest(c), np_checksum(c)),
                                         _iter_stream_chunks(blobs, step)):
        s1, s2, words = _fold(sums, part, chunk.nbytes, words)
        sums = (s1, s2)
        wrote = store.put(digest, chunk, compress=compress)
        new_bytes += wrote
        n_new += 1 if wrote else 0
        refs.append((digest, int(chunk.nbytes)))
        time.sleep(0)  # yield the GIL between chunks
    header = pickle.dumps(
        {"payload": light, "table": table, "raw_total": raw_total,
         "checksum": sums, "compress": compress, "chunks": refs},
        protocol=pickle.HIGHEST_PROTOCOL,
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(_TAIL.pack(len(header), _MAGIC_DELTA))
        f.flush()
        os.fsync(f.fileno())
    return raw_total, sums, new_bytes, len(refs), n_new


def read_delta_header(path: str) -> dict:
    """The delta manifest alone (the GC's reference scan reads no chunk)."""
    with open(path, "rb") as f:
        return _read_tail(f, path, _MAGIC_DELTA)


def read_rank_delta_file(path: str, store: ChunkStore, alloc: Alloc | None = None) -> StorePayload:
    """Inverse of ``write_rank_delta_file``: resolve every chunk reference
    through the store into one arena (``alloc``, as ``read_rank_file``),
    re-combining the stream checksum. A missing or torn chunk or a checksum
    mismatch raises ``IntegrityError``, so the loader falls back a
    generation."""
    header = read_delta_header(path)
    total = int(header["raw_total"])
    arena = _arena(header, alloc)
    raw_np = arena.numpy()
    pos = 0
    spans = []
    for digest, raw_len in header["chunks"]:
        if pos + raw_len > total:
            raise IntegrityError(f"{path}: chunk overruns raw stream at {pos}")
        spans.append((digest, raw_len, pos))
        pos += raw_len

    def fetch(span):  # one chunk into its slice of the arena, verified
        digest, raw_len, lo = span
        return np_checksum(store.get(digest, raw_len, compressed=header["compress"], out=raw_np[lo : lo + raw_len]))

    sums = (0, 0)
    words = 0
    for (_, raw_len, _), part in zip(spans, _in_order(fetch, spans)):
        s1, s2, words = _fold(sums, part, raw_len, words)
        sums = (s1, s2)
    if pos != total:
        raise IntegrityError(f"{path}: chunk stream short ({pos} < {total})")
    if sums != tuple(header["checksum"]):
        raise IntegrityError(f"{path}: stream checksum mismatch")
    return _payload_from(arena, header)


# ---------------------------------------------------------------------------
# DiskTier: persistent generations with the atomic commit pointer
# ---------------------------------------------------------------------------

_GEN_RE = re.compile(r"^gen-(\d{10})$")

#: chunk objects unreferenced by every committed generation are unlinked only
#: once this much older than their last put/utime: a concurrent flusher that
#: published chunks for a generation it has not renamed yet must not lose them
_GC_GRACE_S = 300.0


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _fsync_dir(path: str) -> None:
    """A rename survives power loss only once its directory is fsynced."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platforms without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def arena_alloc(engine: Any) -> Alloc:
    """How a load allocates its arenas for ``engine``: as the engine's
    stores lease theirs, page-locked when the engine runs on the card (each
    pinning timed as the span ``tier_pin``)."""
    device = getattr(engine, "device", None)
    if device is None or device.type != "cuda":
        return lambda n: torch.empty(n, dtype=torch.uint8)

    def pinned(n: int) -> torch.Tensor:
        with _TR.span("tier_pin", nbytes=n):
            return pinned_empty(n)

    return pinned


class DiskTier(StorageTier):
    name = "disk"
    kind = "disk"
    persistent = True

    def __init__(self, spec: TierSpec) -> None:
        assert spec.path, f"{self.kind} tier needs a path"
        self.path = spec.path
        self.every = spec.every
        self.compress = spec.compress
        self.chunk_bytes = spec.chunk_bytes
        self.keep = max(2, spec.keep)
        self.dedup = bool(spec.dedup)
        # the last flush's dedup telemetry (chunks written/reused, logical vs
        # stored bytes), read by the engine's flush worker into its stats
        self.last_dedup: dict[str, int] | None = None
        # the last load's bytes read and seconds (reading, pinning)
        self.last_load: dict[str, float] | None = None
        # per-generation chunk-reference sets for the GC scan (generation
        # directories are immutable after the commit rename; pruned gens are
        # evicted)
        self._ref_cache: dict[int, set[str]] = {}

    def _chunk_store(self) -> ChunkStore:
        return ChunkStore(os.path.join(self.path, "chunks"))

    # -- generation bookkeeping ----------------------------------------- #
    def generations(self) -> list[int]:
        """Committed generation numbers, ascending."""
        if not os.path.isdir(self.path):
            return []
        out = []
        for entry in os.listdir(self.path):
            m = _GEN_RE.match(entry)
            if m and os.path.exists(os.path.join(self.path, entry, "MANIFEST.pkl")):
                out.append(int(m.group(1)))
        return sorted(out)

    def has_data(self) -> bool:
        if self.generations():
            return True
        return os.path.exists(os.path.join(self.path, "index.pkl"))  # legacy pickle layout

    def _gen_dir(self, gen: int) -> str:
        return os.path.join(self.path, f"gen-{gen:010d}")

    # -- flush: chunked write + atomic commit --------------------------- #
    def flush(self, snap: TierSnapshot) -> int:
        t0 = time.perf_counter()
        os.makedirs(self.path, exist_ok=True)
        self._gc_tmp()
        tmp = os.path.join(self.path, f"gen-staging.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        total = 0
        logical = 0
        chunks_total = 0
        chunks_new = 0
        ranks: dict[int, dict[str, Any]] = {}
        store = self._chunk_store() if self.dedup else None
        for r, payload in sorted(snap.payloads.items()):
            if store is not None:
                # chunk objects go into the shared store first (orphans of a
                # crash before the rename age out through the GC grace
                # window); the rank file is a digest manifest
                fname = os.path.join(tmp, f"rank{r:05d}.delta")
                with _TR.span("tier_delta_write", tier=self.name, gen=snap.created, rank=r):
                    nbytes, sums, wrote, n_chunks, n_new = write_rank_delta_file(
                        fname, payload, store, chunk_bytes=self.chunk_bytes, compress=self.compress,
                    )
                total += os.path.getsize(fname) + wrote
                logical += nbytes
                chunks_total += n_chunks
                chunks_new += n_new
                ranks[r] = {"raw_bytes": nbytes, "checksum": sums, "format": "delta"}
            else:
                fname = os.path.join(tmp, f"rank{r:05d}.tier")
                with _TR.span("tier_write", tier=self.name, gen=snap.created, rank=r):
                    nbytes, sums = write_rank_file(fname, payload, chunk_bytes=self.chunk_bytes,
                                                   compress=self.compress)
                total += os.path.getsize(fname)
                logical += nbytes
                ranks[r] = {"raw_bytes": nbytes, "checksum": sums}
        manifest = {
            "format": 1,
            "n_ranks": snap.n_ranks,
            "ranks": ranks,
            "created": snap.created,
            "step": snap.step,
            "compress": self.compress,
            "dedup": self.dedup,
            "wall_time": time.time(),
        }
        with open(os.path.join(tmp, "MANIFEST.pkl"), "wb") as f:
            pickle.dump(manifest, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        # COMMIT: the atomic rename, then the LATEST pointer. The generation
        # number is claimed at the rename (a concurrent flusher on a shared
        # directory that won the race pushes us to the next number), and the
        # parent directory is fsynced so the rename survives power loss.
        gen = 0
        for _ in range(64):
            gens = self.generations()
            gen = (gens[-1] + 1) if gens else 1
            try:
                os.rename(tmp, self._gen_dir(gen))
                break
            except OSError:
                continue  # lost the race: re-scan and take the next number
        else:
            shutil.rmtree(tmp, ignore_errors=True)
            raise OSError(f"{self.name} tier: could not claim a generation number under {self.path!r}")
        _fsync_dir(self.path)
        self._write_latest(gen)
        _fsync_dir(self.path)
        if self.dedup:
            self.last_dedup = {
                "chunks_written": chunks_new,
                "chunks_reused": chunks_total - chunks_new,
                "logical_bytes": logical,
                "stored_bytes": total,
            }
        self._prune()
        log.info("%s tier flush: gen %d, %d ranks, %.1f MiB in %.3fs -> %s",
                 self.name, gen, len(ranks), total / 2**20, time.perf_counter() - t0, self.path)
        return total

    def _latest_named(self) -> int | None:
        try:
            with open(os.path.join(self.path, "LATEST")) as f:
                m = _GEN_RE.match(f.read().strip())
        except OSError:
            return None
        return int(m.group(1)) if m else None

    def _load_order(self, gens: list[int]) -> list[int]:
        """Generations in load-preference order: the one the LATEST pointer
        names first (when it is committed), then the rest newest first. A
        stale or missing pointer (a crash between the rename and the pointer
        rewrite) degrades to the newest-first scan."""
        order = sorted(gens, reverse=True)
        latest = self._latest_named()
        if latest is not None and latest in gens:
            order = [latest] + [g for g in order if g != latest]
        return order

    def _write_latest(self, gen: int) -> None:
        tmp = os.path.join(self.path, f".LATEST.tmp-{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(f"gen-{gen:010d}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, "LATEST"))

    def _protected_gens(self, gens: list[int]) -> set[int]:
        """Generations pruning must not touch: the newest ``keep``, whatever
        ``LATEST`` names, and any generation holding a live reader's pin file
        (``.readpin-<pid>``, written by ``_read_generation`` while its rank
        files stream in). Pins of dead readers are swept."""
        protected = set(gens[-self.keep:]) if self.keep else set()
        latest = self._latest_named()
        if latest is not None:
            protected.add(latest)
        for gen in gens:
            gdir = self._gen_dir(gen)
            try:
                entries = os.listdir(gdir)
            except OSError:
                continue
            for entry in entries:
                if not entry.startswith(".readpin-"):
                    continue
                try:
                    pid = int(entry.rsplit("-", 1)[1])
                except ValueError:
                    pid = -1
                if pid > 0 and _pid_alive(pid):
                    protected.add(gen)
                else:
                    try:
                        os.unlink(os.path.join(gdir, entry))
                    except OSError:
                        pass
        return protected

    def _prune(self) -> None:
        gens = self.generations()
        protected = self._protected_gens(gens)
        for gen in gens:
            if gen in protected:
                continue
            shutil.rmtree(self._gen_dir(gen), ignore_errors=True)
            self._ref_cache.pop(gen, None)
        if os.path.isdir(os.path.join(self.path, "chunks")):
            self._gc_chunks()

    # -- content-addressed chunk GC (refcount by generation reference) ---- #
    def _chunk_refs(self, gen: int) -> set[str]:
        refs = self._ref_cache.get(gen)
        if refs is not None:
            return refs
        refs = set()
        try:
            entries = os.listdir(self._gen_dir(gen))
        except OSError:
            entries = []
        for entry in entries:
            if not entry.endswith(".delta"):
                continue
            try:
                header = read_delta_header(os.path.join(self._gen_dir(gen), entry))
            except Exception:  # noqa: BLE001 - a torn manifest pins nothing
                continue
            refs.update(d for d, _ in header["chunks"])
        self._ref_cache[gen] = refs
        return refs

    def _gc_chunks(self) -> None:
        """A chunk object survives while any committed generation names its
        digest; an unreferenced one is unlinked only once older than
        ``_GC_GRACE_S``, so neither a concurrent flusher's not-yet-renamed
        generation nor a reader mid-stream is undercut."""
        root = os.path.join(self.path, "chunks")
        live: set[str] = set()
        for gen in self.generations():
            live |= self._chunk_refs(gen)
        cutoff = time.time() - _GC_GRACE_S
        try:
            prefixes = os.listdir(root)
        except OSError:
            return
        for prefix in prefixes:
            pdir = os.path.join(root, prefix)
            if not os.path.isdir(pdir):
                continue
            for entry in os.listdir(pdir):
                if entry.split(".", 1)[0] in live:
                    continue
                fpath = os.path.join(pdir, entry)
                try:
                    if os.path.getmtime(fpath) > cutoff:
                        continue
                    os.unlink(fpath)
                except OSError:
                    continue

    def _gc_tmp(self) -> None:
        """Remove abandoned staging directories: our own, or those of writers
        that no longer exist (a live foreign writer's is left alone)."""
        for entry in os.listdir(self.path):
            if ".tmp-" not in entry:
                continue
            try:
                pid = int(entry.rsplit(".tmp-", 1)[1])
            except ValueError:
                pid = -1
            if pid != os.getpid() and pid > 0 and _pid_alive(pid):
                continue
            shutil.rmtree(os.path.join(self.path, entry), ignore_errors=True)

    # -- load: newest valid generation, falling back to older ones ------- #
    def _read_generation(self, gen: int, alloc: Alloc | None = None) -> tuple[dict[int, StorePayload], dict]:
        gdir = self._gen_dir(gen)
        # Pin the generation while its rank files stream in, so a concurrent
        # flusher's prune leaves it (best effort: a read-only mount skips it).
        pin = os.path.join(gdir, f".readpin-{os.getpid()}")
        try:
            with open(pin, "w"):
                pass
        except OSError:
            pin = None
        try:
            with open(os.path.join(gdir, "MANIFEST.pkl"), "rb") as f:
                manifest = pickle.load(f)
            payloads: dict[int, StorePayload] = {}
            store = self._chunk_store()
            for r, info in manifest["ranks"].items():
                delta = os.path.join(gdir, f"rank{int(r):05d}.delta")
                if info.get("format") == "delta" or os.path.exists(delta):
                    payload = read_rank_delta_file(delta, store, alloc)
                else:
                    payload = read_rank_file(os.path.join(gdir, f"rank{int(r):05d}.tier"), alloc)
                payloads[int(r)] = payload
            return payloads, manifest
        finally:
            if pin is not None:
                try:
                    os.unlink(pin)
                except OSError:
                    pass

    def _coverable(self, engine: Any, manifest: dict) -> bool:
        """True when the generation's missing ranks (dead at flush time) are
        still recoverable by the active codec: the engine's own plan check."""
        missing = set(range(manifest["n_ranks"])) - {int(r) for r in manifest["ranks"]}
        if not missing:
            return True
        from repro_torch.core import codec as codec_mod

        # a domain-aware engine's groups are not contiguous: the plan takes
        # the engine's layout whenever the flushed world is the engine's
        groups = (engine._groups() if getattr(engine, "topology", None) is not None
                  and manifest["n_ranks"] == engine.n_ranks else None)
        try:
            codec_mod.codec_recovery_plan(manifest["n_ranks"], missing, engine.codec, groups=groups)
            return True
        except dist.DataLostError:
            return False

    def _resize(self, engine: Any, n_ranks: int) -> None:
        """The stored world wins: restore_elastic maps it back onto the
        caller's M ranks afterwards (the cold N-to-M restart)."""
        if engine.n_ranks != n_ranks:
            engine.n_ranks = n_ranks
            engine.stores = engine._new_stores(n_ranks)

    def load(self, engine: Any) -> int:
        gens = self.generations()
        if not gens and os.path.exists(os.path.join(self.path, "index.pkl")):
            # Legacy pickle layout, under the same contract as generation
            # loads: a mismatched world resizes the engine, and any failure
            # is a DataLostError so escalation degrades instead of crashing.
            try:
                with open(os.path.join(self.path, "index.pkl"), "rb") as f:
                    n_ranks = pickle.load(f)["n_ranks"]
                self._resize(engine, n_ranks)
                load_from_disk(engine, self.path)
            except Exception as e:  # noqa: BLE001 - corrupt legacy pickles
                raise dist.DataLostError(
                    f"{self.name} tier: legacy checkpoint at {self.path!r} "
                    f"unloadable: {type(e).__name__}: {e}"
                ) from e
            log.warning("%s tier: loaded legacy pickle checkpoint from %s", self.name, self.path)
            return 0
        errors: list[str] = []
        alloc = arena_alloc(engine)
        for gen in self._load_order(gens):
            t0 = time.perf_counter()
            pin_s = [0.0]

            def timed_alloc(n: int) -> torch.Tensor:
                t = time.perf_counter()
                out = alloc(n)
                pin_s[0] += time.perf_counter() - t
                return out

            try:
                with _TR.span("tier_read", tier=self.name, tier_gen=gen):
                    payloads, manifest = self._read_generation(gen, timed_alloc)
            except Exception as e:  # noqa: BLE001 - a corrupt generation can
                # raise nearly anything; the contract is "try the next older
                # generation", never "crash recovery"
                errors.append(f"gen {gen}: {type(e).__name__}: {e}")
                _TR.instant("tier_gen_rejected", tier=self.name, tier_gen=gen, cause=type(e).__name__)
                log.warning("%s tier: generation %d failed validation (%s); "
                            "falling back to the previous generation", self.name, gen, e)
                continue
            if not self._coverable(engine, manifest):
                errors.append(f"gen {gen}: missing ranks exceed codec tolerance")
                continue
            n_ranks = manifest["n_ranks"]
            self._resize(engine, n_ranks)
            for r in range(n_ranks):
                store = engine.stores[r]
                store.revive(r)
                if r in payloads:
                    store.buffer.write(payloads[r])
                    store.buffer.swap()
            dt = time.perf_counter() - t0
            self.last_load = {"gen": gen, "bytes": sum(int(i["raw_bytes"]) for i in manifest["ranks"].values()),
                              "s": dt, "pin_s": pin_s[0], "read_s": dt - pin_s[0]}
            log.info("%s tier: loaded generation %d (step %s, %d/%d ranks)",
                     self.name, gen, manifest.get("step"), len(payloads), n_ranks)
            return gen
        raise dist.DataLostError(
            f"{self.name} tier at {self.path!r} holds no loadable generation"
            + (f" ({'; '.join(errors)})" if errors else "")
        )


class SharedDirTier(DiskTier):
    """Shared-filesystem rung: DiskTier's format and commit protocol, but the
    slowest and most durable line: it survives node loss, so it sits last in
    the ladder and flushes least often."""

    name = "shared"
    kind = "shared"


# ---------------------------------------------------------------------------
# Ladder construction
# ---------------------------------------------------------------------------

_TIER_KINDS = {
    "diskless": lambda spec: DisklessTier(),
    "disk": DiskTier,
    "shared": SharedDirTier,
}


def build_tiers(specs: tuple[TierSpec, ...] | list[TierSpec]) -> list[StorageTier]:
    """Resolve an EngineConfig.tiers ladder. Rung 0 is always the diskless
    HostStore tier, implicit when the spec list omits it."""
    tiers: list[StorageTier] = []
    if not specs or specs[0].kind != "diskless":
        tiers.append(DisklessTier())
    for spec in specs or ():
        if spec.kind not in _TIER_KINDS:
            raise KeyError(f"unknown storage tier kind {spec.kind!r}; have {sorted(_TIER_KINDS)}")
        tiers.append(_TIER_KINDS[spec.kind](spec))
    return tiers


# ---------------------------------------------------------------------------
# Legacy pickle format (kept for migration)
# ---------------------------------------------------------------------------

def _to_numpy(obj: Any) -> Any:
    """Tensors as numpy arrays (a pickled numpy view holds its own bytes; a
    pickled tensor view would hold its whole arena)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().contiguous().numpy().copy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_to_numpy(v) for v in obj)
    if isinstance(obj, list):
        return [_to_numpy(v) for v in obj]
    return obj


def _to_torch(obj: Any) -> Any:
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_to_torch(v) for v in obj)
    if isinstance(obj, list):
        return [_to_torch(v) for v in obj]
    return obj


def save_to_disk(engine: Any, path: str) -> int:
    """Persist every alive rank's read-only buffer in the legacy pickle
    layout. New jobs use DiskTier generations; this keeps pre-ladder callers
    and their on-disk checkpoints working."""
    os.makedirs(path, exist_ok=True)
    total = 0
    index: dict[str, Any] = {"n_ranks": engine.n_ranks, "ranks": []}
    for r, store in engine.stores.items():
        if not store.alive or not store.buffer.valid:
            continue
        payload = store.buffer.read_only
        blob = {
            "own": _to_numpy(payload.own),
            "own_exch": _to_numpy(payload.own_exch),
            "parity": _to_numpy(payload.parity),
            "meta": payload.meta,
        }
        fname = os.path.join(path, f"rank{r:05d}.pkl")
        with open(fname, "wb") as f:
            pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
        total += os.path.getsize(fname)
        index["ranks"].append(r)
    with open(os.path.join(path, "index.pkl"), "wb") as f:
        pickle.dump(index, f)
    log.info("disk checkpoint: %d ranks, %.1f MiB -> %s", len(index["ranks"]), total / 2**20, path)
    return total


def load_from_disk(engine: Any, path: str) -> None:
    """Rehydrate the engine's read-only buffers from a legacy pickle
    checkpoint (whole-system restart). Pre-codec checkpoints are migrated
    into the codec stripe layout: pickles that still carry the legacy
    ``recv`` slot are translated at load time."""
    with open(os.path.join(path, "index.pkl"), "rb") as f:
        index = pickle.load(f)
    assert index["n_ranks"] == engine.n_ranks, (index["n_ranks"], engine.n_ranks)
    legacy_recv: dict[int, dict[int, dict[str, Any]]] = {}
    for r in index["ranks"]:
        with open(os.path.join(path, f"rank{r:05d}.pkl"), "rb") as f:
            blob = pickle.load(f)
        payload = StorePayload(
            own=_to_torch(blob["own"]),
            own_exch=_to_torch(blob.get("own_exch", {})),
            parity=_to_torch(blob["parity"]),
            meta=blob["meta"],
        )
        if blob.get("recv"):
            legacy_recv[r] = _to_torch(blob["recv"])
        store = engine.stores[r]
        store.revive(r)
        store.buffer.write(payload)
        store.buffer.swap()
    _migrate_legacy_layout(engine, legacy_recv)


def _migrate_legacy_layout(engine: Any, legacy_recv: dict[int, dict[int, dict[str, Any]]]) -> None:
    """Translate pre-codec layouts in place after a load:

    * parity stripes keyed ``(entity, stripe)`` -> ``(entity, blob=0,
      stripe)`` (XOR had exactly one blob per group);
    * legacy ``recv`` partner copies (``holder -> origin -> entity ->
      (flat, manifest)``) -> whole-blob ``parity`` stripes at the codec's
      placement for the holder that held them, their manifests replicated
      into meta so the codec's decode can unpack the bytes.
    """
    groups = engine._groups()
    placements = {gi: engine.codec.placement(groups, gi, engine.n_ranks) for gi in range(len(groups))}
    for store in engine.stores.values():
        payload = store.buffer.read_only
        if payload is None:
            continue
        for stripes in payload.parity.values():
            for key in [k for k in stripes if len(k) == 2]:
                name, j = key
                stripes[(name, 0, j)] = stripes.pop(key)
        for origin, entry in legacy_recv.get(store.rank, {}).items():
            for b, holders in enumerate(placements.get(origin, [])):
                if store.rank not in holders:
                    continue
                for name, (flat, man) in entry.items():
                    payload.parity.setdefault(origin, {})[(name, b, 0)] = flat
                    payload.meta.setdefault("manifests", {})[(origin, name)] = man
