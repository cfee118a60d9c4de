"""The port's storage-tier ladder against the JAX package's (mirrors
tests/test_storage.py case for case, and tests/test_recovery_e2e.py's three
tier cases of the Trainer).

Every engine scenario runs twice in this process, on the same seeded numpy
payloads: through ``repro.core.checkpoint`` and ``repro.core.storage``, and
through the port's engine on ``device="cpu"`` (``numpy_entity`` carries the
payloads across as CPU tensors). Each side must pass the reference test's
own assertions, and the two must agree exactly: the restored bytes, the
checkpoint step, the ladder's and the delta path's stats, and the tier
directory itself: the generation layout, every rank file's raw chunk
stream, blob table, raw length and stream checksum (read from its header),
and every chunk object's name and bytes. The pickled headers name each
package's own classes, so only those fields are compared.

The Trainer cases: the reference's ``Trainer`` through a whole-system loss
and a cold 4 -> 3 restart (``_torch_jax_oracle.py trainer_tiers``, one
child process) against the port's from the same seed, losses within
rtol 1e-4 (``tests/test_torch_trainer.py``'s tolerance) and the same
steps; the port's replay is bitwise.
"""

from __future__ import annotations

import os
import pickle
import threading

import numpy as np
import pytest
import torch

import _torch_jax_oracle as oracle
from repro.core import checkpoint as jckpt
from repro.core import distribution as jdist
from repro.core import gf256 as jgf
from repro.core import hoststore as jhost
from repro.core import integrity as jint
from repro.core import storage as jstorage
from repro_torch.core import checkpoint as tckpt
from repro_torch.core import distribution as tdist
from repro_torch.core import gf256
from repro_torch.core import hoststore as thost
from repro_torch.core import integrity as tint
from repro_torch.core import storage
from repro_torch.core.interval import CheckpointScheduler, MultiLevelScheduler
from repro_torch.launch.steps import numpy_entity

# the stats both packages keep for the ladder and the delta path
LADDER_STATS = ("created", "aborted", "restored", "reconstructed_restores", "tier_flushes", "tier_flush_queued",
                "tier_flush_skipped", "tier_escalations", "delta_encodes", "full_encodes", "last_dirty_fraction",
                "last_transfer_bytes_skipped", "last_flush_chunks_written", "last_flush_chunks_reused")


class Side:
    """One package's engine API: the reference (``port=False``) or the port
    on the CPU."""

    def __init__(self, port: bool) -> None:
        self.port = port
        if port:
            self.ckpt, self.storage, self.dist, self.host, self.integrity = tckpt, storage, tdist, thost, tint
            self.wrap = numpy_entity
        else:
            self.ckpt, self.storage, self.dist, self.host, self.integrity = jckpt, jstorage, jdist, jhost, jint
            self.wrap = lambda ent: ent

    def __repr__(self) -> str:
        return "port" if self.port else "reference"

    def engine(self, n: int, cfg):
        if self.port:
            return tckpt.CheckpointEngine(n, cfg, device="cpu")
        return jckpt.CheckpointEngine(n, cfg)

    def config(self, **kw):
        return self.ckpt.EngineConfig(**kw)

    def array(self, x: np.ndarray):
        """A payload blob in the side's own type."""
        return torch.from_numpy(x) if self.port else x


SIDES = (Side(True), Side(False))


@pytest.fixture(autouse=True)
def table_backend():
    """Both packages' GF(2^8) products through their oracle backend (the
    delta tests cover the port's others), the port's on the CPU."""
    gf256.set_backend("table")
    jgf.set_backend("table")
    with gf256.compute_device("cpu"):
        yield
    gf256.set_backend(None)
    jgf.set_backend(None)


class _Payload:
    def __init__(self, n, per_rank_bytes=1 << 16, seed=0):
        self.n = n
        self.data = [
            np.random.default_rng(seed + r).standard_normal(per_rank_bytes // 4).astype(np.float32)
            for r in range(n)
        ]

    def snapshot_shards(self, n):
        return [{"blocks": self.data[r]} for r in range(n)]

    def restore_shards(self, shards):
        for origin, payload in shards.items():
            self.data[origin] = np.asarray(payload["blocks"])


def _mk_engine(side, tmp_path, n=8, *, every=1, compress_tier=False, dedup=False, **cfg):
    base = dict(codec="rs", parity_group=4, rs_parity=2)
    base.update(cfg)
    eng = side.engine(n, side.config(
        tiers=(side.storage.disk(str(tmp_path / "tier"), every=every, compress=compress_tier, dedup=dedup,
                                 chunk_bytes=1 << 12 if dedup else 4 << 20),),
        **base,
    ))
    pay = _Payload(n)
    eng.register("domain", side.wrap(pay))
    return eng, pay


def _kill(eng, ranks, revive=False):
    for r in ranks:
        eng.stores[r].wipe()
        if revive:
            eng.stores[r].revive(r)


def _stats(eng, warm: bool = True) -> dict:
    """The engine's LADDER_STATS. ``warm=False`` leaves out the transfer
    skip: when the last capture staged into a bank's fresh arenas, what it
    skipped depends on what the allocator's recycled memory held, on
    either side."""
    return {k: getattr(eng.stats, k) for k in LADDER_STATS if warm or k != "last_transfer_bytes_skipped"}


def _same_data(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x.dtype == y.dtype and x.tobytes() == y.tobytes() for x, y in zip(a, b))


def _tail_header(path: str) -> tuple[dict, int]:
    """A rank file's header pickle (either package's classes) and its offset."""
    raw = open(path, "rb").read()
    header_len, _ = storage._TAIL.unpack(raw[-storage._TAIL.size:])
    off = len(raw) - storage._TAIL.size - header_len
    return pickle.loads(raw[off : off + header_len]), off


def tier_fingerprint(root: str) -> dict:
    """What both packages must write the same: the file layout (the journal
    and the manifests' wall times aside), each rank file's chunk stream and
    header fields, each chunk object's bytes, LATEST, and each generation
    manifest's fields."""
    out: dict = {}
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if f == "journal.jsonl":
                continue
            if f.endswith((".tier", ".delta")):
                header, off = _tail_header(path)
                out[rel] = dict(stream=open(path, "rb").read()[:off],
                                **{k: header.get(k) for k in ("table", "raw_total", "checksum", "compress", "chunks")})
            elif f == "MANIFEST.pkl":
                with open(path, "rb") as fh:
                    man = pickle.load(fh)
                man.pop("wall_time")
                out[rel] = man
            else:
                out[rel] = open(path, "rb").read()
    return out


def both(tmp_path, scenario) -> dict:
    """``scenario(side, dir)`` on the port and on the reference, each in its
    own directory; the two results must be equal. Returns the port's."""
    got = {}
    for side in SIDES:
        d = tmp_path / repr(side)
        d.mkdir()
        got[side.port] = scenario(side, d)
    port, ref = got[True], got[False]
    assert port.keys() == ref.keys()
    for k in port:
        if isinstance(port[k], list) and port[k] and isinstance(port[k][0], np.ndarray):
            assert _same_data(port[k], ref[k]), k
        else:
            assert port[k] == ref[k], k
    return port


# ------------------------------------------------------------------ #
# rank-file format
# ------------------------------------------------------------------ #

def _rank_payload(side, rng):
    return side.host.StorePayload(
        own={"ent": (side.array(rng.integers(0, 255, 100_003, dtype=np.uint8)), "manifest")},
        own_exch={"ent": (side.array(rng.integers(0, 255, 997, dtype=np.uint8)), "sub")},
        parity={0: {("ent", 0, 1): side.array(rng.integers(0, 255, 4099, dtype=np.uint8))}},
        meta={"step": 7, "checksums": {"ent": (1, 2)}, "small": side.array(np.arange(3, dtype=np.int64))},
    )


@pytest.mark.parametrize("compress", [False, True])
def test_rank_file_roundtrip(tmp_path, compress):
    """The round trip, and the file the reference writes for the same
    payload: the same chunk stream, table, raw length and checksum."""
    files = {}
    for side in SIDES:
        payload = _rank_payload(side, np.random.default_rng(0))
        path = str(tmp_path / f"{side!r}.tier")
        nbytes, sums = side.storage.write_rank_file(path, payload, chunk_bytes=1 << 12, compress=compress)
        assert nbytes > 0
        files[side.port] = (nbytes, sums, path)
    (nb, sums, path), (jnb, jsums, jpath) = files[True], files[False]
    assert (nb, sums) == (jnb, jsums)
    (h, off), (jh, joff) = _tail_header(path), _tail_header(jpath)
    assert open(path, "rb").read()[:off] == open(jpath, "rb").read()[:joff]
    assert [(h[k]) for k in ("table", "raw_total", "checksum", "compress")] == \
        [(jh[k]) for k in ("table", "raw_total", "checksum", "compress")]
    payload = _rank_payload(SIDES[0], np.random.default_rng(0))
    out = storage.read_rank_file(path)
    assert torch.equal(out.own["ent"][0], payload.own["ent"][0])
    assert out.own["ent"][1] == "manifest"
    assert torch.equal(out.own_exch["ent"][0], payload.own_exch["ent"][0])
    assert torch.equal(out.parity[0][("ent", 0, 1)], payload.parity[0][("ent", 0, 1)])
    assert out.meta["step"] == 7
    assert torch.equal(out.meta["small"], payload.meta["small"])
    # the payload's tensors are writable views of one arena
    out.own["ent"][0][0] ^= 1
    assert out.own["ent"][0].untyped_storage().data_ptr() == out.parity[0][("ent", 0, 1)].untyped_storage().data_ptr()


@pytest.mark.parametrize("where", ["body", "truncate", "tail"])
def test_rank_file_corruption_detected(tmp_path, where):
    for side in SIDES:
        payload = side.host.StorePayload(own={"e": (side.array(np.arange(65536, dtype=np.uint8) % 251), "m")})
        path = str(tmp_path / f"{side!r}.tier")
        side.storage.write_rank_file(path, payload, chunk_bytes=1 << 12)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            if where == "body":
                f.seek(100)
                f.write(b"\xff" * 32)
            elif where == "truncate":
                f.truncate(size // 2)
            else:
                f.seek(size - 4)
                f.write(b"\x00\x00\x00\x00")
        with pytest.raises(side.integrity.IntegrityError):
            side.storage.read_rank_file(path)


def test_rank_file_odd_blob_sizes_roundtrip(tmp_path):
    """Blob lengths off the 8-byte alignment: the pad folds into the final
    chunk, the stream equals the reference's, and the round trip is exact."""
    streams = {}
    for side in SIDES:
        rng = np.random.default_rng(3)
        payload = side.host.StorePayload(
            own={f"e{k}": (side.array(rng.integers(0, 255, 5000 + k, dtype=np.uint8)), k) for k in range(1, 9)})
        path = str(tmp_path / f"{side!r}.tier")
        side.storage.write_rank_file(path, payload, chunk_bytes=1 << 10)
        out = side.storage.read_rank_file(path)
        for k in range(1, 9):
            assert np.array_equal(np.asarray(out.own[f"e{k}"][0]), np.asarray(payload.own[f"e{k}"][0]))
        header, off = _tail_header(path)
        streams[side.port] = (open(path, "rb").read()[:off], header["table"], header["checksum"])
    assert streams[True] == streams[False]


def test_corrupt_compressed_generation_escalates(tmp_path):
    """Bit-rot inside a zlib-compressed chunk is a corruption verdict (fall
    back to the previous generation), never a crash."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, d, compress_tier=True)
        orig = [x.copy() for x in pay.data]
        assert eng.checkpoint({"step": 1})
        eng._join_flush()
        assert eng.checkpoint({"step": 2})
        eng._join_flush()
        fp = tier_fingerprint(str(d / "tier"))
        tier = eng.persistent_tiers[0]
        newest = tier._gen_dir(tier.generations()[-1])
        victim = sorted(f for f in os.listdir(newest) if f.endswith(".tier"))[0]
        with open(os.path.join(newest, victim), "r+b") as f:
            f.seek(64)
            f.write(b"\xa5" * 16)
        _kill(eng, range(eng.n_ranks))
        for x in pay.data:
            x += 1.0
        meta = eng.restore()
        assert meta["step"] == 1
        assert _same_data(pay.data, orig)
        eng.close()
        return dict(fp=fp, data=pay.data, stats=_stats(eng))

    both(tmp_path, scenario)


def test_latest_pointer_preferred_and_stale_pointer_tolerated(tmp_path):
    eng, _ = _mk_engine(SIDES[0], tmp_path)
    assert eng.checkpoint({"step": 1})
    eng._join_flush()
    assert eng.checkpoint({"step": 2})
    eng._join_flush()
    tier = eng.persistent_tiers[0]
    assert tier._load_order([1, 2]) == [2, 1]     # the pointer names gen 2
    with open(os.path.join(tier.path, "LATEST"), "w") as f:
        f.write("gen-0000000042\n")                # stale pointer: the plain scan
    assert tier._load_order([1, 2]) == [2, 1]
    with open(os.path.join(tier.path, "LATEST"), "w") as f:
        f.write("gen-0000000001\n")
    assert tier._load_order([1, 2]) == [1, 2]
    os.remove(os.path.join(tier.path, "LATEST"))
    assert tier._load_order([1, 2]) == [2, 1]
    eng.close()


# ------------------------------------------------------------------ #
# ladder construction + commit protocol
# ------------------------------------------------------------------ #

def test_build_tiers_implicit_diskless(tmp_path):
    tiers = storage.build_tiers(())
    assert [t.kind for t in tiers] == ["diskless"]
    tiers = storage.build_tiers((storage.disk(str(tmp_path / "d"), every=4),
                                 storage.shared_dir(str(tmp_path / "s"), every=16)))
    assert [t.kind for t in tiers] == ["diskless", "disk", "shared"]
    assert [t.every for t in tiers[1:]] == [4, 16]
    assert storage.disk("x") == storage.TierSpec(**vars(jstorage.disk("x")))
    assert storage.shared_dir("x") == storage.TierSpec(**vars(jstorage.shared_dir("x")))
    with pytest.raises(KeyError):
        storage.build_tiers((storage.TierSpec(kind="tape"),))


def test_flush_commit_protocol_crash_leaves_previous_generation(tmp_path):
    """A crash mid-flush (a stale staging dir) never invalidates the
    committed generations; the next flush collects the wreckage and commits
    atomically on top. The generation written is the reference's."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, d)
        orig = [x.copy() for x in pay.data]
        assert eng.checkpoint({"step": 1})
        eng._join_flush()
        tier = eng.persistent_tiers[0]
        assert tier.generations() == [1]
        # a writer that cannot be alive: Linux pids stay below pid_max, at
        # most 2**22 (a low pid such as 12345 is reused where pid_max is
        # 32768, and a live process holding it keeps its wreck, by design)
        wreck = os.path.join(tier.path, f"gen-0000000099.tmp-{2**22}")
        os.makedirs(wreck)
        with open(os.path.join(wreck, "rank00000.tier"), "wb") as f:
            f.write(b"partial garbage")
        assert tier.generations() == [1]
        assert eng.checkpoint({"step": 2})
        eng._join_flush()
        assert tier.generations() == [1, 2]
        assert not os.path.exists(wreck)
        with open(os.path.join(tier.path, "LATEST")) as f:
            assert f.read().strip() == "gen-0000000002"
        fp = tier_fingerprint(tier.path)
        for x in pay.data:
            x += 3.0
        _kill(eng, range(eng.n_ranks))
        meta = eng.restore()
        assert meta["step"] == 2
        assert _same_data(pay.data, orig)
        eng.close()
        return dict(fp=fp, data=pay.data, stats=_stats(eng))

    both(tmp_path, scenario)


def test_generation_pruning_keeps_newest(tmp_path):
    eng, _ = _mk_engine(SIDES[0], tmp_path)
    for step in range(1, 5):
        assert eng.checkpoint({"step": step})
        eng._join_flush()
    assert eng.persistent_tiers[0].generations() == [3, 4]       # keep=2 (default)
    eng.close()


def test_prune_spares_generation_pinned_by_concurrent_reader(tmp_path, monkeypatch):
    """A generation a live reader is streaming (``.readpin-<pid>``) survives
    pruning until the read finishes; the next flush then reclaims it."""
    eng, _ = _mk_engine(SIDES[0], tmp_path)
    for step in (1, 2):
        assert eng.checkpoint({"step": step})
        eng._join_flush()
    tier = eng.persistent_tiers[0]
    started, release = threading.Event(), threading.Event()
    real_read = storage.read_rank_file

    def slow_read(path, *a, **k):
        started.set()
        assert release.wait(timeout=30)
        return real_read(path, *a, **k)

    monkeypatch.setattr(storage, "read_rank_file", slow_read)
    result: list = []
    reader = threading.Thread(target=lambda: result.append(tier._read_generation(1)), daemon=True)
    reader.start()
    assert started.wait(timeout=30)
    monkeypatch.setattr(storage, "read_rank_file", real_read)
    for step in (3, 4):
        assert eng.checkpoint({"step": step})
        eng._join_flush()
    assert 1 in tier.generations()            # pinned by the live reader
    assert 2 not in tier.generations()
    release.set()
    reader.join(timeout=30)
    payloads, manifest = result[0]
    assert manifest["step"] == 1 and len(payloads) == eng.n_ranks
    assert eng.checkpoint({"step": 5})
    eng._join_flush()
    assert 1 not in tier.generations()
    eng.close()


def test_dead_reader_pin_is_swept(tmp_path):
    eng, _ = _mk_engine(SIDES[0], tmp_path)
    for step in (1, 2, 3):
        assert eng.checkpoint({"step": step})
        eng._join_flush()
    tier = eng.persistent_tiers[0]
    with open(os.path.join(tier._gen_dir(2), ".readpin-999999999"), "w"):
        pass                                  # no such pid
    assert eng.checkpoint({"step": 4})
    eng._join_flush()
    assert tier.generations() == [3, 4]
    eng.close()


def test_chunk_gc_keeps_referenced_and_reclaims_orphans(tmp_path):
    """Refcount GC: past the grace window a pruned generation's own chunks
    go, every chunk a committed generation names stays; the chunk store is
    the reference's object for object, and restores are exact."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, d, dedup=True)
        rng = np.random.default_rng(31)
        for step in (1, 2, 3):
            assert eng.checkpoint({"step": step})
            eng._join_flush()
            for x in pay.data:
                x[: x.size // 16] += rng.standard_normal(x.size // 16).astype(np.float32)
        tier = eng.persistent_tiers[0]
        assert tier.generations() == [2, 3]
        croot = os.path.join(tier.path, "chunks")

        def objects():
            return {e.split(".", 1)[0] for p in os.listdir(croot) for e in os.listdir(os.path.join(croot, p))
                    if os.path.isdir(os.path.join(croot, p))}

        live = tier._chunk_refs(2) | tier._chunk_refs(3)
        orphans = objects() - live
        assert orphans
        for p in os.listdir(croot):
            for e in os.listdir(os.path.join(croot, p)):
                os.utime(os.path.join(croot, p, e), (1, 1))
        assert eng.checkpoint({"step": 4})
        eng._join_flush()
        live = set()
        for gen in tier.generations():
            live |= tier._chunk_refs(gen)
        assert objects() == live
        fp = tier_fingerprint(tier.path)
        last = [x.copy() for x in pay.data]
        _kill(eng, range(eng.n_ranks))
        for x in pay.data:
            x += 1.0
        assert eng.restore()["step"] == 4
        assert _same_data(pay.data, last)
        eng.close()
        return dict(fp=fp, orphans=sorted(orphans), data=pay.data, stats=_stats(eng))

    both(tmp_path, scenario)


# ------------------------------------------------------------------ #
# escalating recovery
# ------------------------------------------------------------------ #

def test_within_tolerance_never_touches_disk(tmp_path, monkeypatch):
    """Failures the codec covers recover in memory: the ladder is the
    fallback, not the fast path."""

    def forbidden(self, engine):
        raise AssertionError("disk tier touched for an in-tolerance failure")

    monkeypatch.setattr(storage.DiskTier, "load", forbidden)
    monkeypatch.setattr(jstorage.DiskTier, "load", forbidden)

    def scenario(side, d):
        eng, pay = _mk_engine(side, d)
        orig = [x.copy() for x in pay.data]
        assert eng.checkpoint({"step": 1})
        eng._join_flush()
        _kill(eng, (1, 2), revive=True)           # 2 <= m in one group
        for x in pay.data:
            x += 1.0
        eng.restore()
        assert eng.stats.tier_escalations == 0 and eng.stats.reconstructed_restores > 0
        assert _same_data(pay.data, orig)
        eng.close()
        return dict(data=pay.data, stats=_stats(eng))

    both(tmp_path, scenario)


@pytest.mark.parametrize("restore_mode", ["pipelined", "sync"])
def test_beyond_tolerance_burst_escalates_bit_identical(tmp_path, restore_mode):
    """m+1 failures in one group exceed rs(m=2): recovery escalates to the
    newest generation on disk and restores every byte."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, d, restore_mode=restore_mode)
        orig = [x.copy() for x in pay.data]
        assert eng.checkpoint({"step": 1})
        eng._join_flush()
        _kill(eng, (0, 1, 2), revive=True)
        for x in pay.data:
            x += 1.0
        eng.restore()
        assert eng.stats.tier_escalations == 1
        assert _same_data(pay.data, orig)
        eng.close()
        return dict(data=pay.data, stats=_stats(eng), fp=tier_fingerprint(str(d / "tier")))

    both(tmp_path, scenario)


def test_cold_start_zero_survivors(tmp_path):
    def scenario(side, d):
        eng, pay = _mk_engine(side, d)
        orig = [x.copy() for x in pay.data]
        assert eng.checkpoint({"step": 1})
        eng._join_flush()
        _kill(eng, range(eng.n_ranks))
        for x in pay.data:
            x += 2.0
        meta = eng.restore()
        assert meta["step"] == 1 and eng.stats.tier_escalations == 1
        assert _same_data(pay.data, orig)
        eng.close()
        return dict(data=pay.data, stats=_stats(eng), step=meta["step"])

    both(tmp_path, scenario)


def test_corrupt_newest_generation_escalates_to_previous(tmp_path):
    def scenario(side, d):
        eng, pay = _mk_engine(side, d)
        orig = [x.copy() for x in pay.data]
        assert eng.checkpoint({"step": 1})
        eng._join_flush()
        assert eng.checkpoint({"step": 2})
        eng._join_flush()
        tier = eng.persistent_tiers[0]
        newest = tier._gen_dir(tier.generations()[-1])
        victim = sorted(f for f in os.listdir(newest) if f.endswith(".tier"))[0]
        with open(os.path.join(newest, victim), "r+b") as f:
            f.seek(64)
            f.write(b"\x00" * 128)
        _kill(eng, range(eng.n_ranks))
        for x in pay.data:
            x += 5.0
        meta = eng.restore()
        assert meta["step"] == 1
        assert _same_data(pay.data, orig)
        eng.close()
        return dict(data=pay.data, stats=_stats(eng), step=meta["step"])

    both(tmp_path, scenario)


def test_incomplete_generation_covered_by_codec(tmp_path):
    """A generation missing one rank's file still loads when the codec can
    rebuild the hole from the flushed stripes."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, d, every=10**9)   # only the flush below
        orig = [x.copy() for x in pay.data]
        assert eng.checkpoint({"step": 1})
        snap = side.storage.capture_snapshot(eng)
        del snap.payloads[5]
        eng.persistent_tiers[0].flush(snap)
        _kill(eng, range(eng.n_ranks))
        for x in pay.data:
            x += 1.0
        eng.restore()
        assert eng.stats.tier_escalations == 1 and eng.stats.reconstructed_restores >= 1
        assert _same_data(pay.data, orig)
        eng.close()
        return dict(data=pay.data, stats=_stats(eng))

    both(tmp_path, scenario)


def test_incomplete_generation_beyond_tolerance_skipped(tmp_path):
    """A generation whose holes exceed the codec's tolerance is skipped for
    an older complete one."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, d)
        orig = [x.copy() for x in pay.data]
        assert eng.checkpoint({"step": 1})
        eng._join_flush()
        snap = side.storage.capture_snapshot(eng)
        for r in (0, 1, 2):
            del snap.payloads[r]
        eng.persistent_tiers[0].flush(snap)
        _kill(eng, range(eng.n_ranks))
        eng.restore()
        assert _same_data(pay.data, orig)
        eng.close()
        return dict(data=pay.data, stats=_stats(eng))

    both(tmp_path, scenario)


def test_cold_restart_n_to_m_elastic(tmp_path):
    """An 8-rank job flushes; a fresh 6-rank engine escalates and
    repartitions through restore_elastic: the merged state is exact."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, d, n=8)
        orig = [x.copy() for x in pay.data]
        assert eng.checkpoint({"step": 3})
        eng._join_flush()
        eng.close()
        eng2 = side.engine(6, side.config(codec="rs", parity_group=4, rs_parity=2,
                                          tiers=(side.storage.disk(str(d / "tier"), every=1),)))
        pay2 = _Payload(8, seed=99)
        eng2.register("domain", side.wrap(pay2))
        meta = eng2.restore_elastic(6)
        assert meta["step"] == 3 and eng2.stats.tier_escalations == 1 and eng2.n_ranks == 6
        assert _same_data(pay2.data, orig)
        eng2.close()
        return dict(data=pay2.data, stats=_stats(eng2))

    both(tmp_path, scenario)


def test_legacy_pickle_fallback(tmp_path):
    """A directory holding only the legacy pickle layout still escalates:
    DiskTier.load falls through to the legacy loader and the migration."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, d, every=10**9)
        orig = [x.copy() for x in pay.data]
        assert eng.checkpoint({"step": 4})
        side.storage.save_to_disk(eng, str(d / "tier"))
        _kill(eng, range(eng.n_ranks))
        for x in pay.data:
            x += 1.0
        meta = eng.restore()
        assert meta["step"] == 4
        assert _same_data(pay.data, orig)
        eng.close()
        return dict(data=pay.data, stats=_stats(eng))

    both(tmp_path, scenario)


def test_legacy_pickle_world_mismatch_resizes_and_corrupt_degrades(tmp_path):
    """A different stored world resizes the engine (the elastic path maps it
    back), and a corrupt index degrades to DataLostError."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, d, n=8, every=10**9)
        orig = [x.copy() for x in pay.data]
        assert eng.checkpoint({"step": 4})
        side.storage.save_to_disk(eng, str(d / "tier"))
        eng.close()
        cfg = side.config(codec="rs", parity_group=4, rs_parity=2,
                          tiers=(side.storage.disk(str(d / "tier"), every=1),))
        eng2 = side.engine(6, cfg)
        pay2 = _Payload(8, seed=7)
        eng2.register("domain", side.wrap(pay2))
        assert eng2.restore_elastic(6)["step"] == 4
        assert _same_data(pay2.data, orig)
        eng2.close()
        with open(str(d / "tier" / "index.pkl"), "wb") as f:
            f.write(b"not a pickle")
        eng3 = side.engine(8, cfg)
        eng3.register("domain", side.wrap(_Payload(8)))
        with pytest.raises(side.dist.DataLostError):
            eng3.restore()
        eng3.close()
        return dict(data=pay2.data, stats=_stats(eng2))

    both(tmp_path, scenario)


def test_no_tier_raises_original_error(tmp_path):
    for side in SIDES:
        eng = side.engine(4, side.config(parity_group=2))
        eng.register("domain", side.wrap(_Payload(4)))
        assert eng.checkpoint({"step": 1})
        _kill(eng, (0, 1), revive=True)           # 2 > xor's tolerance 1
        with pytest.raises(side.dist.DataLostError):
            eng.restore()
        eng.close()


# ------------------------------------------------------------------ #
# background flush semantics
# ------------------------------------------------------------------ #

def _gated_flush(side, monkeypatch):
    gate = threading.Event()
    real_flush = side.storage.DiskTier.flush

    def slow_flush(self, snap):
        gate.wait(timeout=30)
        return real_flush(self, snap)

    monkeypatch.setattr(side.storage.DiskTier, "flush", slow_flush)
    return gate


def test_flush_runs_in_background_and_backpressure_queues(tmp_path, monkeypatch):
    """A cadence point arriving while a flush runs is queued (one slot) and
    chained by the flush worker, not dropped."""

    def scenario(side, d):
        eng, _ = _mk_engine(side, d)
        gate = _gated_flush(side, monkeypatch)
        assert eng.checkpoint({"step": 1})        # stages the flush at the commit
        assert eng._flush_pending is not None and eng._flush_future is None
        eng.kick_tier_flush()
        assert eng._flush_future is not None and not eng._flush_future.done()
        assert eng.checkpoint({"step": 2})        # one in flight: queued
        assert (eng.stats.tier_flush_queued, eng.stats.tier_flush_skipped) == (1, 0)
        assert eng._flush_pending is not None
        gate.set()
        eng._join_flush()
        assert eng.stats.tier_flushes == 2 and eng.persistent_tiers[0].generations() == [1, 2]
        eng.close()
        return dict(stats=_stats(eng), fp=tier_fingerprint(str(d / "tier")))

    both(tmp_path, scenario)


def test_flush_backpressure_skips_only_when_queue_slot_full(tmp_path, monkeypatch):
    """Three due commits against one blocked flush: the first flushes, the
    second queues, the third supersedes the queued snapshot (one skip), and
    the journal records both decisions."""

    def scenario(side, d):
        eng, _ = _mk_engine(side, d)
        gate = _gated_flush(side, monkeypatch)
        assert eng.checkpoint({"step": 1})
        eng.kick_tier_flush()
        assert eng.checkpoint({"step": 2})        # queued
        eng.stats.created += 1                    # commit 3 under the same bank rules
        eng._maybe_flush_tiers()                  # slot full: supersede and skip
        eng.stats.created -= 1
        assert (eng.stats.tier_flush_queued, eng.stats.tier_flush_skipped) == (2, 1)
        assert len(eng.journal.events("flush_queued")) == 2
        assert len(eng.journal.events("flush_skipped")) == 1
        gate.set()
        eng._join_flush()
        assert eng.stats.tier_flushes == 2
        eng.close()
        return dict(stats=_stats(eng))

    both(tmp_path, scenario)


def test_async_flush_with_background_drain_bit_identical(tmp_path):
    """checkpoint_async with a background drain and a due flush, commit
    after commit: the bank-conflict join at capture keeps every flushed
    generation whole (it validates on load)."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, d, async_workers=2)
        states = {}
        for step in range(1, 4):
            assert eng.checkpoint_async({"step": step})
            assert eng.finalize_async() is True
            states[step] = [x.copy() for x in pay.data]
            for x in pay.data:
                x *= 1.1
        eng._join_flush()
        _kill(eng, range(eng.n_ranks))
        step = eng.restore()["step"]
        assert _same_data(pay.data, states[step])
        eng.close()
        return dict(data=pay.data, step=step)

    both(tmp_path, scenario)


# ------------------------------------------------------------------ #
# chunked restore-side decompression
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("workers", [1, 3])
def test_chunked_decompression_bit_identical(tmp_path, workers):
    """The sync and the pipelined restore of a compressed checkpoint give
    the same bytes, on each side, and the sides agree."""

    def scenario(side, d):
        results = {}
        for mode in ("sync", "pipelined"):
            eng = side.engine(4, side.config(compress=True, restore_mode=mode, async_workers=workers,
                                             restore_chunk_bytes=1 << 13))
            pay = _Payload(4, per_rank_bytes=1 << 17)
            eng.register("domain", side.wrap(pay))
            assert eng.checkpoint({"step": 0})
            _kill(eng, (1,), revive=True)
            for x in pay.data:
                x += 1.0
            eng.restore()
            results[mode] = [x.copy() for x in pay.data]
            if mode == "pipelined":
                assert eng.stats.last_restore_decompressed_bytes > 0 and eng.stats.last_restore_chunks > 1
            eng.close()
        assert _same_data(results["sync"], results["pipelined"])
        return dict(data=results["pipelined"])

    both(tmp_path, scenario)


# ------------------------------------------------------------------ #
# per-level Daly schedule
# ------------------------------------------------------------------ #

def test_multilevel_scheduler_flush_every():
    from repro.core import interval as jint_mod
    from repro_torch.core.interval import multilevel_intervals, optimal_interval

    base = CheckpointScheduler(mtbf_s=3600.0, step_time_s=0.1, checkpoint_s=1.0)
    ml = MultiLevelScheduler(base=base, level_mtbf_s=[30 * 24 * 3600.0])
    jml = jint_mod.MultiLevelScheduler(base=jint_mod.CheckpointScheduler(mtbf_s=3600.0, step_time_s=0.1,
                                                                          checkpoint_s=1.0),
                                       level_mtbf_s=[30 * 24 * 3600.0])
    t0 = base.interval_s
    t1 = optimal_interval(30 * 24 * 3600.0, 1.0)
    assert ml.flush_every(1) == max(1, round(t1 / t0)) == jml.flush_every(1)
    for _ in range(4):
        ml.record_flush_duration(1, 25.0)
        jml.record_flush_duration(1, 25.0)
    assert ml.interval_s(1) == optimal_interval(30 * 24 * 3600.0, 25.0) == jml.interval_s(1)
    assert ml.flush_every(1) > max(1, round(t1 / t0)) and ml.flush_every(1) == jml.flush_every(1)
    assert ml.interval_s(0) == base.interval_s
    assert multilevel_intervals([3600.0, 86400.0], [1.0, 10.0]) == [
        optimal_interval(3600.0, 1.0), optimal_interval(86400.0, 10.0)]


# ------------------------------------------------------------------ #
# the Trainer (tests/test_recovery_e2e.py's tier cases)
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def model():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    return build_model(get_config("llama3.2-1b").reduced())


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(model, injector=None, **kw):
    from repro_torch.runtime.failures import FailureInjector
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(**{**oracle.TRAINER_TIERS_CASE, **kw})
    return Trainer(model, tcfg, injector=injector or FailureInjector(tcfg.n_virtual_hosts), device="cpu")


def _state_list(t) -> list:
    from repro_torch.utils.pytree import tree_flatten

    return [x.clone() for x in tree_flatten(t.state)[1]]


def _bitwise(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def reference_state(model, one_thread):
    """The fault-free run's state at step 20."""
    t = _trainer(model)
    t.run(20)
    return _state_list(t)


@pytest.fixture(scope="module")
def jx_tiers(tmp_path_factory):
    from test_torch_device_tier import run_oracle

    return run_oracle("trainer_tiers", tmp_path_factory.mktemp("oracle") / "trainer_tiers.npz")


def test_disk_tier_whole_system_loss(tmp_path, model, reference_state):
    """Every host dies; the disk tier (the legacy ``disk_path`` alias)
    rehydrates the stores and training continues bitwise."""
    from repro_torch.runtime.failures import FailureInjector

    t = _trainer(model, FailureInjector(4, schedule={12: [0, 1, 2, 3]}), n_spares=0,
                 disk_path=str(tmp_path / "disk"), disk_every=1)
    t.run(20)
    t.engine.close()
    assert t.n_recoveries == 1 and t.engine.stats.tier_escalations == 1
    assert _bitwise(_state_list(t), reference_state)


def test_cold_restart_from_tier_ladder_n_to_m(tmp_path, model, reference_state):
    """The job dies mid-run with a disk rung flushing in the background; a
    fresh Trainer on another world size (4 -> 3) cold-restarts from the
    newest generation and finishes bitwise equal to the fault-free run."""
    tier = str(tmp_path / "tier")
    a = _trainer(model, tier_dir=tier, disk_flush_every=1)
    a.run(12)
    a.engine.close()
    assert a.engine.persistent_tiers[0].generations()
    b = _trainer(model, n_virtual_hosts=3, tier_dir=tier, disk_flush_every=1)
    meta = b.cold_restart()
    assert meta["step"] in (5, 10)
    assert b.engine.stats.tier_escalations == 1 and b.engine.n_ranks == 3
    b.run(20)
    b.engine.close()
    assert _bitwise(_state_list(b), reference_state)


def test_beyond_tolerance_burst_recovers_from_tier(tmp_path, model, reference_state):
    """Both members of an xor group die: the burst escalates to the disk
    rung mid-run and the trajectory replays bitwise; the earlier
    in-tolerance failure never touched disk."""
    from repro_torch.runtime.failures import FailureInjector

    t = _trainer(model, FailureInjector(4, schedule={8: [2], 16: [0, 1]}), n_spares=8,
                 tier_dir=str(tmp_path / "tier"), disk_flush_every=1,
                 engine=tckpt.EngineConfig(parity_group=2))
    t.run(20)
    t.engine.close()
    assert t.n_recoveries == 2 and t.engine.stats.tier_escalations == 1
    assert _bitwise(_state_list(t), reference_state)


def _losses(hist) -> list:
    return [h["loss"] for h in hist]


def test_trainer_whole_system_loss_and_cold_restart_match_the_reference(tmp_path, model, jx_tiers, one_thread):
    """The reference's Trainer through TRAINER_TIERS_KILLS and the cold
    4 -> 3 restart against the port's: the same steps, recoveries,
    escalations, restart step and world, losses within rtol 1e-4; the
    port's replayed steps repeat their first pass bit for bit."""
    from repro_torch.runtime.failures import FailureInjector

    _, meta = jx_tiers
    t = _trainer(model, FailureInjector(4, schedule=oracle.TRAINER_TIERS_KILLS),
                 disk_path=str(tmp_path / "disk"), disk_every=1)
    hist = t.run(20)
    t.engine.close()
    want = meta["loss"]
    assert [h["step"] for h in hist] == [s for s, _ in want["history"]]
    np.testing.assert_allclose(_losses(hist), [x for _, x in want["history"]], rtol=1e-4)
    assert (t.n_recoveries, t.engine.stats.tier_escalations) == (want["n_recoveries"], want["escalations"]) == (1, 1)
    first = {h["step"]: h["loss"] for h in hist[:12]}
    assert [h["loss"] for h in hist[12:14]] == [first[10], first[11]]   # the replay, bitwise

    tier = str(tmp_path / "tier")
    a = _trainer(model, tier_dir=tier, disk_flush_every=1)
    first = a.run(12)
    a.engine.close()
    b = _trainer(model, n_virtual_hosts=3, tier_dir=tier, disk_flush_every=1)
    m = b.cold_restart()
    cold = b.run(20)
    b.engine.close()
    want = meta["cold"]
    np.testing.assert_allclose(_losses(first), [x for _, x in want["first"]], rtol=1e-4)
    assert (int(m["step"]), b.engine.n_ranks, b.engine.stats.tier_escalations) == \
        (want["step"], want["n_ranks"], want["escalations"]) == (10, 3, 1)
    assert [h["step"] for h in cold] == [s for s, _ in want["history"]]
    np.testing.assert_allclose(_losses(cold), [x for _, x in want["history"]], rtol=1e-4)
    assert _losses(cold)[:2] == _losses(first)[10:12]   # steps 10 and 11 again, bitwise, on 3 hosts


def test_trainer_retunes_the_flush_cadence_from_the_daly_schedule(tmp_path, model, one_thread):
    """With ``tier_dir`` and no fixed cadence, the per-level Daly schedule
    sets the disk rung's ``every`` after each commit from the measured
    flush time, and carries it across an engine swap."""
    t = _trainer(model, tier_dir=str(tmp_path / "tier"), disk_flush_every=0, recovery_policy="shrink")
    assert t.mlsched is not None and t.engine.persistent_tiers[0].every == 4
    t.run(10)
    t.engine._join_flush()
    tier = t.engine.persistent_tiers[0]
    assert tier.every == t.mlsched.flush_every(1) >= 1
    t._swap_engine(3)
    assert t.engine.persistent_tiers[0].every == tier.every
    t.engine.close()
    tr = _trainer(model, tier_dir=str(tmp_path / "t2"), disk_flush_every=2)
    assert tr.mlsched is None and tr.engine.persistent_tiers[0].every == 2
    tr.engine.close()
