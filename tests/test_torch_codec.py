"""The port's redundancy-codec layer against the JAX package's, byte for byte
(mirrors tests/test_codec.py).

In one process, on the same seeded numpy bytes: the GF(2^8) generators and
decode matrices; the xor, rs and lrc blobs (``encode`` and the arena form
``encode_into``); every failure combination each codec tolerates (lrc: up
to l+g, where the reference decodes beyond its guarantee), with every
surviving blob subset that suffices and ragged last groups, rebuilt by
``decode`` and by the chunked ``decode_into`` under odd chunk bounds;
``blobs_needed``; the recovery plans; the memory overheads; the registry.
Then both engines (the port's on ``device="cpu"``) through checkpoint,
wipes and restore under each codec: the same committed stores, the same
restored bytes, and DataLostError exactly where the reference raises.
Tolerance: exact.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import distribution as jdist
from repro.core import gf256 as jgf
from repro.core.checkpoint import CheckpointEngine as JEngine
from repro.core.checkpoint import EngineConfig as JConfig
from repro_torch.core import codec as tcodec
from repro_torch.core import distribution as tdist
from repro_torch.core import gf256
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.core.distribution import DataLostError
from repro_torch.launch.steps import numpy_entity

import _torch_jax_oracle as oracle

# (tag, codec name, args): groups of 4-6, rs with 1-3 parities, lrc with 1-3 locals
CODECS = [
    ("xor4", "XorCodec", (4,)),
    ("rs4-2", "RSCodec", (4, 2)),
    ("rs4-3", "RSCodec", (4, 3)),
    ("rs5-1", "RSCodec", (5, 1)),
    ("lrc4-2-2", "LRCCodec", (4, 2, 2)),
    ("lrc6-3-2", "LRCCodec", (6, 3, 2)),
    ("lrc5-2-1", "LRCCodec", (5, 2, 1)),
]
TAGS = [c[0] for c in CODECS]


def _pair(tag: str):
    _, cls, args = next(c for c in CODECS if c[0] == tag)
    return getattr(tcodec, cls)(*args), getattr(jcodec, cls)(*args)


def _bufs(k: int, seed: int) -> list[np.ndarray]:
    """k ragged group buffers (the padded blob length is their 4-aligned max)."""
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, size=1000 - 37 * i + (i % 2), dtype=np.uint8) for i in range(k)]


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x)


def _same(a, b) -> bool:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.dtype == np.asarray(b).dtype and a.tobytes() == np.asarray(b).tobytes()


@pytest.fixture(autouse=True)
def numpy_backend_pinned_to_table():
    """Both packages through their oracle backend (the port's other backends
    have their own tests), and the port's torch backend on the CPU."""
    gf256.set_backend("table")
    jgf.set_backend("table")
    with gf256.compute_device("cpu"):
        yield
    gf256.set_backend(None)
    jgf.set_backend(None)


def test_field_generators_and_decode_matrices_match():
    assert np.array_equal(gf256.EXP_TABLE, jgf.EXP_TABLE) and np.array_equal(gf256.LOG32, jgf.LOG32)
    for m, k in ((1, 1), (2, 4), (3, 5), (8, 16), (2, 200)):
        assert np.array_equal(gf256.cauchy_matrix(m, k), jgf.cauchy_matrix(m, k))
    for args in ((4, 2, 2), (6, 3, 2), (5, 2, 1), (3, 5, 2)):
        assert np.array_equal(tcodec.lrc_generator(*args), jcodec.lrc_generator(*args))
    coef = gf256.cauchy_matrix(3, 5)
    for e in (1, 2, 3):
        for missing in itertools.combinations(range(5), e):
            present = [i for i in range(5) if i not in missing]
            for rows in itertools.combinations(range(3), e):
                want = jgf.erasure_decode_matrix(5, coef, present, list(rows), list(missing))
                assert np.array_equal(gf256.erasure_decode_matrix(5, coef, present, list(rows), list(missing)), want)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("short", [0, 1])
def test_blobs_match_the_reference(tag, short):
    """encode, encode_into (into leased accumulators holding garbage) and
    encode_matrix, on a full group and on a ragged last group one short."""
    port, ref = _pair(tag)
    k = port.group - short
    bufs = _bufs(k, seed=k)
    n_out = ref.n_blobs(k)
    assert port.n_blobs(k) == n_out and port.tolerance() == ref.tolerance()
    want = ref.encode(bufs, n_out)
    got = port.encode([_t(b) for b in bufs], n_out)
    assert len(got) == len(want) and all(_same(g, w) for g, w in zip(got, want))
    arenas = {}

    def lease(b, nbytes):
        return arenas.setdefault(b, torch.full((nbytes,), 0xCD, dtype=torch.uint8))

    got = port.encode_into([_t(b) for b in bufs], n_out, lease)
    assert all(_same(g, w) for g, w in zip(got, want))
    assert all(g.data_ptr() == arenas[b].data_ptr() for b, g in enumerate(got))
    assert np.array_equal(port.encode_matrix(k), ref.encode_matrix(k))


def _combos(port, k: int):
    """(missing, surviving blob set) pairs: every loss set up to the
    codec's tolerance (lrc: up to l+g) with every blob subset at least as
    large as the losses."""
    n_blobs = port.n_blobs(k)
    reach = n_blobs if port.name == "lrc" else port.tolerance()
    for e in range(1, min(reach, k) + 1):
        for missing in itertools.combinations(range(k), e):
            for nb in range(e, n_blobs + 1):
                for keep in itertools.combinations(range(n_blobs), nb):
                    yield list(missing), list(keep)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("short", [0, 1])
def test_every_failure_combination_rebuilds_as_the_reference(tag, short):
    """decode, decode_into under odd chunk bounds, blobs_needed and the
    repair-read count equal the reference's for every combination; where the
    reference cannot decode, the port raises CodecDecodeError too; what is
    rebuilt is the lost buffer, zero-padded."""
    port, ref = _pair(tag)
    k = port.group - short
    bufs = _bufs(k, seed=11 + k)
    blobs_np = ref.encode(bufs, ref.n_blobs(k))
    blobs_t = [_t(b.copy()) for b in blobs_np]
    n_ok = 0
    for missing, keep in _combos(port, k):
        present = [i for i in range(k) if i not in missing]
        assert port.blobs_needed(present, keep, missing) == ref.blobs_needed(present, keep, missing)
        p_np = {i: bufs[i] for i in present}
        try:
            want = ref.decode(p_np, {j: blobs_np[j] for j in keep}, missing)
        except jcodec.CodecDecodeError:
            with pytest.raises(tcodec.CodecDecodeError):
                port.decode({i: _t(bufs[i]) for i in present}, {j: blobs_t[j] for j in keep}, missing)
            continue
        p_t = {i: _t(bufs[i]) for i in present}
        b_t = {j: blobs_t[j] for j in keep}
        got = port.decode(p_t, b_t, missing)
        arenas = {}
        into, chunk = port.decode_into(p_t, b_t, missing,
                                       lambda i, nb: arenas.setdefault(i, torch.full((nb,), 7, dtype=torch.uint8)))
        n = max(b.numel() for b in b_t.values())
        for lo in range(0, n, 300):
            chunk(lo, min(lo + 300, n))
        if port.name != "xor" and ref.name != "xor":
            ref.decode_into(p_np, {j: blobs_np[j] for j in keep}, missing, lambda i, nb: np.empty(nb, np.uint8))
            assert port.last_decode_reads == ref.last_decode_reads
        for i in missing:
            assert _same(got[i], want[i]) and _same(into[i], want[i]), (missing, keep, i)
            assert _same(got[i][: bufs[i].nbytes], bufs[i])
        n_ok += 1
    assert n_ok > 0
    assert port.decode_chunked() and not tcodec.RedundancyCodec().decode_chunked()


def test_lrc_single_loss_reads_its_subgroup_only():
    port, _ = _pair("lrc6-3-2")
    bufs = [_t(b) for b in _bufs(6, 3)]
    blobs = port.encode(bufs, port.n_blobs(6))
    present = {i: bufs[i] for i in range(6) if i != 4}
    assert port.blobs_needed(sorted(present), list(range(5)), [4]) == {2}  # subgroup {4, 5}'s local parity
    port.decode(present, dict(enumerate(blobs)), [4])
    assert port.last_decode_reads == 2  # member 5 and the local parity


@pytest.mark.parametrize("name,args", [("XorCodec", (4,)), ("RSCodec", (4, 2)), ("LRCCodec", (4, 2, 2)),
                                       ("CopyCodec", ("pairwise", 1)), ("CopyCodec", ("neighbor", 2))])
@pytest.mark.parametrize("n", [4, 8, 10, 12])
def test_recovery_plans_match_the_reference(name, args, n):
    """codec_recovery_plan over every single and double failure: the same
    plan, or DataLostError on both sides."""
    port, ref = getattr(tcodec, name)(*args), getattr(jcodec, name)(*args)
    for failed in itertools.chain(itertools.combinations(range(n), 1), itertools.combinations(range(n), 2)):
        try:
            want = jcodec.codec_recovery_plan(n, set(failed), ref)
        except jdist.DataLostError:
            with pytest.raises(DataLostError):
                tcodec.codec_recovery_plan(n, set(failed), port)
            continue
        assert tcodec.codec_recovery_plan(n, set(failed), port) == want, failed
    for g in (1, 2, 3, 4):
        for failed in ({0}, {1}, {0, 1}, {n - 1}):
            try:
                want = jdist.parity_recovery_plan(n, failed, g)
            except jdist.DataLostError:
                want = "lost"
            try:
                got = tdist.parity_recovery_plan(n, failed, g)
            except DataLostError:
                got = "lost"
            assert got == want, (g, failed)


def test_memory_overheads_match_the_reference():
    for name, args in [("XorCodec", (4,)), ("RSCodec", (4, 2)), ("LRCCodec", (4, 2, 2)), ("LRCCodec", (6, 3, 2)),
                       ("CopyCodec", ("pairwise", 1)), ("CopyCodec", ("pairwise", 2))]:
        port, ref = getattr(tcodec, name)(*args), getattr(jcodec, name)(*args)
        for k in (1, 2, 3, 4, 6):
            for n in (1, 2, 8, 12):
                assert port.memory_overhead(k, n) == ref.memory_overhead(k, n), (name, k, n)


def test_make_codec_legacy_inference_and_registry():
    assert tcodec.make_codec(EngineConfig()).name == "copy"
    assert tcodec.make_codec(EngineConfig(parity_group=4)).name == "xor"
    assert tcodec.make_codec(EngineConfig(codec="rs", parity_group=4)).name == "rs"
    lrc = tcodec.make_codec(EngineConfig(codec="lrc", parity_group=6, lrc_locals=3, rs_parity=1))
    assert (lrc.name, lrc.local, lrc.global_parity) == ("lrc", 3, 1)
    with pytest.raises(KeyError):
        tcodec.get_codec("nope")
    for name in ("xor", "rs", "lrc"):
        with pytest.raises(ValueError):
            tcodec.make_codec(EngineConfig(codec=name))


def test_codec_interface_is_abstract():
    c = tcodec.RedundancyCodec()
    for call in (lambda: c.group_size(4), lambda: c.n_blobs(4), lambda: c.tolerance(),
                 lambda: c.encode([], 1), lambda: c.placement([], 0, 4), lambda: c.decode({}, {}, [])):
        with pytest.raises(NotImplementedError):
            call()


# ---------------------------------------------------------------------------
# both engines under each codec
# ---------------------------------------------------------------------------

RS = dict(codec="rs", parity_group=4, rs_parity=2)
ENGINE_CASES = [
    ("xor", dict(parity_group=4), 8, [(1,), (6,), (1, 6), (1, 2)]),
    ("rs", RS, 8, [(0,), (1, 2), (5, 7), (0, 1, 2)]),
    ("rs-ragged", RS, 10, [(9,), (8, 9), (3, 8)]),
    ("rs-cross", RS, 12, [(0, 5), (4, 8), ()]),
    ("rs-m3", dict(codec="rs", parity_group=4, rs_parity=3), 16, [(4, 5, 6)]),
    ("lrc", dict(codec="lrc", parity_group=4), 8, [(2,), (0, 1), (1, 2), (4, 7)]),
    ("lrc-6-3", dict(codec="lrc", parity_group=6, lrc_locals=3), 12, [(5,), (0, 4), (6, 7)]),
    ("xor-ragged", dict(parity_group=3), 7, [(6,), (0,), (3, 6)]),
]


def _engine_roundtrip(make, wrap, n, cfg, kills):
    eng = make(n, cfg)
    vec = oracle.ShardedVec(n, 300)
    eng.register("state", wrap(vec))
    eng.register("counter", wrap(oracle.Counter()))
    assert eng.checkpoint({"step": 1})
    orig = [d.copy() for d in vec.data]
    for d in vec.data:
        d += 999.0
    for r in kills:
        eng.stores[r].wipe()
    try:
        eng.restore()
    except Exception as e:  # noqa: BLE001 - the class name is the result
        return eng, type(e).__name__
    return eng, all(np.array_equal(vec.data[r], orig[r]) for r in range(n))


@pytest.mark.parametrize("backend", ["table", "torch"])
@pytest.mark.parametrize("mode", ["sync", "pipelined"])
@pytest.mark.parametrize("tag", [c[0] for c in ENGINE_CASES])
def test_engines_commit_and_restore_as_the_reference(tag, mode, backend):
    """The committed stores (own arenas, exchange sets, held stripes,
    manifests, checksums) and the restore's outcome and counters equal the
    reference engine's for each kill set, the port's GF products through
    ``backend`` (``torch``: B4's wrapper, on the CPU its plain version); a
    restore within tolerance gives back every vector exactly."""
    _, cfg, n, kill_sets = next(c for c in ENGINE_CASES if c[0] == tag)
    kw = dict(cfg, restore_mode=mode, restore_chunk_bytes=256 if mode == "pipelined" else 0)
    for kills in kill_sets:
        port, got = _engine_roundtrip(
            lambda n, c: CheckpointEngine(n, EngineConfig(**c, gf_backend=backend), device="cpu"),
            numpy_entity, n, kw, kills)
        ref, want = _engine_roundtrip(lambda n, c: JEngine(n, JConfig(**c)), lambda e: e, n, kw, kills)
        assert got == want, kills
        if want is True:
            assert got is True
        pa, pm = oracle.dump_engine(port, lambda t: t.numpy())
        ja, jm = oracle.dump_engine(ref, np.asarray)
        assert pm == jm and sorted(pa) == sorted(ja), kills
        assert all(_same(pa[k], ja[k]) for k in ja), kills
        for stat in ("zero_comm_restores", "adopted_restores", "reconstructed_restores"):
            assert getattr(port.stats, stat) == getattr(ref.stats, stat), (kills, stat)
        port.close()
        ref.close()


def test_custom_codec_registration_dispatches():
    """A user codec (the same XOR blob twice, on two neighbor groups) plugs
    in through register_codec and the engine runs it unchanged."""

    class DoubleXor(tcodec.XorCodec):
        name = "xor2"

        def n_blobs(self, group_size):
            return 2

        def encode(self, bufs, n_out):
            blob = super().encode(bufs, 1)[0]
            return [blob, blob.clone()]

        def decode(self, present, blobs, missing):
            return super().decode(present, {0: blobs[min(blobs)]} if blobs else {}, missing)

    tcodec.register_codec("xor2", lambda cfg: DoubleXor(cfg.parity_group or 4))
    try:
        for kills in ((5,), (1, 4)):  # one blob-holder group dead: the second blob saves it
            eng, ok = _engine_roundtrip(
                lambda n, c: CheckpointEngine(n, EngineConfig(**c), device="cpu"), numpy_entity, 12,
                dict(codec="xor2", parity_group=4, restore_chunk_bytes=512), kills)
            assert ok is True and eng.codec.name == "xor2"
            assert not eng.codec.decode_chunked() and eng.codec.encode_matrix(4) is None
    finally:
        tcodec._CODECS.pop("xor2", None)
