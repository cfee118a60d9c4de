"""The port's differential checkpointing against the JAX package's (mirrors
tests/test_delta.py case for case): the chunk-grid dirty map, the transfer
skip, the incremental parity patch against a full re-encode, delta flushes
through the content-addressed chunk store, and the fall-back when a delta
generation is torn.

As in tests/test_torch_storage.py, every engine scenario runs on the
reference and on the port (``device="cpu"``) from the same seeded numpy
payloads and churn: each side passes the reference test's assertions, and
the two agree exactly on the restored bytes, the stats (``delta_encodes``,
``full_encodes``, ``last_dirty_fraction``, ``last_transfer_bytes_skipped``
wherever the last capture's arenas were warm, the flush and escalation
counters, chunks written and reused) and the tier
directory (chunk streams, checksums, chunk objects). The patched parity is
held byte for byte against a full re-encode of the same data by the port
and against the reference's patched parity, for xor, rs and lrc at dirty
fractions 0.02, 0.1 and 0.3, on the port's ``table``, ``swar`` and ``torch``
(on the CPU) GF(2^8) backends.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import checkpoint as jckpt
from repro.core import gf256 as jgf
from repro.core.integrity import np_checksum as j_np_checksum
from repro_torch.core import gf256
from repro_torch.core.checkpoint import _chunk_checksums, _combine_checksums, _copy_dirty, _merge_chunk_ranges
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.core.integrity import np_checksum
from test_torch_storage import SIDES, _same_data, _stats, both, tier_fingerprint

CODEC_CFGS = {
    "copy": dict(codec="copy"),
    "xor": dict(codec="xor", parity_group=4),
    "rs": dict(codec="rs", parity_group=4, rs_parity=2),
    "lrc": dict(codec="lrc", parity_group=4, rs_parity=2, lrc_locals=2),
}
#: kills within each codec's tolerance (n=8)
CODEC_KILLS = {"copy": (1,), "xor": (1,), "rs": (1, 2), "lrc": (1, 2)}


@pytest.fixture(autouse=True)
def table_backend():
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


def _mk_engine(side, n=8, *, tier=None, dedup=False, every=1, **cfg):
    base = dict(delta=True, delta_chunk_bytes=4096)
    base.update(cfg)
    tiers = ()
    if tier is not None:
        tiers = (side.storage.disk(str(tier), every=every, dedup=dedup, chunk_bytes=1 << 12),)
    eng = side.engine(n, side.config(tiers=tiers, **base))
    pay = _Payload(n)
    eng.register("domain", side.wrap(pay))
    return eng, pay


def _churn(pay, rng, frac=0.05):
    """Rewrite a contiguous ~frac run of each rank's elements in place
    (contiguity keeps the dirty chunk fraction near frac)."""
    for d in pay.data:
        n = max(1, int(d.size * frac))
        start = int(rng.integers(0, max(1, d.size - n + 1)))
        d[start : start + n] += rng.standard_normal(n).astype(np.float32)


def _kill(eng, ranks, revive=True):
    for r in ranks:
        eng.stores[r].wipe()
        if revive:
            eng.stores[r].revive(r)


def _parity_state(eng) -> dict:
    out = {}
    for r, store in eng.stores.items():
        ro = store.buffer.read_only
        if ro is None:
            continue
        for g, stripes in ro.parity.items():
            for key, blob in stripes.items():
                out[(r, g, key)] = np.array(blob).copy()
    return out


# ------------------------------------------------------------------ #
# dirty-map primitives
# ------------------------------------------------------------------ #

def test_chunk_checksum_recombination_matches_whole_buffer():
    rng = np.random.default_rng(0)
    for nbytes in (0, 4, 4096, 4100, 65536, 65540):
        flat = rng.integers(0, 255, nbytes, dtype=np.uint8)
        for step in (4096, 8192):
            parts = _chunk_checksums(torch.from_numpy(flat), step)
            assert parts == jckpt._chunk_checksums(flat, step)
            assert _combine_checksums(parts, step) == np_checksum(flat) == j_np_checksum(flat)


def test_dirty_map_no_false_sharing_at_chunk_boundaries():
    """One dirty byte at a chunk boundary marks exactly that chunk."""
    step = 4096
    a = torch.zeros(3 * step + 100, dtype=torch.uint8)
    for pos, want in ((step, [1]), (step - 1, [0]), (2 * step, [2]), (3 * step, [3]), (0, [0])):
        b = a.clone()
        b[pos] ^= 0xFF
        pa, pb = _chunk_checksums(a, step), _chunk_checksums(b, step)
        assert [i for i, (x, y) in enumerate(zip(pa, pb)) if x != y] == want


def test_merge_chunk_ranges_clips_and_coalesces():
    step = 4096
    for idx, nbytes in (([0, 1], 3 * step), ([0, 2], 3 * step), ([2], 2 * step + 100), ([], 3 * step),
                        ([0, 1, 3, 4, 6], 7 * step - 5)):
        assert _merge_chunk_ranges(idx, step, nbytes) == jckpt._merge_chunk_ranges(idx, step, nbytes)
    assert _merge_chunk_ranges([0, 1], step, 3 * step) == [(0, 2 * step)]
    assert _merge_chunk_ranges([0, 2], step, 3 * step) == [(0, step), (2 * step, 3 * step)]
    assert _merge_chunk_ranges([2], step, 2 * step + 100) == [(2 * step, 2 * step + 100)]
    assert _merge_chunk_ranges([], step, 3 * step) == []


def test_copy_dirty_copies_only_differing_chunks():
    step = 4096
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.integers(0, 255, 4 * step + 77, dtype=np.uint8))
    dst = src.clone()
    src[step + 3] ^= 0x55
    src[4 * step + 10] ^= 0x55
    skipped = _copy_dirty(dst, src, step)
    assert torch.equal(dst, src)
    assert skipped == 3 * step


# ------------------------------------------------------------------ #
# create-side delta path
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("name", list(CODEC_CFGS))
def test_restore_bit_identical_after_delta_commits(tmp_path, name):
    """Four delta commits with sparse churn, then a failure within
    tolerance: the restore is the last committed state, byte for byte."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, **CODEC_CFGS[name])
        rng = np.random.default_rng(7)
        for step in range(1, 5):
            _churn(pay, rng)
            assert eng.checkpoint({"step": step})
            last = [x.copy() for x in pay.data]
        if eng.codec.striped:
            assert eng.stats.delta_encodes > 0 and 0.0 < eng.stats.last_dirty_fraction < 0.5
        parity = _parity_state(eng)
        _kill(eng, CODEC_KILLS[name])
        _churn(pay, rng, frac=1.0)
        assert eng.restore()["step"] == 4
        assert _same_data(pay.data, last)
        eng.close()
        return dict(data=pay.data, stats=_stats(eng), parity=sorted((repr(k), v.tobytes()) for k, v in parity.items()))

    both(tmp_path, scenario)


def test_transfer_skip_counts_clean_chunks(tmp_path):
    def scenario(side, d):
        eng, pay = _mk_engine(side, codec="rs", parity_group=4, rs_parity=2)
        rng = np.random.default_rng(3)
        for step in range(1, 4):
            _churn(pay, rng, frac=0.02)
            assert eng.checkpoint({"step": step})
        # the holder arena holds the same bank's generation g-2: at low churn
        # most chunks arrive unchanged and are not copied again
        assert eng.stats.last_transfer_bytes_skipped > 0
        eng.close()
        return dict(stats=_stats(eng))

    both(tmp_path, scenario)


def test_full_encode_past_dirty_crossover(tmp_path):
    """Churning every byte pushes the dirty fraction past the crossover: a
    full re-encode, not a patch of a mostly new stripe."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, codec="xor", parity_group=4, delta_crossover=0.6)
        rng = np.random.default_rng(5)
        assert eng.checkpoint({"step": 1})
        full_before = eng.stats.full_encodes
        _churn(pay, rng, frac=1.0)
        assert eng.checkpoint({"step": 2})
        assert eng.stats.full_encodes > full_before and eng.stats.last_dirty_fraction > 0.6
        eng.close()
        return dict(stats=_stats(eng, warm=False))

    both(tmp_path, scenario)


def test_delta_off_by_default_and_no_chunk_sums():
    assert EngineConfig().delta is False
    eng = CheckpointEngine(4, EngineConfig(codec="xor", parity_group=2), device="cpu")
    eng.register("domain", SIDES[0].wrap(_Payload(4)))
    assert eng.checkpoint({"step": 1})
    assert "exch_chunk_sums" not in eng.stores[0].buffer.read_only.meta
    assert eng.stats.delta_encodes == 0
    eng.close()


def test_delta_steady_state_reuses_arenas():
    """The dirty map and the patch never disturb arena reuse: once both
    banks are warm, further commits allocate no arena."""
    eng, pay = _mk_engine(SIDES[0], codec="rs", parity_group=4, rs_parity=2)
    rng = np.random.default_rng(11)
    for step in range(1, 5):
        _churn(pay, rng)
        assert eng.checkpoint({"step": step})

    def arenas():
        return {r: {k: (id(v), v.data_ptr()) for k, v in s._arenas.items()} for r, s in eng.stores.items()}, \
            {k: v.data_ptr() for k, v in eng._enc_scratch.items()}

    before = arenas()
    for step in range(5, 9):
        _churn(pay, rng)
        assert eng.checkpoint({"step": step})
    assert arenas() == before
    assert eng.stats.delta_encodes > 0
    eng.close()


def _check_parity_matches_full(name, seed, frac, backend="table"):
    """After a sparse-churn sequence the patched parity stripes equal a full
    encode of the same data (the port's delta engine against its own engine
    with delta off, on ``backend``), and the reference's patched stripes."""
    cfg = CODEC_CFGS[name]
    port, ref = SIDES
    gf256.set_backend(backend)
    eng_d, pay_d = _mk_engine(port, **cfg)
    eng_f, pay_f = _mk_engine(port, **{**cfg, "delta": False})
    eng_j, pay_j = _mk_engine(ref, **cfg)
    rngs = [np.random.default_rng(seed) for _ in range(3)]
    try:
        for step in range(1, 4):
            for pay, rng, eng in zip((pay_d, pay_f, pay_j), rngs, (eng_d, eng_f, eng_j)):
                _churn(pay, rng, frac=frac)
                assert eng.checkpoint({"step": step})
        pd, pf, pj = _parity_state(eng_d), _parity_state(eng_f), _parity_state(eng_j)
        assert pd.keys() == pf.keys() == pj.keys()
        for key in pd:
            assert np.array_equal(pd[key], pf[key]) and np.array_equal(pd[key], pj[key]), key
        assert _stats(eng_d) == _stats(eng_j)
        if frac <= 0.1:
            assert eng_d.stats.delta_encodes > 0 and eng_d.stats.last_delta_ranges > 0
    finally:
        gf256.set_backend("table")
        for eng in (eng_d, eng_f, eng_j):
            eng.close()


@pytest.mark.parametrize("backend", ["table", "swar", "torch"])
@pytest.mark.parametrize("name", ["xor", "rs", "lrc"])
@pytest.mark.parametrize("seed,frac", [(0, 0.02), (1, 0.1), (2, 0.3)])
def test_incremental_parity_bit_identical_to_full_encode(name, seed, frac, backend):
    _check_parity_matches_full(name, seed, frac, backend)


@pytest.mark.parametrize("name", ["xor", "rs", "lrc"])
@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), frac=st.floats(0.0, 0.3))
def test_incremental_parity_property_sweep(name, seed, frac):
    _check_parity_matches_full(name, seed, frac)


# ------------------------------------------------------------------ #
# delta flushes through the chunk store
# ------------------------------------------------------------------ #

def test_dedup_flush_reuses_chunks_across_generations(tmp_path):
    def scenario(side, d):
        eng, pay = _mk_engine(side, tier=d / "tier", dedup=True, codec="rs", parity_group=4, rs_parity=2)
        rng = np.random.default_rng(13)
        assert eng.checkpoint({"step": 1})
        eng._join_flush()
        _churn(pay, rng, frac=0.05)
        assert eng.checkpoint({"step": 2})
        eng._join_flush()
        tier = eng.persistent_tiers[0]
        assert tier.last_dedup is not None and tier.last_dedup["chunks_reused"] > 0
        assert eng.stats.last_flush_chunks_reused > 0 and 0.0 < eng.stats.last_dedup_ratio < 1.0
        fp = tier_fingerprint(tier.path)
        last = [x.copy() for x in pay.data]
        _kill(eng, range(eng.n_ranks), revive=False)
        _churn(pay, rng, frac=1.0)
        assert eng.restore()["step"] == 2
        assert _same_data(pay.data, last)
        eng.close()
        return dict(data=pay.data, stats=_stats(eng, warm=False), fp=fp, dedup=tier.last_dedup["chunks_written"])

    both(tmp_path, scenario)


def test_torn_delta_generation_degrades_to_previous(tmp_path):
    """A delta generation missing a chunk object fails closed: the loader
    falls back to the previous complete generation."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, tier=d / "tier", dedup=True, codec="rs", parity_group=4, rs_parity=2)
        rng = np.random.default_rng(17)
        assert eng.checkpoint({"step": 1})
        eng._join_flush()
        gen1 = [x.copy() for x in pay.data]
        _churn(pay, rng, frac=0.05)
        assert eng.checkpoint({"step": 2})
        eng._join_flush()
        tier = eng.persistent_tiers[0]
        only_gen2 = tier._chunk_refs(2) - tier._chunk_refs(1)
        assert only_gen2
        victim = sorted(only_gen2)[0]
        os.unlink(os.path.join(tier.path, "chunks", victim[:2], victim + ".chunk"))
        _kill(eng, range(eng.n_ranks), revive=False)
        _churn(pay, rng, frac=1.0)
        assert eng.restore()["step"] == 1
        assert _same_data(pay.data, gen1)
        eng.close()
        return dict(data=pay.data, stats=_stats(eng, warm=False), victim=victim)

    both(tmp_path, scenario)


def test_flush_killed_mid_delta_write_keeps_previous_generation(tmp_path, monkeypatch):
    """A flush that dies while streaming delta rank files leaves only the
    invisible staging dir (and orphan chunks inside the GC grace window);
    the committed generation stays loadable and the next flush commits."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, tier=d / "tier", dedup=True, codec="rs", parity_group=4, rs_parity=2)
        assert eng.checkpoint({"step": 1})
        eng._join_flush()
        tier = eng.persistent_tiers[0]
        assert tier.generations() == [1]
        real_write = side.storage.write_rank_delta_file
        calls = {"n": 0}

        def dying_write(path, payload, store, **kw):
            calls["n"] += 1
            if calls["n"] > 3:
                raise OSError("rank died mid-flush")
            return real_write(path, payload, store, **kw)

        monkeypatch.setattr(side.storage, "write_rank_delta_file", dying_write)
        with pytest.raises(OSError):
            tier.flush(side.storage.capture_snapshot(eng))
        monkeypatch.setattr(side.storage, "write_rank_delta_file", real_write)
        assert tier.generations() == [1]
        _churn(pay, np.random.default_rng(19), frac=0.05)
        assert eng.checkpoint({"step": 2})
        eng._join_flush()
        assert tier.generations() == [1, 2]
        last = [x.copy() for x in pay.data]
        _kill(eng, range(eng.n_ranks), revive=False)
        assert eng.restore()["step"] == 2
        assert _same_data(pay.data, last)
        eng.close()
        return dict(data=pay.data, stats=_stats(eng, warm=False))

    both(tmp_path, scenario)


def test_cold_restart_n_to_m_via_chunk_store(tmp_path):
    """An 8-rank job writes two dedup generations; a fresh 6-rank engine
    cold-restarts through the chunk store and repartitions exactly."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, n=8, tier=d / "tier", dedup=True, codec="rs", parity_group=4, rs_parity=2)
        rng = np.random.default_rng(23)
        assert eng.checkpoint({"step": 1})
        eng._join_flush()
        _churn(pay, rng, frac=0.05)
        assert eng.checkpoint({"step": 2})
        eng._join_flush()
        orig = [x.copy() for x in pay.data]
        eng.close()
        eng2 = side.engine(6, side.config(codec="rs", parity_group=4, rs_parity=2,
                                          tiers=(side.storage.disk(str(d / "tier"), every=1, dedup=True),)))
        pay2 = _Payload(8, seed=99)
        eng2.register("domain", side.wrap(pay2))
        assert eng2.restore_elastic(6)["step"] == 2
        assert eng2.stats.tier_escalations == 1
        assert _same_data(pay2.data, orig)
        eng2.close()
        return dict(data=pay2.data, stats=_stats(eng2), fp=tier_fingerprint(str(d / "tier")))

    both(tmp_path, scenario)


def test_escalation_after_delta_commits_clears_incremental_state(tmp_path):
    """After a beyond-tolerance escalation, the next commits re-seed the
    dirty baseline instead of patching against scratch parity that no
    longer matches: restores stay exact."""

    def scenario(side, d):
        eng, pay = _mk_engine(side, tier=d / "tier", dedup=True, codec="rs", parity_group=4, rs_parity=2)
        rng = np.random.default_rng(29)
        for step in range(1, 3):
            _churn(pay, rng)
            assert eng.checkpoint({"step": step})
            eng._join_flush()
        _kill(eng, (0, 1, 2))                      # m+1 in group 0: escalate
        eng.restore()
        assert eng.stats.tier_escalations == 1
        for step in range(3, 6):
            _churn(pay, rng)
            assert eng.checkpoint({"step": step})
        last = [x.copy() for x in pay.data]
        _kill(eng, (1, 2))
        _churn(pay, rng, frac=1.0)
        assert eng.restore()["step"] == 5
        assert _same_data(pay.data, last)
        eng.close()
        return dict(data=pay.data, stats=_stats(eng), parity=sorted(
            (repr(k), v.tobytes()) for k, v in _parity_state(eng).items()))

    both(tmp_path, scenario)


def test_delta_drill_torch_on_the_cpu():
    """``examples/delta_drill_torch.py --device cpu`` passes its own checks:
    delta commits, dedup flushes, a mid-flush kill, a lost chunk object and
    a cold 8 -> 6 restart."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(root / "examples" / "delta_drill_torch.py"), "--device", "cpu"],
                          capture_output=True, text=True, env=env, cwd=root, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert proc.stdout.splitlines()[-1] == "delta drill PASSED"
