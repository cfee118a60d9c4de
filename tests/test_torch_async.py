"""The port's create drain and pipelined restore (the reference's default
engine) against the JAX package's, byte for byte, and the overlapped
checkpoints of the ``Trainer``.

One subprocess runs ``_torch_jax_oracle.async_cases`` on
``repro.core.checkpoint.CheckpointEngine``; the port runs the same cases
here on ``device="cpu"``: the copy codec's mirrors of
``tests/test_async_pipeline.py`` (blocking, foreground and background
creates; sync and pipelined restores over 0, 1 and 4 workers, plain and
int8-compressed; kills at every drain unit and every restore chunk;
corruption caught by the drain's and the restore's VERIFY; multi-worker
drains; ragged worlds), and the striped codecs' (xor, rs, lrc) drains,
restores, mid-restore kills, corrupted stripes and ragged worlds.
Tolerance: exact everywhere. Committed arenas, exchange sets, held copies
and stripes, manifests, handshake and exchange checksums, restored vectors,
engine counters and verdicts must be identical. The ``Trainer`` cases mirror
``tests/test_recovery_e2e.py::test_async_checkpoint_bitwise`` and
``::test_async_checkpoint_fault_during_exchange``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import _torch_jax_oracle as oracle
from repro_torch.configs import get_config
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.core.serialization import pack_bytes, tree_packed_nbytes, unpack_bytes
from repro_torch.launch.steps import numpy_entity
from repro_torch.models import build_model
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.utils.pytree import tree_flatten
from test_torch_device_tier import run_oracle


def _make_engine(n, hook=None, **cfg) -> CheckpointEngine:
    return CheckpointEngine(n, EngineConfig(**cfg), fault_hook=hook, device="cpu")


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return run_oracle("async", tmp_path_factory.mktemp("oracle") / "async.npz")


@pytest.fixture(scope="module")
def port():
    arrays, meta = oracle.async_cases(_make_engine, numpy_entity, lambda t: t.numpy())
    return arrays, json.loads(json.dumps(meta))


def _arrays(arrays: dict, prefix: str) -> dict:
    return {k: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def _same_case(jx, port, tag: str) -> None:
    """The case ``tag`` gives the same metadata and the same bytes on both."""
    (ja, jm), (pa, pm) = jx, port
    assert pm[tag] == jm[tag], tag
    want, got = _arrays(ja, tag), _arrays(pa, tag)
    assert sorted(want) == sorted(got)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def _stores(arrays: dict, meta: dict, tag: str) -> tuple:
    """A case's committed stores, without its tag, for comparisons within
    one engine's results."""
    return meta[tag]["stores"], {k.split("/", len(tag.split("/")))[-1]: v.tobytes()
                                 for k, v in _arrays(arrays, tag).items() if "/restored" not in k}


def _original(n: int) -> np.ndarray:
    return np.stack(oracle.ShardedVec(n).data)


# ---------------------------------------------------------------------------
# zero-copy staging
# ---------------------------------------------------------------------------

def test_pack_bytes_into_arena_is_a_view():
    tree = {"a": torch.arange(10, dtype=torch.float32), "b": torch.tensor(7, dtype=torch.int64),
            "c": torch.arange(6, dtype=torch.int8).reshape(2, 3)[:, :2]}  # non-contiguous
    nbytes = tree_packed_nbytes(tree)
    arena = torch.zeros(nbytes + 16, dtype=torch.uint8)
    flat, man = pack_bytes(tree, out=arena)
    assert flat.data_ptr() == arena.data_ptr() and flat.numel() == nbytes == man.total
    rebuilt = unpack_bytes(flat, man)
    for k in tree:
        assert torch.equal(rebuilt[k], tree[k]), k
    assert torch.equal(flat, pack_bytes(tree)[0])  # the allocating path, bit for bit


@pytest.mark.parametrize("compress", [False, True])
def test_steady_state_checkpoints_reuse_arenas(compress):
    """After the double buffer warms (two checkpoints) every capture leases
    the same arenas, and the bank flip leaves the committed one untouched."""
    eng = _make_engine(4, compress=compress)
    eng.register("state", numpy_entity(oracle.ShardedVec(4)))
    assert eng.checkpoint({"step": 0}) and eng.checkpoint({"step": 1})
    bases = {r: {k: v.data_ptr() for k, v in eng.stores[r]._arenas.items()} for r in range(4)}
    assert eng.checkpoint_async({"step": 2}) and eng.finalize_async() is True
    for r in range(4):
        assert {k: v.data_ptr() for k, v in eng.stores[r]._arenas.items()} == bases[r], r
    eng.stores[1].wipe()
    assert eng.restore()["step"] == 2
    eng.close()


def test_checkpoint_bytes_staged_accounting(jx, port):
    """Own buffers (the vector and its origin scalar, the counter) staged on
    every rank, one drain unit per sharded rank: the reference's numbers."""
    stats = port[1]["create/checkpoint/0"]["stats"]
    assert stats == jx[1]["create/checkpoint/0"]["stats"]
    n = oracle.ASYNC_RANKS
    assert stats["last_bytes_staged"] == n * (oracle.ENGINE_DIM * 4 + 8 + 8)
    assert stats["last_pipeline_chunks"] == n


# ---------------------------------------------------------------------------
# blocking, foreground and background creates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [0, 1])
@pytest.mark.parametrize("how", ["checkpoint", "foreground", "background"])
def test_create_modes_commit_the_reference_bytes(jx, port, how, compress):
    """``checkpoint``, ``checkpoint_async(background=False)`` + finalize and
    the default background drain commit the reference's bytes and restore
    them; all three commit the same stores."""
    tag = f"create/{how}/{compress}"
    _same_case(jx, port, tag)
    pa, pm = port
    assert pm[tag]["ok"] and pm[tag]["step"] == 7 and pm[tag]["counter"] == 7
    assert _stores(pa, pm, tag) == _stores(pa, pm, f"create/checkpoint/{compress}")
    if not compress:
        assert np.array_equal(pa[f"{tag}/restored"], _original(oracle.ASYNC_RANKS))


def test_background_drain_runs_behind_the_caller():
    """``checkpoint_async()`` (``async_workers`` 1) returns once the capture
    is done while the drain waits on a worker; ``drain_done`` reports it,
    and ``finalize_async`` joins and commits."""
    gate, entered = threading.Event(), threading.Event()

    def hook(phase):
        if phase == "pipeline_chunk" and not gate.is_set():
            entered.set()
            assert gate.wait(10)

    eng = _make_engine(4, hook)
    vec = oracle.ShardedVec(4)
    eng.register("state", numpy_entity(vec))
    assert eng.checkpoint_async({"step": 1})
    assert entered.wait(10) and not eng.drain_done()
    for d in vec.data:  # the live state moves on while the drain runs
        d += 1
    gate.set()
    assert eng.finalize_async() is True and eng.drain_done()
    for d in vec.data:
        d -= 100
    eng.stores[2].wipe()
    assert eng.restore()["step"] == 1
    assert np.array_equal(np.stack(vec.data), _original(4))
    eng.close()


@pytest.mark.parametrize("workers", [1, 4])
def test_multiworker_create_drain_bit_identical(jx, port, workers):
    """``async_workers`` 4 shards the drain's units across workers: the
    committed bytes equal the single worker's and the reference's."""
    tag = f"workers/{workers}"
    _same_case(jx, port, tag)
    pa, pm = port
    assert _stores(pa, pm, tag) == _stores(pa, pm, "workers/1")
    assert np.array_equal(pa[f"{tag}/restored"], _original(12))


def test_more_workers_than_cores_under_fast_thread_switches():
    """A drain and a pipelined restore over more workers than the machine
    has cores, the interpreter switching threads every microsecond: the
    committed stores and the restored vectors equal one worker's (a lost
    update to a holder's payload or a checksum table would break them)."""
    n, workers = 24, 4 * (os.cpu_count() or 1)
    results = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for w in (1, workers):
            eng = _make_engine(n, async_workers=w, restore_chunk_bytes=64)
            vec = oracle.ShardedVec(n)
            eng.register("state", numpy_entity(vec))
            t0 = time.monotonic()
            assert eng.checkpoint_async({"step": 1}) and eng.finalize_async() is True
            stores = oracle.dump_engine(eng, lambda t: t.numpy())
            for r in (3, 10, 17):
                eng.stores[r].wipe()
            for d in vec.data:
                d += 1
            assert eng.restore()["step"] == 1
            assert time.monotonic() - t0 < 120
            results.append((stores, np.stack(vec.data)))
            eng.close()
    finally:
        sys.setswitchinterval(switch)
    (a_arr, a_meta), a_vec = results[0]
    (b_arr, b_meta), b_vec = results[1]
    assert a_meta == b_meta and sorted(a_arr) == sorted(b_arr)
    assert all(a_arr[k].tobytes() == b_arr[k].tobytes() for k in a_arr)
    assert np.array_equal(a_vec, b_vec) and np.array_equal(a_vec, _original(n))


# ---------------------------------------------------------------------------
# the commit point: faults inside the drain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kill_chunk", ["0", "1", "2", "background"])
def test_mid_pipeline_kill_preserves_committed_checkpoint(jx, port, kill_chunk):
    """A rank dying at drain unit 0, 1 or 2 (or at unit 1 of a background
    drain) aborts the snapshot at finalize; the committed stores are the
    reference's, and the step-1 checkpoint restores."""
    tag = f"kill/{kill_chunk}"
    _same_case(jx, port, tag)
    pa, pm = port
    assert pm[tag]["captured"] and pm[tag]["finalized"] is False and pm[tag]["step"] == 1
    assert pm[tag]["stats"]["aborted"] == 1
    assert np.array_equal(pa[f"{tag}/restored"], _original(oracle.ASYNC_RANKS))


def test_staged_corruption_caught_by_chunked_verify(jx, port):
    """A staged byte flipped after the capture: the drain's VERIFY aborts."""
    _same_case(jx, port, "staged_corruption")
    got = port[1]["staged_corruption"]
    assert got["ok"] is False and got["stats"]["aborted"] == 1


def test_discard_pending_joins_background_drain(jx, port):
    _same_case(jx, port, "discard")
    got = port[1]["discard"]
    assert got["step"] == 1 and got["stats"]["aborted"] == 1


# ---------------------------------------------------------------------------
# the pipelined restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [0, 1])
@pytest.mark.parametrize("workers", [0, 1, 4])
def test_pipelined_restore_bit_identical_to_sync(jx, port, workers, compress):
    """The chunked restore over 0, 1 and 4 workers lands on the bytes of the
    serial sync restore and of the reference (int8 copies dequantized chunk
    by chunk), with the same recovery counters; a repeat restore is served
    from the plan cache."""
    tags = [f"restore/{mode}/{workers}/{compress}" for mode in ("sync", "pipelined")]
    for tag in tags:
        _same_case(jx, port, tag)
    pa, pm = port
    sync, pipe = tags
    for k in ("first", "restored"):
        assert np.array_equal(pa[f"{sync}/{k}"], pa[f"{pipe}/{k}"])
    keys = ("zero_comm_restores", "adopted_restores")
    assert [pm[sync]["stats"][k] for k in keys] == [pm[pipe]["stats"][k] for k in keys]
    stats = pm[pipe]["stats"]
    assert stats["last_restore_chunks"] > 1 and stats["restore_plan_reuses"] == 1
    assert (stats["last_restore_decompressed_bytes"] > 0) == bool(compress)
    if not compress:
        assert np.array_equal(pa[f"{pipe}/restored"], _original(oracle.ASYNC_RANKS))


def test_restore_reuses_its_plan_and_leases_nothing():
    """Back-to-back restores of one failure: the second is served from the
    plan cache, and adopting whole copies leases no restore arena."""
    eng = _make_engine(8, restore_chunk_bytes=1 << 20)
    vec = oracle.ShardedVec(8)
    eng.register("state", numpy_entity(vec))
    assert eng.checkpoint({"step": 1})
    eng.stores[1].wipe()
    eng.restore()
    before = {r: dict(eng.stores[r]._arenas) for r in range(8)}
    eng.restore()
    assert eng.stats.restore_plan_reuses == 1
    for r in range(8):
        assert eng.stores[r]._arenas.keys() == before[r].keys()
        assert not any(isinstance(k[1], tuple) and k[1][0] == "restore" for k in eng.stores[r]._arenas)
    eng.close()


@pytest.mark.parametrize("mode", ["sync", "pipelined"])
def test_pipelined_restore_elastic_bit_identical(jx, port, mode):
    """``restore_elastic`` 8 -> 6 after a failure recovers through the same
    dispatch: the reference's bytes, equal between the two restore modes."""
    tag = f"elastic/{mode}"
    _same_case(jx, port, tag)
    pa, pm = port
    assert pm[tag]["step"] == 3 and pm[tag]["n_ranks"] == 6
    assert np.array_equal(pa[f"{tag}/restored"], pa["elastic/sync/restored"])


def test_pipelined_restore_ragged_all_failure_combos(jx, port):
    """10 ranks, every single and double loss: restored bit for bit, except
    a rank lost with the holder of its copy (DataLostError), exactly where
    the reference says so."""
    _same_case(jx, port, "ragged")
    got = port[1]["ragged"]
    lost = {k for k, v in got.items() if v is not True}
    assert lost == {f"{r}+{r + 5}" for r in range(5)}
    assert all(v == "DataLostError" for k, v in got.items() if k in lost)


def test_mid_restore_kill_at_every_chunk_leaves_engine_recoverable(jx, port):
    """A survivor dying at any chunk of a serial pipelined restore: the
    restore completes from the copies captured at prep, and a second restore
    recovers the new loss too, both bit for bit."""
    n_chunks = port[1]["restore_kill_chunks"]
    assert n_chunks == jx[1]["restore_kill_chunks"] >= 3
    pa, pm = port
    for k in range(n_chunks):
        tag = f"restore_kill/{k}"
        _same_case(jx, port, tag)
        assert pm[tag]["steps"] == [1, 1]
        for which in ("first", "restored"):
            assert np.array_equal(pa[f"{tag}/{which}"], _original(oracle.ASYNC_RANKS)), (k, which)


@pytest.mark.parametrize("mode", ["sync", "pipelined"])
def test_restore_verify_catches_corrupted_copy(jx, port, mode):
    """A byte of the adopted copy flipped after the commit: the pipelined
    restore's VERIFY raises IntegrityError (the sync restore has no such
    guard), as in the reference."""
    tag = f"restore_corrupt/{mode}"
    _same_case(jx, port, tag)
    assert port[1][tag]["outcome"] == ("IntegrityError" if mode == "pipelined" else 1)


# ---------------------------------------------------------------------------
# the striped codecs (xor, rs, lrc): the same drains and restores
# ---------------------------------------------------------------------------

STRIPED = list(oracle.STRIPED)


@pytest.mark.parametrize("codec", STRIPED)
@pytest.mark.parametrize("workers", [1, 4])
def test_striped_multiworker_drain_bit_identical(jx, port, codec, workers):
    """The drain of a striped codec (encode through the GF backend, stripes
    copied into holder arenas) over 1 or 4 workers: the reference's bytes,
    the same for both worker counts, and every vector back after the kill."""
    tag = f"striped/{codec}/workers/{workers}"
    _same_case(jx, port, tag)
    pa, pm = port
    assert _stores(pa, pm, tag) == _stores(pa, pm, f"striped/{codec}/workers/1")
    assert np.array_equal(pa[f"{tag}/restored"], _original(oracle.STRIPED_RANKS))
    assert pm[tag]["stats"]["reconstructed_restores"] == len(oracle.STRIPED_KILLS[codec])


@pytest.mark.parametrize("codec,compress", [(c, 0) for c in STRIPED] + [("rs", 1)])
@pytest.mark.parametrize("workers", [0, 4])
def test_striped_pipelined_restore_bit_identical_to_sync(jx, port, codec, compress, workers):
    """The chunked decode over 0 and 4 workers gives the serial sync
    decode's bytes and the reference's (under compress the survivors present
    their compressed exchange sets); a repeat restore comes from the plan
    cache."""
    tags = [f"striped/{codec}/restore/{mode}/{workers}/{compress}" for mode in ("sync", "pipelined")]
    for tag in tags:
        _same_case(jx, port, tag)
    pa, pm = port
    sync, pipe = tags
    for k in ("first", "restored"):
        assert np.array_equal(pa[f"{sync}/{k}"], pa[f"{pipe}/{k}"])
    stats = pm[pipe]["stats"]
    assert stats["last_restore_chunks"] > 1 and stats["restore_plan_reuses"] >= 1
    assert stats["reconstructed_restores"] == 2 * len(oracle.STRIPED_KILLS[codec])
    if not compress:
        assert np.array_equal(pa[f"{pipe}/restored"], _original(oracle.STRIPED_RANKS))


def test_striped_mid_restore_kill_at_every_chunk(jx, port):
    """rs: a holder of one of the lost rank's blobs dies at any chunk of a
    serial pipelined restore; the restore completes from the stripes
    captured at prep, and a second restore rebuilds both losses."""
    n_chunks = port[1]["striped/restore_kill_chunks"]
    assert n_chunks == jx[1]["striped/restore_kill_chunks"] >= 3
    pa, pm = port
    for k in range(n_chunks):
        tag = f"striped/restore_kill/{k}"
        _same_case(jx, port, tag)
        assert pm[tag]["steps"] == [1, 1]
        for which in ("first", "restored"):
            assert np.array_equal(pa[f"{tag}/{which}"], _original(oracle.STRIPED_RANKS)), (k, which)


@pytest.mark.parametrize("mode", ["sync", "pipelined"])
def test_striped_verify_catches_a_corrupted_stripe(jx, port, mode):
    """A byte of a held stripe flipped after the commit: the pipelined
    restore's VERIFY of the rebuilt shard raises IntegrityError; the sync
    restore has no such guard. As in the reference."""
    tag = f"striped/restore_corrupt/{mode}"
    _same_case(jx, port, tag)
    assert port[1][tag]["outcome"] == ("IntegrityError" if mode == "pipelined" else 1)


@pytest.mark.parametrize("codec", STRIPED)
def test_striped_ragged_all_failure_combos(jx, port, codec):
    """10 ranks in groups of 4, 4 and 2, every single and double loss: rebuilt
    bit for bit, or DataLostError exactly where the reference raises."""
    tag = f"striped/{codec}/ragged"
    _same_case(jx, port, tag)
    got = port[1][tag]
    assert all(v is True or v == "DataLostError" for v in got.values())
    assert all(got[str(r)] is True for r in range(10))
    if codec != "xor":  # two losses in one group of 4 are within rs and lrc's tolerance
        assert got["1+2"] is True and got["8+9"] is True


# ---------------------------------------------------------------------------
# the Trainer's overlapped checkpoints (tests/test_recovery_e2e.py mirrors)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the reduced model's small ops run faster on one thread
    yield build_model(get_config("llama3.2-1b").reduced())
    torch.set_num_threads(n)


def _tcfg(**kw) -> TrainerConfig:
    base = dict(batch=4, seq=32, total_steps=20, checkpoint_period=5, n_virtual_hosts=4)
    base.update(kw)
    return TrainerConfig(**base)


@pytest.fixture(scope="module")
def fault_free(model):
    t = Trainer(model, _tcfg(), device="cpu")
    t.run(20)
    return tree_flatten(t.state)[1]


def _bitwise(t: Trainer, ref: list) -> bool:
    return all(torch.equal(a, b) for a, b in zip(tree_flatten(t.state)[1], ref))


@pytest.mark.parametrize("alias", [False, True])
def test_async_checkpoint_bitwise(model, fault_free, alias):
    """Overlapped checkpoints (``checkpoint_mode="async"`` or its alias):
    capture at the boundary, drain behind the next step, commit at the
    following barrier; two kills roll back and replay bit for bit."""
    kw = dict(async_checkpoint=True) if alias else dict(checkpoint_mode="async")
    t = Trainer(model, _tcfg(n_spares=4, **kw), injector=FailureInjector(4, schedule={8: [1], 17: [2]}),
                device="cpu")
    t.run(20)
    assert t.n_recoveries == 2 and t.engine.stats.created >= 3
    assert _bitwise(t, fault_free)


def test_async_checkpoint_fault_during_exchange(model, fault_free):
    """A host dying during the second overlapped checkpoint: its drain
    aborts at the next barrier, the previous checkpoint restores, and the
    trajectory replays bit for bit."""
    t = Trainer(model, _tcfg(n_spares=2, checkpoint_mode="async"),
                injector=FailureInjector(4, checkpoint_schedule={1: [0]}), device="cpu")
    t.run(20)
    assert t.n_recoveries >= 1 and t.engine.stats.aborted >= 1
    assert _bitwise(t, fault_free)


def test_trainer_runs_the_reference_default_engine(model):
    assert TrainerConfig().engine == EngineConfig()
    t = Trainer(model, _tcfg(), device="cpu")
    assert t.engine.cfg == EngineConfig() and t.engine.cfg.restore_mode == "pipelined"
    assert t.engine.cfg.async_workers == 1
