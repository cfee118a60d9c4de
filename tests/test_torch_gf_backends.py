"""The port's GF(2^8) backends against the JAX package's ``table`` backend,
byte for byte (mirrors tests/test_gf_backends.py).

Every backend of ``repro_torch.core.gf256`` (``table``, ``swar``, and
``torch`` on the CPU, where the B4 wrapper runs its plain version) on every
coefficient, sub-word misalignments, ragged sources under odd chunk
bounds, accumulate, all-zero rows, more than 16 sources and 8 outputs (the
kernel's limits, so the backend splits), and four threads at once; the
probe's selection rules; and the engine's adaptive restore and encode
planners against the reference's for the same rates. Tolerance: exact.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import pytest
import torch

from repro.core import gf256 as jgf
from repro.core.checkpoint import CheckpointEngine as JEngine
from repro.core.checkpoint import EngineConfig as JConfig
from repro_torch.core import checkpoint as tck
from repro_torch.core import gf256
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.launch.steps import numpy_entity

import _torch_jax_oracle as oracle

BACKENDS = ["table", "swar", "torch"]


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The ``torch`` backend on the CPU (outside this block it asks for the card)."""
    with gf256.compute_device("cpu"):
        yield


def _want(dsts, srcs, mat, lo, hi, accumulate=False):
    """The reference's table backend on fresh copies."""
    outs = [np.array(d, copy=True) for d in dsts]
    jgf.gf_matrix_addmul_into(outs, srcs, mat, lo, hi, accumulate, backend="table")
    return outs


def _run(backend, dsts, srcs, mat, lo, hi, accumulate=False):
    """The port's backend, on CPU tensors over the same bytes."""
    got = [torch.from_numpy(np.array(d, copy=True)) for d in dsts]
    gf256.gf_matrix_addmul_into(got, [torch.from_numpy(s) for s in srcs], mat, lo, hi, accumulate, backend=backend)
    return [g.numpy() for g in got]


def test_the_port_has_the_reference_backends_and_torch():
    assert gf256.available_backends() == ["swar", "table", "torch"]
    assert set(gf256.available_backends()) - {"torch"} <= set(jgf.available_backends())


@pytest.mark.parametrize("backend", BACKENDS)
def test_all_256_coefficients_bit_identical(backend):
    r = np.random.default_rng(1)
    src = r.integers(0, 256, size=4096 + 5, dtype=np.uint8)
    for c in range(256):
        want = _want([np.zeros_like(src)], [src], ((c,),), 0, src.nbytes)[0]
        got = _run(backend, [np.zeros_like(src)], [src], ((c,),), 0, src.nbytes)[0]
        assert np.array_equal(got, want), (backend, c)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("misalign", range(8))
def test_misaligned_segments_bit_identical(backend, misalign):
    """Sources starting 1-7 bytes off the word grid: staged through scratch
    (swar) or into the device rows (torch)."""
    r = np.random.default_rng(2 + misalign)
    base = r.integers(0, 256, size=2048, dtype=np.uint8)
    srcs = [base[misalign : misalign + 1000 + 7 * i] for i in range(3)]
    mat = gf256.cauchy_matrix(2, 3).tolist()
    n = max(s.nbytes for s in srcs)
    want = _want([np.zeros(n, np.uint8)] * 2, srcs, mat, 0, n)
    got = _run(backend, [np.zeros(n, np.uint8)] * 2, srcs, mat, 0, n)
    for g, w in zip(got, want):
        assert np.array_equal(g, w), (backend, misalign)


@pytest.mark.parametrize("backend", BACKENDS)
def test_ragged_sources_and_odd_chunk_bounds(backend):
    """Ragged sources (prefix only) under a prime chunk walk (every bound
    mid-word) assemble the bytes of one full-range call."""
    r = np.random.default_rng(3)
    lens = [10_007, 8_191, 12_288, 1]
    srcs = [r.integers(0, 256, size=n, dtype=np.uint8) for n in lens]
    mat = gf256.cauchy_matrix(3, 4).tolist()
    n = max(lens)
    want = _want([np.zeros(n, np.uint8)] * 3, srcs, mat, 0, n)
    got = [torch.zeros(n, dtype=torch.uint8) for _ in range(3)]
    for lo in range(0, n, 1_013):
        gf256.gf_matrix_addmul_into(got, [torch.from_numpy(s) for s in srcs], mat, lo, min(lo + 1_013, n),
                                    backend=backend)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w), backend


@pytest.mark.parametrize("backend", BACKENDS)
def test_accumulate_mode_bit_identical(backend):
    r = np.random.default_rng(4)
    src = r.integers(0, 256, size=5000, dtype=np.uint8)
    acc0 = r.integers(0, 256, size=5000, dtype=np.uint8)
    want = _want([acc0], [src], ((0x53,),), 0, 5000, accumulate=True)[0]
    got = _run(backend, [acc0], [src], ((0x53,),), 0, 5000, accumulate=True)[0]
    assert np.array_equal(got, want), backend


@pytest.mark.parametrize("backend", BACKENDS)
def test_all_zero_row_zeroes_destination(backend):
    """accumulate=False with a row of zeros overwrites the range with zeros,
    also when no source contributes at all."""
    for mat, srcs in ((((0,),), [np.ones(64, np.uint8)]), (((0, 5),), [np.ones(64, np.uint8), np.ones(0, np.uint8)])):
        got = _run(backend, [np.full(64, 0xAB, np.uint8)], srcs, mat, 0, 64)[0]
        assert not got.any(), backend


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k,m", [(17, 2), (18, 3), (33, 9), (16, 8)])
def test_more_sources_and_outputs_than_one_launch_takes(backend, k, m):
    """The kernel takes at most 16 inputs and 8 outputs: wider products
    (a decode over [survivors ‖ blobs] of g=16, m=2 has 18 columns) split
    into slices, the later source slices XORed in; ragged, misaligned,
    accumulate and overwrite."""
    r = np.random.default_rng(k * 100 + m)
    base = r.integers(0, 256, size=40_000, dtype=np.uint8)
    srcs = [base[i % 5 : i % 5 + 3_001 + 97 * i] for i in range(k)]
    mat = r.integers(0, 256, size=(m, k)).tolist()
    n = max(s.nbytes for s in srcs)
    for accumulate in (False, True):
        init = [r.integers(0, 256, size=n, dtype=np.uint8) for _ in range(m)]
        want = _want(init, srcs, mat, 3, n - 1, accumulate)
        got = _run(backend, init, srcs, mat, 3, n - 1, accumulate)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), (backend, accumulate)


@pytest.mark.parametrize("stage", [4, 1000, 4097])
def test_torch_backend_stages_a_long_range_in_pieces(monkeypatch, stage):
    """A range longer than ``_MAX_STAGE`` runs in pieces (any piece size,
    word-aligned or not, ragged sources ending inside a piece): the bytes
    of one piece."""
    monkeypatch.setattr(gf256._TorchBackend, "_MAX_STAGE", stage)
    r = np.random.default_rng(stage)
    srcs = [r.integers(0, 256, size=n, dtype=np.uint8) for n in (9_000, 4_321, 9_003, 17)]
    mat = gf256.cauchy_matrix(3, 4).tolist()
    for acc in (False, True):
        init = [r.integers(0, 256, size=9_005, dtype=np.uint8) for _ in range(3)]
        want = _want(init, srcs, mat, 5, 9_004, acc)
        got = _run("torch", init, srcs, mat, 5, 9_004, acc)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), acc


def test_torch_backend_from_four_threads_at_once():
    """Four threads, each with its own staging rows, products interleaved:
    every result is the reference's."""
    r = np.random.default_rng(9)
    cases = []
    for t in range(8):
        srcs = [r.integers(0, 256, size=20_000 + 13 * t + i, dtype=np.uint8) for i in range(4)]
        cases.append((srcs, gf256.cauchy_matrix(2, 4).tolist()))

    def work(case):
        srcs, mat = case
        n = max(s.nbytes for s in srcs)
        with gf256.compute_device("cpu"):
            got = _run("torch", [np.zeros(n, np.uint8)] * 2, srcs, mat, 0, n)
        return all(np.array_equal(g, w) for g, w in zip(got, _want([np.zeros(n, np.uint8)] * 2, srcs, mat, 0, n)))

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        assert all(ex.map(work, cases * 2))


@pytest.mark.parametrize("backend", BACKENDS)
def test_rs_encode_decode_match_the_reference(backend, monkeypatch):
    """``rs_encode``/``rs_decode`` through a forced backend: the reference's
    blobs byte for byte, and the lost buffers rebuilt (zero-padded)."""
    monkeypatch.setenv("REPRO_GF_BACKEND", backend)
    r = np.random.default_rng(5)
    k, m = 4, 2
    C = gf256.cauchy_matrix(m, k)
    bufs = [r.integers(0, 256, size=9_001 - 3 * i, dtype=np.uint8) for i in range(k)]
    blobs = gf256.rs_encode([torch.from_numpy(b) for b in bufs], m, C)
    want = jgf.rs_encode(bufs, m, C)
    assert all(np.array_equal(b.numpy(), w) for b, w in zip(blobs, want))
    rebuilt = gf256.rs_decode({0: torch.from_numpy(bufs[0]), 3: torch.from_numpy(bufs[3])},
                              {0: blobs[0], 1: blobs[1]}, [1, 2], k, C)
    want = jgf.rs_decode({0: bufs[0], 3: bufs[3]}, {0: want[0], 1: want[1]}, [1, 2], k, C)
    for i in (1, 2):
        assert np.array_equal(rebuilt[i].numpy(), want[i])
        assert np.array_equal(rebuilt[i][: bufs[i].nbytes].numpy(), bufs[i])


def test_selection_order_and_unknown_names(monkeypatch):
    """set_backend > REPRO_GF_BACKEND > the probe; unknown names raise."""
    with pytest.raises(KeyError):
        gf256.set_backend("no-such-backend")
    monkeypatch.setenv("REPRO_GF_BACKEND", "table")
    assert gf256.active_backend_name() == "table"
    gf256.set_backend("swar")
    try:
        assert gf256.active_backend_name() == "swar"
    finally:
        gf256.set_backend(None)


def test_probe_times_numpy_backends_and_skips_torch_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(gf256, "_PROBE_GBPS", {})
    best = gf256._probe_backends()
    assert best in ("table", "swar") and set(gf256._PROBE_GBPS) == {"table", "swar"}
    assert all(v > 0 for v in gf256._PROBE_GBPS.values())


def test_probe_does_not_swallow_a_failure_of_the_torch_backend(monkeypatch):
    """On a card, a build or launch failure of the torch backend fails the
    probe; it never quietly loses to numpy."""
    def broken(*a, **k):
        raise RuntimeError("CUDA kernel rs_decode failed to launch (status 209)")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self, *a: self)
    monkeypatch.setattr(gf256._BACKENDS["torch"], "matrix_into", broken)
    monkeypatch.setattr("repro_torch.sharding.mesh.resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(gf256, "_PROBE_GBPS", {})
    with pytest.raises(RuntimeError, match="failed to launch"):
        gf256._probe_backends()


def test_torch_backend_asks_for_the_card_outside_an_engine(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = np.ones(64, np.uint8)
    monkeypatch.setattr(gf256._DEVICE, "device", None)  # outside any compute_device block
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gf256.gf_matrix_addmul_into([np.zeros(64, np.uint8)], [src], ((3,),), backend="torch")


def test_mul_table_cache_thread_safety_and_bound():
    def work(seed: int) -> bool:
        r = np.random.default_rng(seed)
        for _ in range(64):
            c, x = int(r.integers(0, 256)), int(r.integers(0, 256))
            if int(gf256.mul_table(c)[x]) != jgf.gf_mul(c, x):
                return False
        return True

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        assert all(ex.map(work, range(16)))
    assert len(gf256._MUL_TABLES) <= 256


def test_addmul_helpers_match_the_reference():
    r = np.random.default_rng(6)
    buf = r.integers(0, 256, size=70_000, dtype=np.uint8)
    for c in (0, 1, 2, 0x8E, 255):
        a0 = r.integers(0, 256, size=70_003, dtype=np.uint8)
        for fn_t, fn_j in ((gf256.gf_addmul_into, jgf.gf_addmul_into), (gf256.gf_addmul_fast, jgf.gf_addmul_fast)):
            a, b = a0.copy(), a0.copy()
            fn_t(a, c, buf)
            fn_j(b, c, buf)
            assert np.array_equal(a, b), c
        assert np.array_equal(gf256.gf_mul_fast(c, buf), jgf.gf_mul_fast(c, buf))
        assert np.array_equal(gf256.mul_table(c), jgf.mul_table(c))


# ---------------------------------------------------------------------------
# the engine's planners
# ---------------------------------------------------------------------------

def _vec_engine(n=4, **cfg) -> CheckpointEngine:
    eng = CheckpointEngine(n, EngineConfig(codec="rs", parity_group=2, **cfg), device="cpu")
    eng.register("state", numpy_entity(oracle.ShardedVec(n, 64)))
    return eng


def test_planner_zero_byte_entity():
    class EmptyVec(oracle.ShardedVec):
        def __init__(self, n):
            super().__init__(n)
            self.data = [np.zeros(0, np.float32) for _ in range(n)]

    eng = CheckpointEngine(4, EngineConfig(codec="rs", parity_group=2), device="cpu")
    vec = EmptyVec(4)
    eng.register("state", numpy_entity(vec))
    assert eng.checkpoint({"step": 1})
    eng.stores[1].wipe()
    eng.restore()
    assert all(d.nbytes == 0 for d in vec.data)
    eng.close()


def test_planner_crossover_boundary():
    """Under the crossover the restore takes the sync path (no chunks); a
    pinned chunk size forces the pipeline; both give the same bytes."""
    results = {}
    for cb in (0, 1 << 20):
        eng = CheckpointEngine(4, EngineConfig(codec="rs", parity_group=2, restore_chunk_bytes=cb), device="cpu")
        vec = oracle.ShardedVec(4, 64)
        eng.register("state", numpy_entity(vec))
        assert eng.checkpoint({"step": 1})
        assert eng._estimate_restore_bytes() <= eng._sync_crossover_bytes()
        eng.stores[1].wipe()
        before = eng.stats.last_restore_chunks
        eng.restore()
        results[cb] = ([d.copy() for d in vec.data], eng.stats.last_restore_chunks, before)
        eng.close()
    (d_auto, chunks_auto, before_auto), (d_pin, chunks_pin, _) = results[0], results[1 << 20]
    assert all(np.array_equal(a, b) for a, b in zip(d_auto, d_pin))
    assert chunks_auto == before_auto and chunks_pin >= 1


def test_planner_rate_observation_updates_registry():
    eng = _vec_engine(restore_chunk_bytes=1 << 13)
    assert eng.checkpoint({"step": 1})
    eng.stores[1].wipe()
    eng.restore()
    assert eng._h_restore_rate.stats(codec=eng.codec.name)["count"] >= 1
    assert eng._decode_rate() > 0 and tck._DECODE_RATE["rs"] > 0
    eng.close()


def test_explicit_chunk_bytes_disables_collapse():
    eng = _vec_engine(restore_chunk_bytes=256)
    assert eng.checkpoint({"step": 1})
    eng.stores[1].wipe()
    eng.restore()
    assert eng.stats.last_restore_chunks > 1
    eng.close()


def test_rate_seeds_come_from_the_probe(monkeypatch):
    """With no measured rate a planner starts from the probe's rate / 4,
    as the reference's does (``DECODE_RATE_SEED`` is gone)."""
    monkeypatch.setattr(tck, "_DECODE_RATE", {})
    monkeypatch.setattr(tck, "_ENCODE_RATE", {})
    eng = _vec_engine()
    assert not hasattr(tck, "DECODE_RATE_SEED")
    seed = max(gf256.probed_gbps() * 1e9 / 4.0, 1e6)
    assert eng._decode_rate() == eng._encode_rate() == seed


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("rate", [1e5, 3e8, 7.7e9, 1e12])
def test_planner_chunk_sizes_match_the_reference(monkeypatch, workers, rate):
    """The encode and restore planners give the reference's chunk sizes and
    crossover for the same measured rates (and explicit chunk bytes)."""
    from repro.core import checkpoint as jck

    for mod in (tck, jck):
        monkeypatch.setattr(mod, "_DECODE_RATE", {"rs": rate})
        monkeypatch.setattr(mod, "_ENCODE_RATE", {"rs": rate})
    for cb in (0, 1000):
        kw = dict(codec="rs", parity_group=2, async_workers=workers, encode_chunk_bytes=cb)
        port = CheckpointEngine(4, EngineConfig(**kw), device="cpu")
        ref = JEngine(4, JConfig(**kw))
        assert port._plan_encode_step() == ref._plan_encode_step()
        assert port._plan_chunk_step() == ref._plan_chunk_step()
        assert port._sync_crossover_bytes() == ref._sync_crossover_bytes()
