"""The device tier over processes, against the JAX package's per-device
payloads, byte for byte.

One pool of 8 gloo processes on the CPU (``repro_torch.launch.mesh.spawn``,
a ``file://`` rendezvous) runs every case once, on the (4, 2) ("data",
"model") mesh of the reference's run and on an (8, 1) mesh of the same
processes, and hands back each process's payloads, byte counts and restore
outcomes. The reference's payloads come from the device-tier oracle run
that ``tests/test_torch_device_tier.py`` makes (8 virtual CPU devices in a
child process), shared, not run twice: each process's payload is held
against its coordinate's slice of the reference's global one. On the (8, 1)
mesh, which the oracle does not run, the one-card program stands in (it is
itself held against the reference there). Every comparison is exact.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
import _torch_jax_oracle as oracle
from test_torch_device_tier import shared_oracle
from repro_torch.core import device_tier as dt
from repro_torch.launch.mesh import check_backend, init_process_mesh, spawn
from repro_torch.launch.steps import state_from_numpy
from repro_torch.sharding.mesh import make_mesh

WORLD = 8
SIZES42 = {"data": 4, "model": 2}
SIZES81 = {"data": 8, "model": 1}
CASES = oracle.CASES
STRIPED42 = [c for c in CASES if c[1] != "copy"]
# the (8, 1) mesh: g = 4 (rs, xor, lrc), and a ragged rs g = 3 (groups {0,1,2}, {3,4,5}, {6,7})
CASES81 = (("copy", "copy", 0, 2), ("xor4", "xor", 4, 1), ("rs4", "rs", 4, 2), ("rs3", "rs", 3, 2),
           ("lrc4", "lrc", 4, 2))
STRIPED81 = [c for c in CASES81 if c[1] != "copy"]


def _state(state_np):
    return state_from_numpy(state_np, device="cpu")


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return shared_oracle("device_tier", tmp_path_factory)


@pytest.fixture(scope="module")
def pool():
    """Every case on 8 processes, spawned once for the module."""
    state_np, specs = oracle.device_tier_state()
    copy_states = {}
    for name in oracle.COPY_CASES:
        st, sp = oracle.copy_case_state(name)
        copy_states[name] = (_state(st), sp)
    return spawn(ranks.device_tier_rank, WORLD, timeout=300,
                 args=(_state(state_np), specs, copy_states, CASES, oracle.FULL_BLOB_CASES, STRIPED42,
                       CASES81, STRIPED81))


def _raw_np(a: np.ndarray) -> tuple:
    a = np.ascontiguousarray(a)
    return a.dtype.name, tuple(a.shape), a.tobytes()


def _index(axes, coords, sizes) -> tuple[int, int]:
    """(row-major index of the coordinate over ``axes``, their size)."""
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx, math.prod(sizes[a] for a in axes)


def _slice(arr: np.ndarray, axes, coords, sizes, lead: int = 0) -> tuple:
    """One coordinate's block of a global payload array whose dim ``lead``
    is laid out over ``axes`` (the reference's out spec)."""
    idx, n = _index(axes, coords, sizes)
    a = np.asarray(arr)
    a = a.reshape(a.shape[:lead] + (n, -1))
    return _raw_np(a[(slice(None),) * lead + (idx,)])


def _axes_of(buckets, tag):
    return next(b[2] for b in buckets if b[0] == tag)


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------

def test_ppermute_zeros_where_no_pair_reaches(pool):
    """Pairs (0 -> 1) and (2 -> 2) along "data": coordinate 1 gets 0's
    buffer, 2 keeps its own, 0 and 3 get zeros, on each "model" column."""
    for r, res in enumerate(pool):
        c = res["coords42"]
        got = res["transport"]["ppermute"]
        src = {1: 0, 2: 2}.get(c["data"])
        want = [0, 0, 0] if src is None else [100 * (src * 2 + c["model"] + 1) + i for i in range(3)]
        assert got == want, (r, c)


def test_psum_u32_wraps_mod_2_32(pool):
    want_all = [sum(0xFFFFFFF0 + r for r in range(WORLD)) & 0xFFFFFFFF, sum(7 * r for r in range(WORLD))]
    for r, res in enumerate(pool):
        dtype, shape, data = res["transport"]["psum"]
        assert (dtype, shape) == ("uint32", (2,))
        assert np.frombuffer(data, np.uint32).tolist() == want_all
        m = res["coords42"]["model"]
        col = [m + 2 * d for d in range(4)]  # the processes along "data" with this "model" coordinate
        want = [sum(0xFFFFFFF0 + q for q in col) & 0xFFFFFFFF, sum(7 * q for q in col)]
        assert np.frombuffer(res["transport"]["psum_data"][2], np.uint32).tolist() == want


def test_all_gather_in_axis_order(pool):
    for res in pool:
        m = res["coords42"]["model"]
        assert res["transport"]["all_gather"] == [[m + 2 * d, -(m + 2 * d)] for d in range(4)]
        assert res["transport"]["all_gather_both"] == [[q] for q in range(WORLD)]


def test_gloo_staging_hands_back_on_the_callers_device(pool):
    """The staged path (host buffers, chunk by chunk) gives what the direct
    path gives, on the caller's device."""
    for res in pool:
        device, equal, sent, recv = res["transport"]["staged"]
        assert device == "cpu" and equal and sent == recv == 5 * 8


def test_nccl_on_a_shared_device_raises():
    """No quiet fallback: NCCL with two processes on one card, or on the
    CPU, raises; gloo is never picked for the caller."""
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one device"):
        check_backend("nccl", torch.device("cuda", 0), local_world_size=2, device_count=1)
    with pytest.raises(ValueError, match="needs gloo"):
        check_backend("nccl", torch.device("cpu"), local_world_size=1, device_count=0)
    with pytest.raises(ValueError):
        check_backend("mpi", torch.device("cpu"), local_world_size=1)
    check_backend("nccl", torch.device("cuda", 0), local_world_size=4, device_count=4)
    check_backend("gloo", torch.device("cuda", 0), local_world_size=8, device_count=1)


def test_a_process_asked_for_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_process_mesh((1,), ("data",), "gloo", rank=0, world_size=1,
                          init_method=f"file://{tmp_path / 'rdv'}")
    assert not torch.distributed.is_initialized()


def test_spawn_reports_a_failed_rank_and_ends_the_others():
    """A rank that raises: spawn raises with its traceback and leaves no
    process behind, though the other rank waits on it forever."""
    import time

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank 1 fails on purpose"):
        spawn(ranks.failing_rank, 2, timeout=120)
    assert time.perf_counter() - t0 < 60


def test_no_reference_module_in_any_process(pool):
    assert [res["modules"] for res in pool] == [[]] * WORLD


# ---------------------------------------------------------------------------
# payloads against the reference's, coordinate by coordinate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_payload_matches_reference_slice(jx, pool, case):
    arrays, meta = jx
    name, codec, _, _ = case
    key = "partner" if codec == "copy" else "parity"
    state_np, specs = oracle.device_tier_state()
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    own = _state({k: arrays[f"{name}/own/{k}"] for k in state_np})
    for r, res in enumerate(pool):
        c = res["coords42"]
        got = res["m42"][name]
        pay = got["payload"]
        assert sorted(pay) == sorted(["checksum", key, "own"])
        assert pay["checksum"] == _raw_np(arrays[f"{name}/checksum"]), r
        want_own = dt.local_shards(mesh, own, specs, coords=c)
        assert pay["own"] == {k: ranks.raw(v) for k, v in want_own.items()}, r
        assert sorted(pay[key]) == sorted(b["tag"] for b in meta[name]["buckets"])
        for tag, val in pay[key].items():
            axes = _axes_of(got["buckets"], tag)
            assert val == _slice(arrays[f"{name}/{key}/{tag}"], axes, c, SIZES42, lead=int(key == "parity")), \
                (r, tag)


def test_compressed_payload_matches_reference_slice(jx, pool):
    arrays, meta = jx
    for r, res in enumerate(pool):
        c = res["coords42"]
        got = res["m42"]["compressed"]
        assert got["payload"]["checksum"] == _raw_np(arrays["compressed/checksum"])
        for tag, parts in got["payload"]["partner"].items():
            axes = next(tuple(b["axes"]) for b in meta["compressed"]["buckets"] if b["tag"] == tag)
            for part in ("q", "scale"):
                want = _slice(arrays[f"compressed/partner/{tag}/{part}"], axes, c, SIZES42)
                assert parts[part] == want == got["staged"]["partner"][tag][part], (r, tag, part)
        # the wire carries the codes and the scales, nothing else
        assert got["sent"] == got["prog_sent"] == sum(len(p[2]) for parts in got["payload"]["partner"].values()
                                                     for p in parts.values())
        assert (got["exchanged"], got["pcie"]) == (meta["compressed"]["exchanged_bytes"],
                                                   meta["compressed"]["pcie_bytes"])


@pytest.mark.parametrize("case", oracle.FULL_BLOB_CASES, ids=[c[0] for c in oracle.FULL_BLOB_CASES])
def test_full_blobs_match_reference_slice(jx, pool, case):
    arrays, meta = jx
    name = case[0]
    for r, res in enumerate(pool):
        c = res["coords42"]
        got = res["m42"][f"full/{name}"]
        assert sorted(got["payload"]) == meta[f"full/{name}"]["keys"]
        assert got["payload"]["checksum"] == _raw_np(arrays[f"full/{name}/checksum"])
        for tag, val in got["payload"]["parity_full"].items():
            axes = next(tuple(b["axes"]) for b in meta[f"full/{name}"]["buckets"] if b["tag"] == tag)
            assert val == _slice(arrays[f"full/{name}/parity_full/{tag}"], axes, c, SIZES42, lead=1), (r, tag)
        assert (got["exchanged"], got["pcie"]) == (meta[f"full/{name}"]["exchanged_bytes"],
                                                   meta[f"full/{name}"]["pcie_bytes"])
        assert got["sent"] == got["prog_sent"]


def test_mirror_matches_reference_slice(jx, pool):
    arrays, meta = jx
    total = 0
    for r, res in enumerate(pool):
        c = res["coords42"]
        got = res["copy"]["mirror"]
        assert sorted(got["payload"]) == meta["mirror"]["keys"] == ["checksum", "mirror"]
        assert got["payload"]["checksum"] == _raw_np(arrays["mirror/checksum"])
        for tag, val in got["payload"]["mirror"].items():
            axes = next(tuple(b["axes"]) for b in meta["mirror"]["buckets"] if b["tag"] == tag)
            assert val == _slice(arrays[f"mirror/{tag}"], axes, c, SIZES42), (r, tag)
        assert all(got["restored"].values()) and got["restored"]
        assert got["sent"] == got["prog_sent"]
        total += got["sent"]
    # every coordinate sends its fused bucket to its twin
    assert total == meta["mirror"]["exchanged_bytes"] == pool[0]["copy"]["mirror"]["exchanged"]


@pytest.mark.parametrize("name", sorted(oracle.COPY_CASES))
def test_copy_restore_fn_on_processes(jx, pool, name):
    """The copy cases: the partner slices equal the reference's, the
    checksum too, and restore_fn gives every process its shards back."""
    arrays, meta = jx
    for r, res in enumerate(pool):
        c = res["coords42"]
        got = res["copy"][name]
        assert got["payload"]["checksum"] == _raw_np(arrays[f"copy/{name}/checksum"])
        for tag, val in got["payload"]["partner"].items():
            assert val == _slice(arrays[f"copy/{name}/partner/{tag}"], _axes_of(got["buckets"], tag), c,
                                 SIZES42), (r, tag)
        assert sorted(got["restored"]) == sorted(meta[f"copy/{name}"]["exchanged_names"])
        assert all(got["restored"].values()), r


def test_staged_fetch_on_processes(jx, pool):
    arrays, _ = jx
    for res in pool:
        got = res["m42"]["xor2"]
        for db in (0, 1):
            staged = got[f"staged{db}"]
            assert sorted(staged) == ["own", "parity"]
            assert staged["parity"] == got["payload"]["parity"] and staged["own"] == got["payload"]["own"]


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------

def _reference_sends(axis_size: int, codec: str, g: int, n_parity: int, scheme: str = "pairwise") -> list[int]:
    """Permutes each coordinate of the axis sends per bucket under the
    reference's schedules (``repro/core/device_tier.py`` ``_copy_pairs``,
    ``_ring_pairs``, ``_route_pairs``), counting only pairs to another
    coordinate."""
    from repro.core import distribution as jdist

    sends = [0] * axis_size
    if codec == "copy":
        for s, d in jdist.perm_pairs(axis_size, scheme):
            sends[s] += s != d
        return sends
    groups = jdist.parity_groups(axis_size, g)
    n_slots = max(-(-g // len(grp.members)) for grp in groups)
    for grp in groups:
        k = len(grp.members)
        for q, m in enumerate(grp.members):
            sends[grp.members[(q + 1) % k]] += (g - 1) * (grp.members[(q + 1) % k] != m)
    for b in range(n_parity):
        for rnd in range(n_slots):
            for gi, grp in enumerate(groups):
                holder = groups[jdist.blob_holder_group(len(groups), gi, b)]
                for i in range(len(grp.members)):
                    p = rnd * len(grp.members) + i
                    if p < len(holder.members):
                        sends[grp.members[i]] += grp.members[i] != holder.members[p]
    return sends


@pytest.mark.parametrize("mesh_key", ["m42", "m81"])
def test_bytes_sent_are_the_reference_permutes(jx, pool, mesh_key):
    """Each process sends what the reference's permutes move from its
    coordinate (the program's ``sent_bytes``). Where every group is full,
    the total over the processes is the program's ``exchanged_bytes``, each
    bucket counted once for every process that holds a coordinate of it (a
    bucket that varies on no "model" coordinate is sent by both columns)."""
    sizes = SIZES42 if mesh_key == "m42" else SIZES81
    cases = CASES if mesh_key == "m42" else CASES81
    for name, codec, g, m in cases:
        n_parity = dt._n_parity(codec, g, m, 2)
        sends = _reference_sends(sizes["data"], codec, g, n_parity)
        total = 0
        for r, res in enumerate(pool):
            got = res[mesh_key][name]
            c = res["coords42" if mesh_key == "m42" else "coords81"]
            want = sum(sends[c["data"]] * words * 4 for _, _, _, words in got["buckets"])
            assert got["sent"] == got["prog_sent"] == want, (name, r)
            total += got["sent"]
        if sizes["data"] % max(g, 1) == 0:
            buckets = pool[0][mesh_key][name]["buckets"]
            per_coord = pool[0][mesh_key][name]["exchanged"] // sum(
                words * math.prod(sizes[a] for a in axes) for _, _, axes, words in buckets)
            assert total == sum(per_coord * words * WORLD for _, _, _, words in buckets), name
            if all(math.prod(sizes[a] for a in axes) == WORLD for _, _, axes, _ in buckets):
                assert total == pool[0][mesh_key][name]["exchanged"], name


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_accounting_equals_the_one_card_program(jx, pool, case):
    """Layout and accounting come from the same code for both meshes: the
    buckets, ``own_bytes``, ``exchanged_bytes`` and ``pcie_bytes`` equal the
    one-card program's and the reference's."""
    _, meta = jx
    name, codec, g, m = case
    state_np, specs = oracle.device_tier_state()
    one = dt.build_snapshot_program(make_mesh((4, 2), ("data", "model"), device="cpu"), _state(state_np), specs,
                                    codec=codec, parity_group=g, rs_parity=m)
    assert one.sent_bytes is None
    for res in pool:
        got = res["m42"][name]
        assert got["buckets"] == [(b.tag, b.axis, b.axes, b.words) for b in one.buckets]
        assert (got["own_bytes"], got["exchanged"], got["pcie"]) == (
            one.own_bytes, one.exchanged_bytes, one.pcie_bytes) == (
            meta[name]["own_bytes"], meta[name]["exchanged_bytes"], meta[name]["pcie_bytes"])


# ---------------------------------------------------------------------------
# the (8, 1) mesh against the one-card program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES81, ids=[c[0] for c in CASES81])
def test_8x1_payload_matches_the_one_card_program(pool, case):
    """Each process's payload is its coordinate's rows of the one-card
    program's on the same (8, 1) layout; the handshake checksum is the same
    on every process and equals the one-card program's."""
    name, codec, g, m = case
    state_np, specs = oracle.device_tier_state()
    one = dt.build_snapshot_program(make_mesh((8, 1), ("data", "model"), device="cpu"), _state(state_np), specs,
                                    codec=codec, parity_group=g, rs_parity=m).snapshot_fn(_state(state_np))
    key = "partner" if codec == "copy" else "parity"
    for r, res in enumerate(pool):
        c = res["coords81"]
        got = res["m81"][name]
        assert got["payload"]["checksum"] == ranks.raw(one["checksum"]), r
        for tag, val in got["payload"][key].items():
            want = _slice(one[key][tag].view(torch.int32).numpy().view(np.uint32), _axes_of(got["buckets"], tag),
                          c, SIZES81, lead=int(key == "parity"))
            assert val == want, (r, tag)


# ---------------------------------------------------------------------------
# the striped restore on processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", STRIPED42, ids=[c[0] for c in STRIPED42])
def test_striped_restore_every_failure_combo_4x2(jx, pool, case):
    """Every failure combination the reference accepts (and only those),
    the failed processes' shards and stripes overwritten: each process's
    shards equal the originals after the restore."""
    _, meta = jx
    name = case[0]
    want = [tuple(t) for t in meta[name]["combos"]]
    for r, res in enumerate(pool):
        got = res["restore42"][name]
        assert [(tag, ok) for tag, ok, _ in got] == want, r
        assert all(ok for _, acc, ok in got if acc), (r, [t for t, acc, ok in got if acc and not ok])


@pytest.mark.parametrize("case", STRIPED81, ids=[c[0] for c in STRIPED81])
def test_striped_restore_every_failure_combo_8x1(pool, case):
    """The (8, 1) mesh: xor and rs over groups of 4, a ragged rs over
    groups of 3 and lrc, every combination up to the tolerance; the same
    combinations accepted as ``striped_decode_rows`` accepts."""
    name, codec, g, m = case
    tol = 1 if codec == "xor" else m
    combos = [f for n in range(tol + 1) for f in itertools.combinations(range(8), n)]
    accepted = []
    for failed in combos:
        try:
            dt.striped_decode_rows(8, g, codec, m, set(failed))
            accepted.append(True)
        except ValueError:
            accepted.append(False)
    assert sum(accepted) > len(combos) // 2
    for r, res in enumerate(pool):
        got = res["restore81"][name]
        assert [acc for _, acc, _ in got] == accepted, r
        assert all(ok for _, acc, ok in got if acc), (r, [t for t, acc, ok in got if acc and not ok])
