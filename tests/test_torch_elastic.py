"""The port's elastic N-to-M restore against the JAX package's, exactly.

One subprocess (``_torch_jax_oracle.py elastic``) runs the reference's
planner on tests/test_elastic.py's grid, its host executor and its Pallas
row gather (interpret mode) on f32, bf16 and int32 leaves, and
``CheckpointEngine.restore_elastic`` (restore mode "sync") on the round-trip
grid, one failed rank 8 -> 6, and a grow after a failure 4 -> 12, each plain
and with int8-compressed partner copies. The port runs the same cases here
on ``device="cpu"``. Tolerance: exact everywhere (all of it is integer
bookkeeping and byte movement; the compressed copies are deterministic on
both sides).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import _torch_jax_oracle as oracle
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.core.distribution import DataLostError
from repro_torch.core.serialization import LeafSlice
from repro_torch.elastic import plan_repartition, reshard_leaf_device, reshard_leaves, reshard_leaves_device
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import state_from_numpy, state_to_numpy
from repro_torch.runtime.state import RngEntity, ShardedStateEntity, ShardPlan
from repro_torch.utils.pytree import tree_flatten, tree_unflatten
from test_torch_device_tier import run_oracle

GRID = [(a, b) for a in oracle.PLAN_OLD for b in oracle.PLAN_NEW]
EXEC = [(dt, a, b) for dt in oracle.EXEC_DTYPES for a, b in oracle.EXEC_PAIRS]
ENGINE_TAGS = [tag for tag, *_ in oracle.elastic_cases()]


def _plan(state_np, specs) -> ShardPlan:
    return ShardPlan.from_pspecs(state_from_numpy(state_np, device="cpu"), specs)


def _paths(tree) -> list[str]:
    return ["/".join(p) for p in tree_flatten(tree)[0]]


class _Live:
    """The port's live state of an engine case (written in place)."""

    def __init__(self, state, rng):
        self.state, self.rng_ent = state, rng

    def zero(self):
        for leaf in tree_flatten(self.state)[1]:
            leaf.zero_()
        self.rng_ent.seed = self.rng_ent.counter = 0

    def leaves(self):
        return dict(zip(_paths(self.state), tree_flatten(state_to_numpy(self.state))[1]))

    def rng(self):
        return [self.rng_ent.seed, self.rng_ent.counter]


def _setup(n: int, compress: bool):
    state_np, specs = oracle.elastic_engine_state()
    state = state_from_numpy(state_np, device="cpu")
    rng = RngEntity()
    rng.seed, rng.counter = 7, 3
    eng = CheckpointEngine(n, EngineConfig(restore_mode="sync", compress=compress), device="cpu")
    eng.register("state", ShardedStateEntity(lambda: state, _plan(state_np, specs)))
    eng.register("rng", rng)
    return eng, _Live(state, rng)


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return run_oracle("elastic", tmp_path_factory.mktemp("oracle") / "elastic.npz")


@pytest.fixture(scope="module")
def port():
    state0, specs0 = oracle.elastic_global()
    plans = oracle.elastic_plan_cases(_plan(state0, specs0).shard_coords, plan_repartition, LeafSlice)
    arrays, engine = oracle.elastic_engine_cases(_setup, lambda t: t.numpy())
    return arrays, json.loads(json.dumps({"plans": plans, "engine": engine}))


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_old,n_new", GRID)
def test_plan_matches_the_reference(jx, port, n_old, n_new):
    """The same shard coordinates, targets, segments and byte accounting on
    tests/test_elastic.py's grid; segments tile every target exactly."""
    want, got = jx[1]["plans"]["grid"], port[1]["plans"]["grid"]
    assert got[f"coords{n_old}"] == want[f"coords{n_old}"]
    p = got[f"{n_old}-{n_new}"]
    assert p == want[f"{n_old}-{n_new}"]
    for j, tj in enumerate(p["targets"]):
        for leaf, start, stop, _ in tj:
            segs = sorted((s for s in p["segments"][j] if s[0] == leaf), key=lambda s: s[3])
            assert [s[3] for s in segs] == list(np.cumsum([0] + [s[4] for s in segs[:-1]]))
            assert sum(s[4] for s in segs) == stop - start


@pytest.mark.parametrize("n_new", [2, 3, 4, 6, 12])
def test_plan_movement_is_minimal_as_in_the_reference(jx, port, n_new):
    p = port[1]["plans"]["minimal"][str(n_new)]
    assert p == jx[1]["plans"]["minimal"][str(n_new)]
    total, moved, lower, ratio = p["bytes"]
    assert moved == lower and ratio == 1.0


def test_missing_rows_raise_where_the_reference_raises(jx, port):
    assert port[1]["plans"]["missing_rows"] == jx[1]["plans"]["missing_rows"] == "ValueError"
    with pytest.raises(ValueError, match="held by no origin"):
        plan_repartition([[LeafSlice((8, 2), 0, 0, 4)]], 1, {0: 0})


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

def _exec_inputs(dtype: str, n_old: int, n_new: int):
    """The executors' state as the port's shards over n_old ranks, with the
    plan and the leaf names."""
    state_np, specs = oracle.elastic_exec_state(dtype)
    state = state_from_numpy(state_np, device="cpu")
    plan = _plan(state_np, specs)
    coords = plan.shard_coords(n_old)
    shards = ShardedStateEntity(lambda: state, plan).snapshot_shards(n_old)
    leaves = {o: tree_flatten(s)[1] for o, s in enumerate(shards)}
    p = plan_repartition(coords, n_new, {o: o if o < n_new else None for o in range(n_old)})
    return p, leaves, [ls.axis for ls in coords[0]], _paths(state)


def _np(t: torch.Tensor) -> np.ndarray:
    return state_to_numpy(t.contiguous())


@pytest.mark.parametrize("dtype,n_old,n_new", EXEC)
def test_host_executor_matches_the_reference(jx, dtype, n_old, n_new):
    p, leaves, axes, names = _exec_inputs(dtype, n_old, n_new)
    key = f"exec/{dtype}/{n_old}-{n_new}"
    assert json.loads(json.dumps(oracle.plan_json(p))) == jx[1]["exec"][key]
    for j, new in enumerate(reshard_leaves(p, leaves, axes)):
        for i, leaf in enumerate(new):
            assert _same(_np(leaf), jx[0][f"{key}/host/{j}/{names[i]}"]), (j, names[i])


@pytest.mark.parametrize("dtype,n_old,n_new", EXEC)
def test_gather_executor_on_the_cpu_matches_the_reference(jx, dtype, n_old, n_new):
    """``reshard_leaf_device`` (one leaf, one new rank) and
    ``reshard_leaves_device`` (every leaf, stacked once) on CPU tensors give
    the bytes of the reference's Pallas gather, leaf by leaf."""
    p, leaves, axes, names = _exec_inputs(dtype, n_old, n_new)
    key = f"exec/{dtype}/{n_old}-{n_new}"
    whole = reshard_leaves_device(p, leaves, axes)
    for j in range(n_new):
        for i, axis in enumerate(axes):
            segs = [s for s in p.segments[j] if s.leaf == i]
            if axis is None:  # replicated: passed on by reference
                assert whole[j][i] is leaves[segs[0].origin][i]
                continue
            want = jx[0][f"{key}/device/{j}/{names[i]}"]
            assert _same(_np(reshard_leaf_device({o: leaves[o][i] for o in leaves}, segs, axis)), want)
            assert _same(_np(whole[j][i]), want), (j, names[i])


@pytest.mark.parametrize("rows,cols,rows_out", [(4, 2, 6), (16, 128, 5), (9, 300, 9), (3, 1, 8)])
def test_gather_rows_on_the_cpu_is_the_plain_version(rows, cols, rows_out):
    """tests/test_elastic.py's shapes: ``ops.gather_rows`` on CPU tensors
    equals ``ref.gather_rows`` and ``src[idx]``, and launches nothing."""
    rng = np.random.default_rng(rows * 1000 + cols)
    src = torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, rows, size=rows_out).astype(np.int32))
    before = ops.launch_counts()["gather_rows"]
    got = ops.gather_rows(src, idx)
    assert torch.equal(got, ref.gather_rows(src, idx)) and torch.equal(got, src[idx.long()])
    assert ops.launch_counts()["gather_rows"] == before


@pytest.mark.parametrize("bad", [-1, 4])
def test_gather_rows_raises_on_an_index_out_of_range(bad):
    src = torch.zeros((4, 3))
    with pytest.raises(IndexError, match="outside the source's 4 rows"):
        ops.gather_rows(src, torch.tensor([0, bad, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        ops.gather_rows(src, torch.tensor([0, 1]))


def test_restore_shards_takes_m_strided_shards():
    """ShardedStateEntity writes M != N new shards in place, including the
    non-contiguous moved-axis views the gather executor returns."""
    state_np, specs = oracle.elastic_engine_state()
    state = state_from_numpy(state_np, device="cpu")
    plan = _plan(state_np, specs)
    ent = ShardedStateEntity(lambda: state, plan)
    coords = plan.shard_coords(4)
    # CPU shards are views of the live state: copy them before it is zeroed
    leaves = {o: [t.clone() for t in tree_flatten(s)[1]] for o, s in enumerate(ent.snapshot_shards(4))}
    p = plan_repartition(coords, 6, {o: o for o in range(4)})
    new = reshard_leaves_device(p, leaves, [ls.axis for ls in coords[0]])
    assert any(not t.is_contiguous() for shard in new for t in shard)
    for leaf in tree_flatten(state)[1]:
        leaf.zero_()
    paths = tree_flatten(state)[0]
    ent.restore_shards({j: tree_unflatten(paths, new[j]) for j in range(6)})
    for a, b in zip(tree_flatten(state_to_numpy(state))[1], tree_flatten(state_np)[1]):
        assert _same(a, b)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ENGINE_TAGS)
def test_restore_elastic_matches_the_reference(jx, port, tag):
    """Restored state, meta step, world size and stores, ElasticReport with
    its plans, restore counters, the journal's "resize" record, and the
    re-protect checkpoint on the new world (arenas, copies, manifests with
    their coordinates, checksums): identical."""
    (ja, jm), (pa, pm) = jx, port
    got, want = pm["engine"][tag], jm["engine"][tag]
    assert got == want
    assert got["report"][5] == 1.0 and got["rng"] == [7, 3]
    keys = sorted(k for k in ja if k.startswith(f"{tag}/"))
    assert keys and keys == sorted(k for k in pa if k.startswith(f"{tag}/"))
    for k in keys:
        assert _same(pa[k], ja[k]), k


def test_restore_elastic_restores_the_state_exactly(port):
    """Without a failure under compression, and always uncompressed, the
    restored state is the checkpointed one byte for byte."""
    state_np, _ = oracle.elastic_engine_state()
    want = dict(zip(_paths(state_np), tree_flatten(state_np)[1]))
    for tag, _, _, kill, compress in oracle.elastic_cases():
        if compress and kill is not None:
            continue  # the adopted copy is the int8 round trip
        for path, leaf in want.items():
            assert _same(port[0][f"{tag}/restored/{path}"], leaf), (tag, path)


def test_losing_a_copy_pair_raises_in_both_engines(jx, port):
    assert port[1]["engine"]["lost"] == jx[1]["engine"]["lost"] == DataLostError.__name__


def test_restore_elastic_without_a_checkpoint_raises():
    eng, _ = _setup(4, False)
    with pytest.raises(RuntimeError, match="no valid checkpoint"):
        eng.restore_elastic(2)
    with pytest.raises(ValueError):
        eng.restore_elastic(0)
