"""The port's host-tier checkpoint engine against the JAX package's, byte for
byte.

One subprocess runs ``repro.core.checkpoint.CheckpointEngine`` (restore mode
"sync", Pallas in interpret mode for the compressed mode) on the cases of
``_torch_jax_oracle.engine_vec_cases`` and a ShardedStateEntity + RngEntity
state; the port runs the same cases here on ``device="cpu"``. Tolerance:
exact everywhere. Committed arena bytes, held copies, manifests, handshake
and exchange checksums, the restored state (the int8-compressed copy too:
both sides are deterministic) and the data-loss verdicts must be identical.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import _torch_jax_oracle as oracle
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig, FaultDuringCheckpoint
from repro_torch.core.distribution import DataLostError
from repro_torch.launch.steps import numpy_entity, state_from_numpy, state_to_numpy
from repro_torch.runtime.state import RngEntity, ShardedStateEntity, ShardPlan
from repro_torch.utils.pytree import tree_flatten
from test_torch_device_tier import run_oracle

MODES = list(oracle.ENGINE_MODES)


def _engine(n: int, **cfg) -> CheckpointEngine:
    return CheckpointEngine(n, EngineConfig(restore_mode="sync", **cfg), device="cpu")


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return run_oracle("engine", tmp_path_factory.mktemp("oracle") / "engine.npz")


@pytest.fixture(scope="module")
def port():
    arrays, meta = oracle.engine_vec_cases(_engine, numpy_entity, lambda t: t.numpy(), lambda vec, r: vec.data[r])
    state_np, specs = oracle.engine_state()
    plan = ShardPlan.from_pspecs(state_from_numpy(state_np, device="cpu"), specs)
    for compress in (False, True):
        tag = f"state{int(compress)}"
        state = state_from_numpy(state_np, device="cpu")
        eng = _engine(4, compress=compress)
        rng = RngEntity()
        rng.seed, rng.counter = 7, 3
        eng.register("state", ShardedStateEntity(lambda: state, plan))
        eng.register("rng", rng)
        assert eng.checkpoint({"step": 1})
        a, m = oracle.dump_engine(eng, lambda t: t.numpy())
        arrays.update({f"{tag}/{k}": v for k, v in a.items()})
        for leaf in tree_flatten(state)[1]:  # the live state moves on, in place
            leaf.add_(1)
        rng.seed, rng.counter = 0, 0
        eng.stores[2].wipe()
        eng.restore()
        m["rng"] = [rng.seed, rng.counter]
        for path, leaf in zip(*tree_flatten(state_to_numpy(state))):
            arrays[f"{tag}/restored/" + "/".join(path)] = leaf
        meta[tag] = m
    return arrays, json.loads(json.dumps(meta))


def _same_arrays(jx_arrays: dict, port_arrays: dict, prefix: str) -> None:
    keys = sorted(k for k in jx_arrays if k.startswith(prefix))
    assert keys and keys == sorted(k for k in port_arrays if k.startswith(prefix))
    for k in keys:
        a, b = np.asarray(jx_arrays[k]), np.asarray(port_arrays[k])
        assert a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("mode", MODES)
def test_committed_stores_match_the_reference(jx, port, mode):
    """Own arenas, held copies (int8 for the compressed mode), manifests,
    handshake and exchange checksums: identical on every rank."""
    (ja, jm), (pa, pm) = jx, port
    assert pm[mode]["stores"] == jm[mode]["stores"]
    _same_arrays({k: v for k, v in ja.items() if "/restored/" not in k},
                 {k: v for k, v in pa.items() if "/restored/" not in k}, f"{mode}/")


@pytest.mark.parametrize("mode", MODES)
def test_restore_after_a_wipe_matches_the_reference(jx, port, mode):
    """Rank 3 wiped: survivors restore locally, rank 3 adopts its partner's
    copy (dequantized under compress); every vector byte-identical."""
    (ja, jm), (pa, pm) = jx, port
    assert pm[mode]["restore"] == jm[mode]["restore"]
    assert pm[mode]["restore"]["adopted"] == 1
    _same_arrays(ja, pa, f"{mode}/restored/")


@pytest.mark.parametrize("mode", MODES)
def test_losing_a_rank_and_its_holders_matches_the_reference(jx, port, mode):
    """Rank 2 with rank 6 (its pairwise partner), and rank 2 with every
    holder of its copies: DataLostError exactly where the reference raises."""
    assert port[1][mode]["lost"] == jx[1][mode]["lost"]
    assert port[1][mode]["lost"]["2+holders"] == DataLostError.__name__


@pytest.mark.parametrize("compress", [False, True])
def test_sharded_state_entity_matches_the_reference(jx, port, compress):
    """ShardedStateEntity + RngEntity over 4 ranks: the same shard coords in
    the manifests, the same arenas and copies, and after rank 2's store is
    wiped the same restored state (rank 2's split leaves through the int8
    copy under compress), written back in place."""
    tag = f"state{int(compress)}"
    (ja, jm), (pa, pm) = jx, port
    assert pm[tag] == jm[tag]
    _same_arrays(ja, pa, f"{tag}/")
    assert pm[tag]["rng"] == [7, 3]


def test_numpy_entity_adapts_the_reference_entity(jx):
    """The reference's own ShardedStateEntity (numpy shards, with its
    partner subsets) behind ``numpy_entity``, in the port's engine: the same
    committed stores as the reference's engine, and the same restore."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.runtime.state import RngEntity as JRngEntity
    from repro.runtime.state import ShardedStateEntity as JShardedStateEntity
    from repro.runtime.state import ShardPlan as JShardPlan

    state_np, specs = oracle.engine_state()
    sds = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state_np)
    ps = jax.tree_util.tree_map(lambda t: P(*t), specs, is_leaf=lambda x: isinstance(x, tuple))
    box = {"s": jax.tree.map(np.copy, state_np)}
    rng = JRngEntity()
    rng.seed, rng.counter = 7, 3
    eng = _engine(4)
    eng.register("state", numpy_entity(JShardedStateEntity(lambda: box["s"], lambda s: box.update(s=s),
                                                           JShardPlan.from_pspecs(sds, ps))))
    eng.register("rng", numpy_entity(rng))
    assert eng.checkpoint({"step": 1})
    arrays, meta = oracle.dump_engine(eng, lambda t: t.numpy())
    (ja, jm) = jx
    want = json.loads(json.dumps(jm["state0"]["stores"]))
    for r in want:  # the adapter forwards no shard coordinates
        for entry in want[r]["manifests"]:
            entry[2]["coords"] = None
        for man in want[r]["own"].values():
            man["coords"] = None
        want[r]["meta_keys"].remove("coords")
    assert json.loads(json.dumps(meta["stores"])) == want
    _same_arrays({k: v for k, v in ja.items() if k.startswith("state0/") and "/restored/" not in k},
                 {f"state0/{k}": v for k, v in arrays.items()}, "state0/")
    box["s"] = jax.tree.map(lambda a: (a + 1).astype(a.dtype), box["s"])
    eng.stores[2].wipe()
    eng.restore()
    for path, leaf in jax.tree_util.tree_flatten_with_path(box["s"])[0]:
        key = "state0/restored/" + "/".join(k.key for k in path)
        assert np.asarray(leaf).tobytes() == ja[key].tobytes(), key


def test_compressed_restore_is_within_half_a_step():
    """The adopted int8 copy of a data-split f32 leaf is within half a
    quantization step of the original, and survivors are exact."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 1024)).astype(np.float32))
    orig = x.clone()
    plan = ShardPlan.from_pspecs({"x": x}, {"x": ("data", None)})
    eng = _engine(4, compress=True)
    eng.register("s", ShardedStateEntity(lambda: {"x": x}, plan))
    assert eng.checkpoint()
    x.zero_()
    eng.stores[1].wipe()
    eng.restore()
    lost = slice(2, 4)  # rank 1's rows
    for r in (0, 2, 3):
        assert torch.equal(x[2 * r : 2 * r + 2], orig[2 * r : 2 * r + 2])
    step = orig[lost].abs().reshape(-1, 256).amax(1) / 127
    err = (x[lost] - orig[lost]).abs().reshape(-1, 256).amax(1)
    assert bool((err <= step / 2).all())


def test_fault_before_the_swap_keeps_the_previous_checkpoint():
    """Algorithm 2: a rank that dies after distribution aborts the snapshot;
    the previous checkpoint stays committed and restorable."""
    armed = {"on": False}

    def hook(phase):
        if phase == "after_distribute" and armed["on"]:
            armed["on"] = False
            eng.stores[5].wipe()
            raise FaultDuringCheckpoint("injected")

    eng = CheckpointEngine(8, EngineConfig(restore_mode="sync"), fault_hook=hook, device="cpu")
    vec = oracle.ShardedVec(8)
    eng.register("state", numpy_entity(vec))
    assert eng.checkpoint({"step": 1})
    first = [d.copy() for d in vec.data]
    for d in vec.data:
        d += 1
    armed["on"] = True
    assert not eng.checkpoint({"step": 2})
    assert eng.stats.aborted == 1 and eng.stats.created == 1
    assert eng.restore()["step"] == 1
    assert all(np.array_equal(a, b) for a, b in zip(vec.data, first))


@pytest.mark.parametrize("cfg,item", [
    (EngineConfig(), "A5"),
    (EngineConfig(restore_mode="sync", async_workers=2), "A5"),
    (EngineConfig(restore_mode="sync", parity_group=4), "A4"),
    (EngineConfig(restore_mode="sync", codec="rs", parity_group=4), "A4"),
    (EngineConfig(restore_mode="sync", tiers=("disk",)), "A7"),
    (EngineConfig(restore_mode="sync", delta=True), "A7"),
    (EngineConfig(restore_mode="sync", topology=object()), "A9"),
])
def test_unported_settings_raise_naming_their_roadmap_item(cfg, item):
    with pytest.raises(NotImplementedError, match=item):
        CheckpointEngine(4, cfg, device="cpu")


def test_background_drain_raises():
    eng = _engine(4)
    with pytest.raises(NotImplementedError, match="A5"):
        eng.checkpoint_async(background=True)


def test_the_engine_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CheckpointEngine(4, EngineConfig(restore_mode="sync"))
    assert CheckpointEngine(4, EngineConfig(restore_mode="sync"), device="cpu").device.type == "cpu"
