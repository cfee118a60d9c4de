"""The sharded train step on the CPU: ``ShardCtx``/``constrain`` as DTensor
placements and ``Trainer(mesh=ProcessMesh)``, held against the JAX
package's ``Trainer(mesh=)``.

One module-scoped pool of 4 gloo processes (``launch.mesh.spawn``) runs
every case on the (2, 2) ("data", "model") mesh, each case over its own
``file://`` rendezvous under the module's temporary directory, while the
reference runs in a child process with 8 host devices
(``_torch_jax_oracle.py trainer_mesh``: its ``Trainer`` on a
``jax.sharding.Mesh`` over devices 0-3, Auto axes) and the port's one-card
``Trainer`` runs in this process. Tolerances are
``tests/test_torch_trainer.py``'s: losses rtol 1e-4, each state leaf rtol
1e-4 with atol 1e-4 of the leaf's largest magnitude.

(i) ``placements`` against ``NamedSharding.devices_indices_map``; (ii)
``constrain`` with ``ctx=None`` is the identity and ``Model.loss`` with and
without ``ctx=None`` bit-equal; (iii) the sharded ``Trainer`` through
``TRAINER_KILLS`` against the reference's (losses, recoveries, created and
aborted checkpoints, committed manifests, final state); (iv) the same
against the port's one-card ``Trainer``; (v) the sharded faulty run
bit-equal to the sharded clean run; (vi) the ``fsdp`` preset (the per-layer
gather) against the reference's on the same mesh; (vii) the decode steps
no runtime path runs on a mesh (``ssm.decode``, an MoE slot's
``decode_block``) raise on a DTensor, naming the missing rule. The other
model families, the recovery policies and the out-of-run calls on the mesh
are ``tests/test_torch_trainer_mesh_zoo.py``'s and
``tests/test_torch_trainer_mesh_policies.py``'s.
The staged backend's hold on torch's API is checked on its own, in this
process.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
import _torch_jax_oracle as oracle
from repro_torch.configs import get_config
from repro_torch.launch.mesh import RankGroup
from repro_torch.launch.steps import state_to_numpy
from repro_torch.models import build_model
from repro_torch.models.common import ShardCtx, constrain
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.sharding.mesh import block_slices, placements
from repro_torch.utils import threefry
from repro_torch.utils.pytree import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run (a child process), the 4-process pool and the
    port's one-card Trainer, all at once; every wait bounded."""
    base = tmp_path_factory.mktemp("trainer_mesh")
    out = base / "trainer_mesh.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    child = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_jax_oracle.py"), "trainer_mesh", str(out)],
                             stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    consts = dict(case=oracle.TRAINER_CASE, kills=oracle.TRAINER_KILLS, steps=oracle.TRAINER_STEPS,
                  fsdp_steps=oracle.TRAINER_MESH_FSDP_STEPS, placement_cases=oracle.MESH_PLACEMENT_CASES,
                  mesh=oracle.MESH_SHAPE)
    rdv = base / "rdv"
    rdv.mkdir()
    try:
        group = RankGroup(ranks.trainer_mesh_rank, WORLD, args=(str(rdv), consts))
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = Trainer(build_model(get_config("llama3.2-1b").reduced()), TrainerConfig(**oracle.TRAINER_CASE),
                          injector=FailureInjector(4, schedule=oracle.TRAINER_KILLS), device="cpu")
            one.run(oracle.TRAINER_STEPS)
        finally:
            torch.set_num_threads(n)
        pool = group.join(TIMEOUT)
        _, err = child.communicate(timeout=TIMEOUT)
        assert child.returncode == 0, err[-3000:]
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    return {"jx": oracle.load(str(out)), "pool": pool, "one": one}


def _close_states(got: dict, want_of, label: str) -> None:
    paths, leaves = tree_flatten(got)
    assert paths, label
    for p, x in zip(paths, leaves):
        want = want_of(p)
        assert x.dtype == want.dtype and x.shape == want.shape, (label, p)
        np.testing.assert_allclose(x, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"{label}: {'/'.join(p)}")


# ---------------------------------------------------------------------------
# (i) placements
# ---------------------------------------------------------------------------

def test_block_slices_match_the_reference_device_maps(runs):
    """Every placement case, on (2, 2) and (2, 2, 2): the block each flat
    rank holds is the reference device's index map (devices row-major)."""
    _, meta = runs["jx"]
    for (sizes, names, shape, spec), maps in zip(oracle.MESH_PLACEMENT_CASES, meta["placements"]):
        axes = tuple(zip(names, sizes))
        for rank, want in enumerate(maps):
            got = [[s.start, s.stop] for s in block_slices(shape, spec, axes, rank)]
            assert got == want, (sizes, shape, spec, rank)


def test_each_process_holds_its_reference_block(runs):
    """On the 4 processes: ``distribute`` keeps the reference device's block
    of the global array, under the placements ``placements`` gives."""
    _, meta = runs["jx"]
    cases = [(c, m) for c, m in zip(oracle.MESH_PLACEMENT_CASES, meta["placements"])
             if (c[0], c[1]) == oracle.MESH_SHAPE]
    for rank, res in enumerate(runs["pool"]):
        assert len(res["placements"]) == len(cases)
        for ((_, _, shape, spec), maps), (block, got_pl, want_pl) in zip(cases, res["placements"]):
            full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
            want = full[tuple(slice(a, b) for a, b in maps[rank])]
            assert block.shape == want.shape and np.array_equal(block, want), (shape, spec, rank)
            assert got_pl == want_pl, (shape, spec)


def test_placements_shard_a_dim_over_its_axes_in_mesh_order():
    class Mesh:
        axis_names = ("pod", "data", "model")

    from torch.distributed.tensor import Replicate, Shard

    assert placements((("pod", "data"), "model"), Mesh) == (Shard(0), Shard(0), Shard(1))
    assert placements((None, "data"), Mesh) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        placements((("data", "pod"),), Mesh)


def test_staged_backend_rests_on_public_torch_api():
    """The staged backend is a Python ``ProcessGroup`` whose collectives
    return a Python ``Work``, registered through ``register_backend``'s
    extended API (which hands it the group's name): a torch that changes
    any of these fails here, by name, before the mesh tests do."""
    import inspect
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.core.transport import StagedGroup, register_staged_backend

    assert "extended_api" in inspect.signature(dist.Backend.register_backend).parameters
    name = register_staged_backend()
    assert register_staged_backend() == name and name in dist.Backend.backend_list
    group = StagedGroup(dist.HashStore(), 0, 1, timedelta(seconds=30), "staged-probe")
    assert isinstance(group, dist.ProcessGroup) and group.group_name == "staged-probe"
    assert group.getBackendName() == name
    x, out = torch.arange(4.0), [[torch.empty(4)]]
    work = group.allreduce([x])
    assert isinstance(work, dist.Work) and work.wait() and work.is_completed()
    assert work.get_future().wait() is None
    group.allgather(out, [x]).wait()
    assert torch.equal(out[0][0], x) and torch.equal(x, torch.arange(4.0))
    assert group.traffic == {"allreduce": (1, 16), "allgather": (1, 32)}


# ---------------------------------------------------------------------------
# (ii) ctx=None
# ---------------------------------------------------------------------------

def test_constrain_without_a_mesh_returns_its_input():
    x = torch.arange(6.0).reshape(2, 3)
    assert constrain(x, None, ("batch", "seq")) is x


def test_model_loss_without_ctx_is_bit_equal():
    from repro_torch.data.synthetic import make_batch

    model = build_model(get_config("llama3.2-1b").reduced())
    params = model.init(threefry.PRNGKey(0), "cpu")
    batch = make_batch(model.cfg, 0, 0, 4, 32)
    a, ma = model.loss(params, batch)
    b, mb = model.loss(params, batch, ctx=None)
    assert a.numpy().tobytes() == b.numpy().tobytes()
    assert all(ma[k].numpy().tobytes() == mb[k].numpy().tobytes() for k in ma)
    assert isinstance(ShardCtx(None, model.rules).rules, type(model.rules))


# ---------------------------------------------------------------------------
# (iii) against the reference's Trainer(mesh=)
# ---------------------------------------------------------------------------

def test_sharded_trainer_takes_the_reference_steps_and_losses(runs):
    _, meta = runs["jx"]
    for res in runs["pool"]:
        got = res["faulty"]
        assert [s for s, _ in got["history"]] == [s for s, _ in meta["history"]]
        np.testing.assert_allclose([x for _, x in got["history"]], [x for _, x in meta["history"]], rtol=1e-4)
        assert got["n_recoveries"] == meta["n_recoveries"] == 2
    r0 = runs["pool"][0]["faulty"]
    assert (r0["created"], r0["aborted"]) == (meta["created"], meta["aborted"])


def test_sharded_trainer_commits_the_reference_manifests(runs):
    _, meta = runs["jx"]
    assert runs["pool"][0]["faulty"]["manifests"] == meta["manifests"]


def test_sharded_trainer_final_state_matches_reference(runs):
    arrays, _ = runs["jx"]
    _close_states(runs["pool"][0]["faulty"]["final"], lambda p: arrays["final/" + "/".join(p)], "reference")
    assert all(res["faulty"]["final"] is None for res in runs["pool"][1:])  # gathered to rank 0 alone


# ---------------------------------------------------------------------------
# (iv) against the port's one-card Trainer
# ---------------------------------------------------------------------------

def test_sharded_trainer_matches_the_one_card_trainer(runs):
    one, got = runs["one"], runs["pool"][0]["faulty"]
    assert [s for s, _ in got["history"]] == [h["step"] for h in one.history]
    np.testing.assert_allclose([x for _, x in got["history"]], [h["loss"] for h in one.history], rtol=1e-4)
    assert got["n_recoveries"] == one.n_recoveries
    assert (got["created"], got["aborted"]) == (one.engine.stats.created, one.engine.stats.aborted)
    assert got["manifests"] == ranks.committed_manifests(one.engine)
    flat = dict(zip(*tree_flatten(state_to_numpy(one.state))))
    _close_states(got["final"], lambda p: flat[p], "one card")


# ---------------------------------------------------------------------------
# (v) bitwise replay on the mesh
# ---------------------------------------------------------------------------

def test_sharded_faulty_run_is_bit_equal_to_the_clean_run(runs):
    res = runs["pool"][0]
    clean = dict(zip(*tree_flatten(res["clean"]["final"])))
    paths, leaves = tree_flatten(res["faulty"]["final"])
    assert list(clean) == paths
    for p, x in zip(paths, leaves):
        assert x.tobytes() == clean[p].tobytes(), p
    first = dict(res["clean"]["history"])
    assert all(first[s] == x for s, x in res["faulty"]["history"])  # every replayed loss bit-equal


def test_every_process_saw_the_same_run(runs):
    h = [res["faulty"]["history"] for res in runs["pool"]]
    assert all(x == h[0] for x in h)
    assert [res["modules"] for res in runs["pool"]] == [[]] * WORLD  # no jax, no repro in any process


# ---------------------------------------------------------------------------
# (vi) fsdp: the per-layer gather
# ---------------------------------------------------------------------------

def test_fsdp_preset_matches_the_reference_on_the_mesh(runs):
    arrays, meta = runs["jx"]
    got = runs["pool"][0]["fsdp"]
    assert [s for s, _ in got["history"]] == [s for s, _ in meta["fsdp_history"]]
    np.testing.assert_allclose([x for _, x in got["history"]], [x for _, x in meta["fsdp_history"]], rtol=1e-4)
    _close_states(got["final"], lambda p: arrays["fsdp/" + "/".join(p)], "fsdp")


# ---------------------------------------------------------------------------
# (vii) the decode steps raise on a DTensor, named
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["ssm", "moe"])
def test_decode_on_a_dtensor_raises_naming_the_rule(runs, what):
    for res in runs["pool"]:
        words = res["decode"][what]
        assert "has no DTensor sharding rule" in words and "no runtime path runs it on a mesh" in words, words
        assert ("Mamba-2 decode step" if what == "ssm" else "MoE in decode") in words
