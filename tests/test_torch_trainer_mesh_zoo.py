"""Every model family's sharded train step on the CPU: the port's
``Trainer(mesh=ProcessMesh)`` for MoE (``tp`` and ``ep``), Mamba-2, the
hybrid, the encoder, the VLM and gemma2, held against the JAX package's
``Trainer(mesh=)``.

One pool of 4 gloo processes (``launch.mesh.spawn``) runs every run of the
oracle's ``ZOO_RUNS`` on the (2, 2) ("data", "model") mesh, each over its
own ``file://`` rendezvous under the module's temporary directory (rank
bodies ``tests/_torch_dist_ranks.py::trainer_mesh_zoo_rank``), while the
reference runs the same runs in a child process with 8 host devices
(``_torch_jax_oracle.py trainer_mesh_zoo``: a ``jax.sharding.Mesh`` over
devices 0-3, Auto axes). Tolerances are ``tests/test_torch_trainer.py``'s:
losses rtol 1e-4, each state leaf rtol 1e-4 with atol 1e-4 of the leaf's
largest magnitude.

(i) each run's steps and losses against the reference's (the MoE runs over
their first ``ZOO_MOE_COMPARED`` steps: routing ties part the trajectories
after a few); (ii) the final state of ``ZOO_FINAL``'s runs against the
reference's; (iii) each killed run bit-equal to the port's clean run, final
state and every loss; (iv) the first step's gradients on the mesh against
the port's one-card gradients (AdamW's update is blind to a gradient's
scale, so (i) alone would pass a gradient off by a factor); (v) every
process saw the same run and loaded no ``jax``.
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
from repro_torch.launch.mesh import RankGroup
from repro_torch.utils.pytree import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 420
NAMES = [r[0] for r in oracle.ZOO_RUNS]
KILLED = [r[0] for r in oracle.ZOO_RUNS if r[4]]
MOE = ("mixtral-tp", "mixtral-ep")
GRADS = ("mixtral-tp", "mixtral-ep", "mamba2", "jamba")  # the per-shard bodies' configs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (a child process) and the 4-process pool's, at
    once; every wait bounded."""
    base = tmp_path_factory.mktemp("trainer_mesh_zoo")
    out = base / "zoo.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    child = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_jax_oracle.py"), "trainer_mesh_zoo",
                              str(out)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, env=env,
                             cwd=ROOT)
    consts = dict(case={"seed": 0, **oracle.ZOO_CASE}, kills=oracle.ZOO_KILLS, runs=oracle.ZOO_RUNS,
                  final=oracle.ZOO_FINAL, grads=GRADS, mesh=oracle.MESH_SHAPE)
    rdv = base / "rdv"
    rdv.mkdir()
    try:
        pool = RankGroup(ranks.trainer_mesh_zoo_rank, WORLD, args=(str(rdv), consts)).join(TIMEOUT)
        _, err = child.communicate(timeout=TIMEOUT)
        assert child.returncode == 0, err[-3000:]
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    return {"jx": oracle.load(str(out)), "pool": pool}


def _got(runs, name: str) -> dict:
    """Rank 0's result of the run the reference took: the killed one where
    there is one."""
    return runs["pool"][0][f"{name}/faulty" if name in KILLED else f"{name}/clean"]


def _close_states(got: dict, want_of, label: str) -> None:
    paths, leaves = tree_flatten(got)
    assert paths, label
    for p, x in zip(paths, leaves):
        want = want_of(p)
        assert x.dtype == want.dtype and x.shape == want.shape, (label, p)
        np.testing.assert_allclose(x, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"{label}: {'/'.join(p)}")


@pytest.mark.parametrize("name", NAMES)
def test_mesh_run_takes_the_reference_steps_and_losses(runs, name):
    _, meta = runs["jx"]
    got, want = _got(runs, name), meta[name]
    assert [s for s, _ in got["history"]] == [s for s, _ in want["history"]]
    n = oracle.ZOO_MOE_COMPARED if name in MOE else len(want["history"])
    np.testing.assert_allclose([x for _, x in got["history"][:n]], [x for _, x in want["history"][:n]], rtol=1e-4)
    assert got["n_recoveries"] == want["n_recoveries"] == (1 if name in KILLED else 0)


@pytest.mark.parametrize("name", oracle.ZOO_FINAL)
def test_mesh_run_final_state_matches_reference(runs, name):
    arrays, _ = runs["jx"]
    _close_states(_got(runs, name)["final"], lambda p: arrays[f"{name}/" + "/".join(p)], name)


@pytest.mark.parametrize("name", KILLED)
def test_killed_mesh_run_is_bit_equal_to_the_clean_run(runs, name):
    faulty, clean = runs["pool"][0][f"{name}/faulty"], runs["pool"][0][f"{name}/clean"]
    assert faulty["n_recoveries"] == 1 and clean["n_recoveries"] == 0
    first = dict(clean["history"])
    assert len(faulty["history"]) == len(clean["history"]) + 1  # the rolled-back step, twice
    assert all(first[s] == x for s, x in faulty["history"])  # every loss, the replayed ones too
    want = dict(zip(*tree_flatten(clean["final"])))
    paths, leaves = tree_flatten(faulty["final"])
    assert list(want) == paths
    for p, x in zip(paths, leaves):
        assert x.tobytes() == want[p].tobytes(), (name, p)


@pytest.mark.parametrize("name", GRADS)
def test_mesh_gradients_match_one_card(runs, name):
    """The loss's gradients at the first step, every leaf, against the
    one-card model's on the same params and batch."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticDataPipeline
    from repro_torch.models import build_model
    from repro_torch.utils import threefry
    from repro_torch.utils.pytree import tree_unflatten

    _, arch, over, _, _ = next(r for r in oracle.ZOO_RUNS if r[0] == name)
    model = build_model(get_config(arch).reduced().with_(**over))
    paths, live = tree_flatten(model.init(threefry.PRNGKey(0), "cpu"))
    batch = SyntheticDataPipeline(model.cfg, oracle.ZOO_CASE["batch"], oracle.ZOO_CASE["seq"], 0, device="cpu").next()
    leaves = [p.detach().requires_grad_() for p in live]
    loss, _ = model.loss(tree_unflatten(paths, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    want = {"/".join(p): g.numpy() for p, g in zip(paths, grads)}
    got = runs["pool"][0][f"{name}/grads"]
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-4 * float(np.abs(want[k]).max()), err_msg=k)


def test_every_process_saw_the_same_runs(runs):
    pool = runs["pool"]
    for key in pool[0]:
        if key != "modules" and not key.endswith("/grads"):
            assert all(res[key]["history"] == pool[0][key]["history"] for res in pool), key
            assert all(res[key]["final"] is None for res in pool[1:]), key  # gathered to rank 0 alone
    assert [res["modules"] for res in pool] == [[]] * WORLD  # no jax, no repro in any process
