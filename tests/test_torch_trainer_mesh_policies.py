"""The recovery policies and the out-of-run calls of the sharded ``Trainer``
on the CPU, held against the JAX package's ``Trainer(mesh=)``.

One pool of 4 gloo processes (``launch.mesh.spawn``) runs, on the (2, 2)
("data", "model") mesh and each over its own ``file://`` rendezvous (rank
bodies ``tests/_torch_dist_ranks.py::trainer_mesh_policies_rank``): the
reduced llama with no spares through ``POLICY_KILLS`` under "shrink" and
under "elastic", the same run clean, and ``OUT_OF_RUN_CASE``'s sequence
(``run(4)``, ``restore_elastic(2)``, ``regrow(4)``, ``run(6)``, then a fresh
2-host job's ``cold_restart()`` and ``run``) over a disk rung under the
module's temporary directory. The reference runs the same in a child
process with 8 host devices (``_torch_jax_oracle.py trainer_mesh_policies``).
Tolerances are ``tests/test_torch_trainer.py``'s: losses rtol 1e-4, each
state leaf rtol 1e-4 with atol 1e-4 of the leaf's largest magnitude.

(i) each policy's history, recoveries, the engine's rank count, created
and aborted checkpoints, committed manifests and final state against the
reference's; (ii) each policy's run bit-equal to the clean run; (iii) the
out-of-run sequence's histories, restored steps, the engine after each
call and both final states against the reference's; (iv) every process
saw the same run and loaded no ``jax``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_dist_ranks as ranks
import _torch_jax_oracle as oracle
from repro_torch.launch.mesh import RankGroup
from repro_torch.utils.pytree import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 300
POLICIES = ("shrink", "elastic")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (a child process) and the 4-process pool's, at
    once; every wait bounded."""
    base = tmp_path_factory.mktemp("trainer_mesh_policies")
    out = base / "policies.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    child = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_jax_oracle.py"), "trainer_mesh_policies",
                              str(out)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, env=env,
                             cwd=ROOT)
    consts = dict(case=oracle.POLICY_CASE, kills=oracle.POLICY_KILLS, steps=oracle.POLICY_STEPS,
                  out_case=oracle.OUT_OF_RUN_CASE, resume=oracle.POLICY_RESUME_STEPS, mesh=oracle.MESH_SHAPE)
    rdv, tier = base / "rdv", base / "tier"
    rdv.mkdir()
    try:
        pool = RankGroup(ranks.trainer_mesh_policies_rank, WORLD, args=(str(rdv), str(tier), consts)).join(TIMEOUT)
        _, err = child.communicate(timeout=TIMEOUT)
        assert child.returncode == 0, err[-3000:]
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    return {"jx": oracle.load(str(out)), "pool": pool}


def _close_states(got: dict, want_of, label: str) -> None:
    paths, leaves = tree_flatten(got)
    assert paths, label
    for p, x in zip(paths, leaves):
        want = want_of(p)
        assert x.dtype == want.dtype and x.shape == want.shape, (label, p)
        np.testing.assert_allclose(x, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"{label}: {'/'.join(p)}")


def _close_histories(got: list, want: list) -> None:
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want], rtol=1e-4)


# ---------------------------------------------------------------------------
# (i), (ii) "shrink" and "elastic" in run()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_policy_takes_the_reference_steps_and_losses(runs, policy):
    _, meta = runs["jx"]
    got, want = runs["pool"][0][policy], meta[policy]
    _close_histories(got["history"], want["history"])
    assert got["n_recoveries"] == want["n_recoveries"] == 1


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_leaves_the_reference_engine(runs, policy):
    """The engine's rank count (3 after the shrink), created and aborted
    checkpoints and every committed store's manifests."""
    _, meta = runs["jx"]
    got, want = runs["pool"][0][policy]["engine"], meta[policy]
    assert got["n_ranks"] == want["n_ranks"] == 3
    assert (got["created"], got["aborted"]) == (want["created"], want["aborted"])
    assert got["manifests"] == want["manifests"]


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_final_state_matches_reference(runs, policy):
    arrays, _ = runs["jx"]
    _close_states(runs["pool"][0][policy]["final"], lambda p: arrays[f"{policy}/" + "/".join(p)], policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_run_is_bit_equal_to_the_clean_run(runs, policy):
    got, clean = runs["pool"][0][policy], runs["pool"][0]["clean"]
    first = dict(clean["history"])
    assert len(got["history"]) == len(clean["history"]) + 1
    assert all(first[s] == x for s, x in got["history"])
    want = dict(zip(*tree_flatten(clean["final"])))
    paths, leaves = tree_flatten(got["final"])
    assert list(want) == paths
    for p, x in zip(paths, leaves):
        assert x.tobytes() == want[p].tobytes(), (policy, p)


# ---------------------------------------------------------------------------
# (iii) restore_elastic, regrow and cold_restart outside run()
# ---------------------------------------------------------------------------

def test_out_of_run_calls_take_the_reference_steps(runs):
    _, meta = runs["jx"]
    got, want = runs["pool"][0]["out"], meta["out"]
    for key in ("first", "second", "resumed"):
        _close_histories(got[key], want[key])
    assert (got["elastic_step"], got["cold_step"]) == (want["elastic_step"], want["cold_step"])
    assert got["n_recoveries"] == want["n_recoveries"]
    assert got["resumed"], "the cold-restarted job took no step"


@pytest.mark.parametrize("at", ["after_elastic", "after_regrow", "end", "cold"])
def test_out_of_run_calls_leave_the_reference_engine(runs, at):
    """Rank counts 2, 4, 4 and 2; created, aborted and the committed
    manifests after each call."""
    _, meta = runs["jx"]
    got, want = runs["pool"][0]["out"][at], meta["out"][at]
    assert got["n_ranks"] == want["n_ranks"] == {"after_elastic": 2, "after_regrow": 4, "end": 4, "cold": 2}[at]
    assert (got["created"], got["aborted"]) == (want["created"], want["aborted"])
    assert got["manifests"] == want["manifests"]


@pytest.mark.parametrize("which", ["out", "cold"])
def test_out_of_run_final_states_match_reference(runs, which):
    arrays, _ = runs["jx"]
    got = runs["pool"][0]["out"]["final" if which == "out" else "cold_final"]
    _close_states(got, lambda p: arrays[f"{which}/" + "/".join(p)], which)


# ---------------------------------------------------------------------------
# (iv) every process
# ---------------------------------------------------------------------------

def test_every_process_saw_the_same_runs(runs):
    pool = runs["pool"]
    for key in ("shrink", "elastic", "clean"):
        assert all(res[key]["history"] == pool[0][key]["history"] for res in pool), key
        assert all(res[key]["n_recoveries"] == pool[0][key]["n_recoveries"] for res in pool), key
        assert all(res[key]["engine"] is None and res[key]["final"] is None for res in pool[1:]), key
    for key in ("first", "second", "resumed", "elastic_step", "cold_step", "n_recoveries"):
        assert all(res["out"][key] == pool[0]["out"][key] for res in pool), key
    assert [res["modules"] for res in pool] == [[]] * WORLD  # no jax, no repro in any process
