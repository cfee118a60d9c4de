"""The port's fault-tolerant training loop (paper Algorithm 3) on the CPU.

1. Against the reference: the JAX package's ``Trainer`` runs
   ``_torch_jax_oracle.TRAINER_CASE`` (reduced llama3.2-1b, 20 steps, hosts
   killed at steps 8 and 17, 4 spares) in a child process; the port's
   ``Trainer``, from the same seed (so the reference's batches, byte for
   byte, and its initial state to a few ulp), takes the same steps (replays
   included), recovers as often, creates and aborts
   as many checkpoints, commits the same manifests (leaf paths, shapes,
   dtypes, offsets, coords), and ends within tolerance: losses rtol 1e-4,
   every state leaf rtol 1e-4 with atol 1e-4 of the leaf's largest
   magnitude (entries that cancel to near 0 keep only absolute precision).
2. The port alone, mirroring ``tests/test_recovery_e2e.py``: after kills,
   shrinks, elastic repartitions and regrowth the final state is bitwise
   equal to a fault-free run.
   With a host xor or rs engine too (parity-mode recovery).
3. The Trainer needs a card unless asked for the CPU, and
   ``examples/quickstart_torch.py --device cpu`` passes its own assertion.
   (The storage-tier cases are in ``tests/test_torch_storage.py``.)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_jax_oracle as oracle
from repro_torch.configs import get_config
from repro_torch.core.checkpoint import EngineConfig
from repro_torch.core.distribution import DataLostError
from repro_torch.launch.steps import state_to_numpy
from repro_torch.models import build_model
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.utils.pytree import tree_flatten
from test_torch_device_tier import run_oracle

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced model's small ops run faster on one thread than on a
    contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return build_model(get_config("llama3.2-1b").reduced())


def _tcfg(**kw) -> TrainerConfig:
    base = dict(batch=4, seq=32, total_steps=20, checkpoint_period=5, n_virtual_hosts=4)
    base.update(kw)
    return TrainerConfig(**base)


def _trainer(model, tcfg, **kw) -> Trainer:
    return Trainer(model, tcfg, device="cpu", **kw)


def _copy(state):
    paths, leaves = tree_flatten(state)
    return dict(zip(paths, [x.clone() for x in leaves]))


# ---------------------------------------------------------------------------
# 1. against the reference Trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return run_oracle("trainer", tmp_path_factory.mktemp("oracle") / "trainer.npz")


@pytest.fixture(scope="module")
def port_run(model):
    tcfg = TrainerConfig(**oracle.TRAINER_CASE)
    t = _trainer(model, tcfg, injector=FailureInjector(4, schedule=oracle.TRAINER_KILLS))
    t.run(oracle.TRAINER_STEPS)
    return t


def test_trainer_starts_from_the_reference_state_and_batches(jx, model):
    """From the reference's seed the port's Trainer draws the reference's
    batches byte for byte and its initial state to within 4 ulp (f32 normal
    draws: the erfinv's log1p differs; the constant and integer leaves and
    the moments are exact)."""
    arrays, _ = jx
    t = _trainer(model, TrainerConfig(**oracle.TRAINER_CASE))
    for step in range(oracle.TRAINER_STEPS):
        for k, v in t.data.peek(step).items():
            assert v.numpy().tobytes() == arrays[f"batch/{step}/{k}"].tobytes(), (step, k)
    for p, x in zip(*tree_flatten(state_to_numpy(t.state))):
        want = arrays["init/" + "/".join(p)]
        assert x.dtype == want.dtype and x.shape == want.shape, p
        if x.dtype == np.float32:
            ulps = np.abs(x.view(np.int32).astype(np.int64) - want.view(np.int32))
            assert ulps.max() <= 4, p
        else:
            assert x.tobytes() == want.tobytes(), p


def test_trainer_takes_the_reference_steps_and_losses(jx, port_run):
    _, meta = jx
    t = port_run
    assert [h["step"] for h in t.history] == [s for s, _ in meta["history"]]
    np.testing.assert_allclose([h["loss"] for h in t.history], [x for _, x in meta["history"]], rtol=1e-4)
    assert t.n_recoveries == meta["n_recoveries"] == 2
    assert (t.engine.stats.created, t.engine.stats.aborted) == (meta["created"], meta["aborted"])


def test_trainer_commits_the_reference_manifests(jx, port_run):
    _, meta = jx
    _, stores = oracle.dump_engine(port_run.engine, lambda t: t.numpy())
    got = {r: {"own": d["own"], "manifests": d["manifests"], "step": d["step"]}
           for r, d in stores["stores"].items()}
    assert got == meta["manifests"]


def test_trainer_final_state_matches_reference(jx, port_run):
    arrays, _ = jx
    for p, x in zip(*tree_flatten(state_to_numpy(port_run.state))):
        want = arrays["final/" + "/".join(p)]
        assert x.dtype == want.dtype and x.shape == want.shape, p
        np.testing.assert_allclose(x, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg="/".join(p))


# ---------------------------------------------------------------------------
# 2. bitwise replay after rollbacks (the port alone)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(model):
    t = _trainer(model, _tcfg())
    t.run(20)
    return _copy(t.state)


def _same(state, ref) -> bool:
    paths, leaves = tree_flatten(state)
    return list(ref) == paths and all(torch.equal(ref[p], x) for p, x in zip(paths, leaves))


def test_faultfree_loss_decreases(model):
    t = _trainer(model, _tcfg(total_steps=50, batch=8, seq=64, lr=3e-3, warmup_steps=5))
    hist = t.run(50)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.3


def test_spare_recovery_bitwise(model, reference):
    t = _trainer(model, _tcfg(n_spares=4, recovery_policy="spare"),
                 injector=FailureInjector(4, schedule={8: [1], 17: [2]}))
    t.run(20)
    assert t.n_recoveries == 2
    assert _same(t.state, reference)


def test_shrink_recovery_bitwise(model, reference):
    t = _trainer(model, _tcfg(recovery_policy="shrink"), injector=FailureInjector(4, schedule={12: [3]}))
    t.run(20)
    assert t.n_recoveries == 1
    assert t.engine.n_ranks == 3
    assert _same(t.state, reference)


def test_fault_during_checkpoint_bitwise(model, reference):
    """Algorithm 2: a host dying mid-checkpoint aborts it, the previous one
    restores, and the trajectory still replays identically."""
    t = _trainer(model, _tcfg(n_spares=2), injector=FailureInjector(4, checkpoint_schedule={1: [0]}))
    t.run(20)
    assert t.n_recoveries >= 1
    assert t.engine.stats.aborted >= 1
    assert _same(t.state, reference)


def test_multiple_sequential_failures_bitwise(model, reference):
    t = _trainer(model, _tcfg(n_spares=4), injector=FailureInjector(4, schedule={6: [0], 11: [1], 16: [3]}))
    t.run(20)
    assert t.n_recoveries == 3
    assert _same(t.state, reference)


def test_elastic_policy_bitwise(model, reference):
    """No spares, recovery_policy="elastic": the checkpoint is repartitioned
    onto the 3 survivors and re-protected before the next step."""
    t = _trainer(model, _tcfg(recovery_policy="elastic"), injector=FailureInjector(4, schedule={12: [3]}))
    t.run(20)
    assert t.n_recoveries == 1
    assert t.engine.n_ranks == 3 and t.cluster.n_ranks == 3
    assert t.engine.last_elastic_report.n_old == 4
    assert _same(t.state, reference)


def test_restore_elastic_4_to_2_bitwise(model, reference):
    t = _trainer(model, _tcfg())
    t.run(12)                     # checkpoints at steps 5 and 10
    meta = t.restore_elastic(2)   # back to step 10 on 2 ranks, re-protected
    assert meta["step"] == 10 and int(t.state["step"]) == 10
    assert t.engine.n_ranks == 2 and t.cluster.n_ranks == 2
    assert t.engine.stats.created == 3 and t.engine.checkpoint_step()["step"] == 10
    t.run(20)
    assert _same(t.state, reference)


def test_shrink_then_regrow_bitwise(model, reference):
    t = _trainer(model, _tcfg(recovery_policy="shrink"), injector=FailureInjector(4, schedule={8: [2]}))
    t.run(12)
    assert t.engine.n_ranks == 3
    t.regrow(4)
    assert t.engine.n_ranks == 4
    t.run(20)
    assert _same(t.state, reference)
    # the regrown world is protected again: kill a rank and recover
    t.injector = FailureInjector(4, schedule={22: [1]})
    t.run(26)
    assert int(t.state["step"]) == 26
    assert t.n_recoveries == 2


def test_simultaneous_pair_failure_is_fatal(model):
    """Killing a rank and its pairwise partner between checkpoints loses data."""
    t = _trainer(model, _tcfg(n_spares=4), injector=FailureInjector(4, schedule={8: [1, 3]}))
    with pytest.raises(DataLostError):
        t.run(20)


def test_daly_scheduler_used_when_no_period(model):
    # MTBF small enough that the Daly period hits the 1-step clamp
    t = _trainer(model, _tcfg(checkpoint_period=None, mtbf_individual_s=4e-4))
    t.run(12)
    assert t.engine.stats.created >= 1


# ---------------------------------------------------------------------------
# 3. the card, the quickstart twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,kills", [
    (EngineConfig(parity_group=2), [2]),
    (EngineConfig(parity_group=2, restore_mode="sync"), [1]),
    (EngineConfig(codec="rs", parity_group=2, rs_parity=2), [2, 3]),
    (EngineConfig(codec="rs", parity_group=2, rs_parity=2, restore_mode="sync"), [0, 1]),
], ids=["xor", "xor-sync", "rs-whole-group", "rs-whole-group-sync"])
def test_parity_mode_recovery_bitwise(model, reference, engine, kills):
    """tests/test_recovery_e2e.py::test_parity_mode_recovery_bitwise: the
    Trainer on a host xor or rs engine (groups of 2 of its 4 hosts) loses
    hosts at step 8, rebuilds their shards from the parity stripes on the
    other group (rs: both members of one group at once) and ends bitwise
    equal to the fault-free run."""
    t = _trainer(model, _tcfg(n_spares=2, engine=engine), injector=FailureInjector(4, schedule={8: kills}))
    t.run(20)
    assert t.n_recoveries == 1
    assert t.engine.stats.reconstructed_restores > 0 and t.engine.codec.name == (engine.codec or "xor")
    assert _same(t.state, reference)


def test_trainer_needs_cuda_unless_asked_for_the_cpu(model):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model, _tcfg())


def test_quickstart_torch_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart_torch.py"), "--device", "cpu"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "recoveries: 1" in proc.stdout and "OK" in proc.stdout.splitlines()[-1]


def test_chip_smoke_phase7_rehearses_on_the_cpu():
    """``chip_smoke.py``'s training-loop phase at a small config on the CPU
    (``tools/rehearse_chip_smoke.py --phase7``): its checks pass."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "rehearse_chip_smoke.py"), "--phase7"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    run = json.loads(proc.stdout.strip().splitlines()[-2])
    assert run["restore"]["leaves_equal"] == run["restore"]["leaves"] > 0
    assert run["loss"][3:5] == run["loss"][5:7]
