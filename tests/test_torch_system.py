"""End-to-end behaviour of the port's training loop under the paper's
failure model, case for case with three of ``tests/test_system.py``'s four
cases (the fourth, ``test_combined_modes_still_bitwise``, is twinned in
``tests/test_torch_zoo_runtime.py``): MTBF-driven random failures, the
checkpoint overhead budget, and eq. 2's memory factor, each on the reduced
llama3.2-1b on the CPU.

Each case asserts what the reference asserts on the port's ``Trainer`` and
runs the reference's ``Trainer`` on the same case in-process (it needs no
mesh): the MTBF failures come from the injector's seed 5 in both, and the
kill steps (each kill's wall-clock tick, logical step and ranks), the
visited steps, the recovery count and the restores are equal; the
overhead case's creates are equal; the memory case's engine holds the same
bytes per rank and the same state bytes. Exact (integers).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as REF_CONFIGS
from repro.models import build_model as ref_build_model
from repro.runtime.failures import FailureInjector as RefInjector
from repro.runtime.trainer import Trainer as RefTrainer, TrainerConfig as RefTrainerConfig
from repro_torch.configs import CONFIGS
from repro_torch.models import build_model
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.utils.pytree import tree_flatten

ARCH = "llama3.2-1b"
MTBF = dict(mtbf_rank_s=60.0, step_time_s=1.0, seed=5)
MTBF_CASE = dict(batch=4, seq=32, total_steps=40, checkpoint_period=4, n_virtual_hosts=4, n_spares=64)
OVERHEAD_CASE = dict(batch=4, seq=32, total_steps=30, checkpoint_period=10, n_virtual_hosts=4)
MEMORY_CASE = dict(batch=4, seq=32, total_steps=12, checkpoint_period=4, n_virtual_hosts=4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced model's small ops run faster on one thread than on a
    contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return build_model(CONFIGS[ARCH].reduced()), ref_build_model(REF_CONFIGS[ARCH].reduced())


def _recording(injector):
    """The injector, each non-empty kill it draws recorded as (tick, step, ranks)."""
    kills = []
    draw = injector.kills_at_step

    def recorded(step):
        out = draw(step)
        if out:
            kills.append((injector._tick, int(step), list(out)))
        return out

    injector.kills_at_step = recorded
    return injector, kills


def test_survives_random_mtbf_failures(models):
    """Random host deaths at a harsh MTBF; the run completes, every loss is
    finite, and every recovery rolled back to a valid checkpoint; the kills
    and recoveries are the reference's."""
    port_model, ref_model = models
    inj, kills = _recording(FailureInjector(4, **MTBF))
    t = Trainer(port_model, TrainerConfig(**MTBF_CASE), injector=inj, device="cpu")
    hist = t.run(40)
    assert int(t.state["step"]) == 40
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert t.n_recoveries >= 1  # at this MTBF failures certainly happened
    assert t.engine.stats.restored == t.n_recoveries
    t.engine.close()

    rinj, ref_kills = _recording(RefInjector(4, **MTBF))
    ref = RefTrainer(ref_model, RefTrainerConfig(**MTBF_CASE), injector=rinj)
    ref_hist = ref.run(40)
    assert kills == ref_kills and len(kills) >= 1
    assert [h["step"] for h in hist] == [h["step"] for h in ref_hist]
    assert (t.n_recoveries, t.engine.stats.restored) == (ref.n_recoveries, ref.engine.stats.restored)
    assert t.engine.stats.created == ref.engine.stats.created


def test_checkpoint_overhead_budget(models):
    """Checkpoint time over total time stays modest with periodic
    checkpoints (the paper's central efficiency claim); three creates, as
    the reference makes."""
    port_model, ref_model = models
    t = Trainer(port_model, TrainerConfig(**OVERHEAD_CASE), device="cpu")
    t.run(30)
    total = t.timers("train_step").total + t.timers("checkpoint").total
    frac = t.timers("checkpoint").total / total
    assert frac < 0.5  # the host-tier engine on the CPU
    assert t.engine.stats.created == 3
    t.engine.close()

    ref = RefTrainer(ref_model, RefTrainerConfig(**OVERHEAD_CASE))
    ref.run(30)
    assert t.engine.stats.created == ref.engine.stats.created == 3
    assert t.timers("checkpoint").count == ref.timers("checkpoint").count


def test_eq2_memory_factor_observed(models):
    """Eq. 2: pairwise double-buffered stores hold about 4x one shard (own
    and partner, two buffers) once warm: more than 2x and under 6x the
    state's tensor bytes; the per-rank bytes are the reference engine's."""
    port_model, ref_model = models
    t = Trainer(port_model, TrainerConfig(**MEMORY_CASE), device="cpu")
    t.run(12)
    rep = t.engine.memory_report()
    state_bytes = sum(x.numel() * x.element_size() for x in tree_flatten(t.state)[1])
    total_stored = rep["total_bytes"]
    assert total_stored > 2 * state_bytes
    assert total_stored < 6 * state_bytes
    t.engine.close()

    ref = RefTrainer(ref_model, RefTrainerConfig(**MEMORY_CASE))
    ref.run(12)
    ref_rep = ref.engine.memory_report()
    ref_state_bytes = sum(np.asarray(x).nbytes for x in jax.tree.leaves(jax.device_get(ref.state)))
    assert state_bytes == ref_state_bytes
    assert rep["bytes_per_rank"] == ref_rep["bytes_per_rank"]
    assert rep["by_kind"] == ref_rep["by_kind"]
    assert (rep["total_bytes"], rep["codec"], rep["redundancy_overhead"]) == (
        ref_rep["total_bytes"], ref_rep["codec"], ref_rep["redundancy_overhead"])
