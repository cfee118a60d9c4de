"""The port's fault-tolerant Trainer and Server on the MoE, Mamba-2 and hybrid
families (reduced, f32, on the CPU): the scheme is architecture-agnostic.

* Twins of ``tests/test_recovery_e2e.py::test_moe_arch_recovery`` and
  ``::test_ssm_arch_recovery`` (and jamba, the hybrid): a host killed
  mid-run, one recovery, the final state bit-equal to the clean run's.
  The reference's ``Trainer`` runs the same case in-process (it needs no
  mesh) from the same seed: the port draws its batches byte for byte and
  its initial state within 4 ulp, takes the same steps, recovers as often,
  and its losses agree within rtol 1e-4.
* Twin of ``tests/test_system.py::test_combined_modes_still_bitwise``:
  gemma2-2b (local/global attention, softcaps) with the xor codec
  (``parity_group=2``) and the checksum handshake through a kill.
* The session ShardPlans of the MoE, SSM and hybrid caches equal the
  reference server's (and the train state's, the reference trainer's).
* The port's ``Server`` on reduced mixtral and mamba2 from the reference's
  params: its tokens equal the reference ``Server``'s, then bit-equal after
  a kill (the restore writes the MoE's KV cache, or the SSM's conv history
  and state, back in place). Decode routes 4 tokens in one group, so MoE
  capacity (C = 2) drops slots there too.
"""

from __future__ import annotations

from dataclasses import astuple

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.core.checkpoint import EngineConfig
from repro_torch.launch.steps import state_from_numpy, state_to_numpy
from repro_torch.models import build_model
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.utils.pytree import tree_flatten

STEPS = 12
CASE = dict(batch=4, seq=32, total_steps=STEPS, checkpoint_period=4, n_virtual_hosts=4)
# tests/test_recovery_e2e.py's kills (jamba: a host the other two runs spare)
KILLS = {"mixtral-8x7b": {6: [2]}, "mamba2-780m": {7: [0]}, "jamba-1.5-large-398b": {6: [1]}}
SERVE = dict(batch=4, max_seq=40, checkpoint_every_tokens=6)  # tests/test_server.py's
GEN = 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops run faster on one thread than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bitwise(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[1], tree_flatten(b)[1]))


def _same_plan(port, ref, worlds=(4, 3, 8)) -> None:
    """Split dims, shapes and every rank's shard coordinates equal."""
    assert port.dims == ref.dims and port.shapes == ref.shapes
    for n in worlds:
        assert [[astuple(c) for c in rank] for rank in port.shard_coords(n)] == [
            [astuple(c) for c in rank] for rank in ref.shard_coords(n)], n


def _run(arch: str, kills: dict | None, **kw) -> Trainer:
    model = build_model(get_config(arch).reduced())
    inj = FailureInjector(4, schedule=kills) if kills else None
    t = Trainer(model, TrainerConfig(**{**CASE, **kw}), injector=inj, device="cpu")
    t.run(STEPS)
    t.engine.close()
    return t


@pytest.fixture(scope="module")
def runs():
    """Each arch's clean run and its run through KILLS (2 spares)."""
    return {arch: (_run(arch, None), _run(arch, kills, n_spares=2)) for arch, kills in KILLS.items()}


@pytest.mark.parametrize("arch", sorted(KILLS))
def test_arch_recovery_is_bitwise(runs, arch):
    clean, killed = runs[arch]
    assert killed.n_recoveries == 1 and clean.n_recoveries == 0
    assert _bitwise(killed.state, clean.state)
    by_step = {h["step"]: h["loss"] for h in clean.history}
    assert all(h["loss"] == by_step[h["step"]] for h in killed.history)
    assert all(("moe_aux" in h) == get_config(arch).has_moe for h in killed.history)


@pytest.mark.parametrize("arch", ["mamba2-780m", "mixtral-8x7b"])
def test_trainer_matches_reference(runs, arch):
    from repro.runtime.failures import FailureInjector as RefInjector
    from repro.runtime.trainer import Trainer as RefTrainer, TrainerConfig as RefTrainerConfig

    _, port = runs[arch]
    ref = RefTrainer(ref_build_model(ref_get_config(arch).reduced()), RefTrainerConfig(**CASE, n_spares=2),
                     injector=RefInjector(4, schedule=KILLS[arch]))
    init = {tuple(str(k.key) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jax.device_get(ref.state))[0]}
    fresh = Trainer(build_model(get_config(arch).reduced()), TrainerConfig(**CASE), device="cpu")
    for step in range(STEPS):
        for k, v in ref.data.peek(step).items():
            assert fresh.data.peek(step)[k].numpy().tobytes() == np.asarray(v).tobytes(), (step, k)
    for p, x in zip(*tree_flatten(state_to_numpy(fresh.state))):
        want = init[p]
        assert x.dtype == want.dtype and x.shape == want.shape, p
        if x.dtype == np.float32:
            assert np.abs(x.view(np.int32).astype(np.int64) - want.view(np.int32)).max() <= 4, p
        else:
            assert x.tobytes() == want.tobytes(), p
    _same_plan(fresh.plan, ref.plan)
    fresh.engine.close()
    hist = ref.run(STEPS)
    ref.engine.close()
    assert [h["step"] for h in port.history] == [h["step"] for h in hist]
    np.testing.assert_allclose([h["loss"] for h in port.history], [h["loss"] for h in hist], rtol=1e-4)
    assert port.n_recoveries == ref.n_recoveries == 1


def test_combined_modes_still_bitwise():
    """Parity and validation together under a fault (gemma2-2b): the
    trajectory matches the fault-free run bitwise."""
    base = dict(total_steps=18, checkpoint_period=6)
    model = build_model(get_config("gemma2-2b").reduced())
    ref = Trainer(model, TrainerConfig(**{**CASE, **base}), device="cpu")
    ref.run(18)
    t = Trainer(model, TrainerConfig(**{**CASE, **base}, n_spares=2,
                                     engine=EngineConfig(parity_group=2, validate=True)),
                injector=FailureInjector(4, schedule={8: [3]}), device="cpu")
    t.run(18)
    assert t.engine.codec.name == "xor" and t.n_recoveries == 1
    assert _bitwise(t.state, ref.state)
    ref.engine.close()
    t.engine.close()


@pytest.mark.parametrize("arch", sorted(KILLS))
@pytest.mark.parametrize("batch", [4, 16])
def test_session_plan_matches_reference(arch, batch):
    """The session ShardPlan (the MoE's KV cache, the SSM's conv and state)
    from the production decode rules equals the reference server's."""
    from repro.runtime.server import Server as RefServer, ServerConfig as RefServerConfig

    ref_model = ref_build_model(ref_get_config(arch).reduced())
    params = jax.device_get(ref_model.init(jax.random.PRNGKey(1)))
    ref = RefServer(ref_model, RefServerConfig(batch=batch, max_seq=32), params=params)
    port = Server(build_model(get_config(arch).reduced()), ServerConfig(batch=batch, max_seq=32),
                  params=state_from_numpy(params, device="cpu"), device="cpu")
    _same_plan(port.plan, ref.plan)
    ref.engine.close()
    port.close()


@pytest.mark.parametrize("arch", ["mamba2-780m", "mixtral-8x7b"])
def test_server_matches_reference_through_a_kill(arch):
    from repro.runtime.server import Server as RefServer, ServerConfig as RefServerConfig

    ref_model = ref_build_model(ref_get_config(arch).reduced())
    params = jax.device_get(ref_model.init(jax.random.PRNGKey(1)))
    prompts = np.random.default_rng(0).integers(0, ref_model.cfg.vocab_size, (4, 8), dtype=np.int32)
    srv = RefServer(ref_model, RefServerConfig(**SERVE), params=params)
    want = np.asarray(srv.prefill_and_decode(prompts, GEN))
    srv.engine.close()

    model = build_model(get_config(arch).reduced())
    outs = []
    for kills in ({}, {10: [2]}):
        s = Server(model, ServerConfig(**SERVE), params=state_from_numpy(params, device="cpu"),
                   injector=FailureInjector(4, schedule=kills), device="cpu")
        outs.append(s.prefill_and_decode(prompts, GEN))
        s.close()
        assert s.n_recoveries == len(kills)
    np.testing.assert_array_equal(outs[0], want)
    np.testing.assert_array_equal(outs[1], want)
