"""The port's hot-replica teams against the JAX package's, on the CPU.

Each serving drill of tests/test_replica.py (the whole primary team lost,
the primary dying mid-checkpoint, a shadow member dying during catch-up, a
primary and a shadow rank in one burst, a silent death caught by the
heartbeat) runs on both packages' ``Server`` with reduced llama3.2-1b, the
same params, prompts, kills and hooks. The tokens must equal the fault-free
run's; promotions, ``bytes_synced`` and the ``replica_promote`` and
``replica_sync`` journal records (less their times) must equal the
reference's. Then tests/test_replica.py's striped compressed-exchange round
trip on both engines. Its heartbeat unit cases run in
tests/test_torch_cluster.py.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.launch.steps import state_from_numpy
from repro_torch.models import build_model
from repro_torch.runtime import failures as t_failures
from repro_torch.runtime import server as t_server
from repro_torch.runtime.replica import STATES

ROOT = Path(__file__).resolve().parents[1]
SERVE = dict(batch=4, max_seq=40, checkpoint_every_tokens=6)  # tests/test_replica.py's
GEN = 24
RS = dict(codec="rs", parity_group=2, rs_parity=2)
TIMES = ("ts", "duration_s")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model

    jcfg = ref_get_config("llama3.2-1b").reduced()
    ref_model = ref_build_model(jcfg)
    params = jax.device_get(ref_model.init(jax.random.PRNGKey(1)))
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 8), dtype=np.int32)
    return {"reference": (ref_model, params), "port": (build_model(get_config("llama3.2-1b").reduced()),
                                                      state_from_numpy(params, device="cpu"))}, prompts


def _packages():
    from repro.core.checkpoint import EngineConfig as RefEngineConfig
    from repro.runtime import failures as j_failures
    from repro.runtime import server as j_server

    return {"reference": (j_server, j_failures, RefEngineConfig), "port": (t_server, t_failures, EngineConfig)}


def _drill(setup, injector_kw=None, hook=None, **cfg_kw) -> dict:
    """One drill on both packages: ``hook(server)`` installs its fault hooks
    before serving. Returns {package: (server, tokens)}."""
    models, prompts = setup
    out = {}
    for name, (srv_mod, fail_mod, engine_cfg) in _packages().items():
        model, params = models[name]
        scfg = srv_mod.ServerConfig(**SERVE, replica_team=True, engine=engine_cfg(**RS), **cfg_kw)
        kw = {"device": "cpu"} if name == "port" else {}
        injector = fail_mod.FailureInjector(4, **injector_kw) if injector_kw else None
        s = srv_mod.Server(model, scfg, params=params, injector=injector, **kw)
        if hook is not None:
            hook(s)
        out[name] = (s, np.asarray(s.prefill_and_decode(prompts, GEN)))
        s.engine.close()
        s.replica.engine.close()
    return out


def _events(server, kind: str) -> list[dict]:
    return [{k: v for k, v in e.items() if k not in TIMES} for e in server.engine.journal.events(kind)]


def _same_as_reference(runs: dict) -> tuple:
    (ps, pout), (rs, rout) = runs["port"], runs["reference"]
    assert np.array_equal(pout, rout)
    assert (ps.promotions, ps.n_recoveries) == (rs.promotions, rs.n_recoveries)
    assert (ps.replica.syncs, ps.replica.bytes_synced, ps.replica.state) == (
        rs.replica.syncs, rs.replica.bytes_synced, rs.replica.state)
    for kind in ("replica_promote", "replica_sync"):
        assert _events(ps, kind) == _events(rs, kind), kind
    return ps, pout


@pytest.fixture(scope="module")
def clean(setup):
    models, prompts = setup
    model, params = models["port"]
    s = t_server.Server(model, t_server.ServerConfig(**SERVE), params=params, device="cpu")
    out = s.prefill_and_decode(prompts, GEN)
    s.close()
    return out


def test_whole_primary_team_lost_promotion_is_zero_comm(setup, clean):
    s, out = _same_as_reference(_drill(setup, dict(schedule={13: [0, 1, 2, 3]})))
    assert np.array_equal(out, clean)
    assert s.promotions == 1 and s.n_recoveries == 1
    assert s.engine.stats.last_restore_bytes_rebuilt == 0
    ev = s.engine.journal.events("replica_promote")
    assert len(ev) == 1 and ev[0]["zero_comm"] and ev[0]["failed_primary"] == 4
    # the old team rebuilt and lazy-synced back to ready
    assert s.replica.state == "ready" and s.replica.syncs >= 1 and s.replica.bytes_synced > 0
    assert s.replica.rebuild_s > 0 and s.replica.blocked_sync_s > 0


def test_primary_dies_mid_checkpoint_replica_one_gen_behind(setup, clean):
    def hook(s):
        fired = {"done": False}

        def kill_after_create(phase):
            if phase == "after_create" and s.engine.stats.created >= 2 and not fired["done"]:
                fired["done"] = True
                s.cluster.kill(2)

        s.engine._fault_hook = kill_after_create
        s.fired = fired

    runs = _drill(setup, hook=hook)
    s, out = _same_as_reference(runs)
    assert s.fired["done"] and runs["reference"][0].fired["done"]
    assert np.array_equal(out, clean)
    assert s.promotions == 1
    assert s.engine.stats.last_restore_bytes_rebuilt == 0  # the shadow was intact


def test_replica_member_dies_during_catch_up_codec_rebuilds_it(setup, clean):
    def hook(s):
        fired = {"done": False}

        def mid_sync_kill(member):
            # once, between member 0's install and member 1's
            if member == 1 and s.replica.syncs >= 1 and not fired["done"]:
                fired["done"] = True
                s.replica.cluster.kill(1, cause="replica_host_failure")

        s.replica._fault_hook = mid_sync_kill
        s.fired = fired

    s, out = _same_as_reference(_drill(setup, dict(schedule={13: [0]}), hook=hook))
    assert s.fired["done"] and np.array_equal(out, clean)
    assert s.promotions == 1
    ev = s.engine.journal.events("replica_promote")
    assert len(ev) == 1 and not ev[0]["zero_comm"] and ev[0]["failed_shadow"] == 1
    assert s.engine.stats.reconstructed_restores >= 1


def test_primary_and_replica_ranks_die_in_one_burst(setup, clean):
    s, out = _same_as_reference(_drill(setup, dict(schedule={13: [2]}, replica_schedule={13: [1]})))
    assert np.array_equal(out, clean)
    assert s.promotions == 1 and s.n_recoveries == 1
    ev = s.engine.journal.events("replica_promote")
    assert len(ev) == 1 and ev[0]["failed_primary"] == 1 and ev[0]["failed_shadow"] == 1
    assert s.engine.stats.reconstructed_restores >= 1


def test_silent_death_detected_by_heartbeat_within_budget(setup, clean):
    """No replica team here (tests/test_replica.py runs it on the default
    server): only the heartbeat timeout sees the death."""
    models, prompts = setup
    model, params = models["port"]
    detected = []
    inj = t_failures.FailureInjector(4, silent_schedule={9: [2]}, max_detection_ticks=8,
                                     detection_hook=lambda rank, latency: detected.append((rank, latency)))
    s = t_server.Server(model, t_server.ServerConfig(**SERVE), params=params, injector=inj, device="cpu")
    out = s.prefill_and_decode(prompts, GEN)
    s.close()
    assert np.array_equal(out, clean)
    assert s.n_recoveries == 1
    assert detected and detected[0][0] == 2 and detected[0][1] <= 8
    lost = s.engine.journal.events("heartbeat_lost")
    assert lost and lost[0]["rank"] == 2


def test_states_and_release_guard(setup):
    """The state machine's names, and no promotion before a synced
    generation."""
    models, _ = setup
    model, params = models["port"]
    s = t_server.Server(model, t_server.ServerConfig(**SERVE, replica_team=True), params=params, device="cpu")
    assert STATES == ("enrolled", "syncing", "ready", "promoted")
    assert s.replica.state == "enrolled" and not s.replica.can_promote
    assert s.replica.catch_up() is False  # nothing staged
    with pytest.raises(RuntimeError):
        s.replica.release()
    s.close()


def test_failover_drill_example(tmp_path):
    """examples/failover_drill_torch.py on the CPU: the whole primary team
    killed, the shadow promoted, tokens bit-identical, the promotion stall
    under one checkpoint interval (read from its trace)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "failover_drill_torch.py"), "--device", "cpu", "--reduced",
         "--trace-out", str(tmp_path / "trace.json"), "--journal-out", str(tmp_path / "journal.jsonl")],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "failover drill PASSED" in proc.stdout
    assert "replica_promote" in (tmp_path / "journal.jsonl").read_text()


@pytest.mark.parametrize("codec", ["xor", "rs"])
def test_striped_codec_compressed_exchange_roundtrip(codec):
    """tests/test_replica.py's case on both engines: the exchange subset
    travels compressed in ``own_exch``, the rebuilt rank is within 2% of its
    original, survivors are exact, and both engines move the same bytes."""
    from repro.core.checkpoint import CheckpointEngine as RefEngine, EngineConfig as RefConfig

    n = 4
    sizes = {}
    for pkg, (engine_cls, cfg_cls) in {"reference": (RefEngine, RefConfig),
                                       "port": (CheckpointEngine, EngineConfig)}.items():
        for label, compress in (("plain", False), ("compressed", True)):
            kw = {"device": "cpu"} if pkg == "port" else {}
            eng = engine_cls(n, cfg_cls(codec=codec, parity_group=2, rs_parity=2, compress=compress), **kw)
            vec_data = [np.arange(16384, dtype=np.float32) + 1000 * r for r in range(n)]
            eng.register("state", _Vec(vec_data, torch_payload=pkg == "port"))
            assert eng.checkpoint({"step": 1})
            sizes[pkg, label] = eng.stats.last_bytes_exchanged
            if not compress:
                eng.close()
                continue
            for st in eng.stores.values():
                ro = st.buffer.read_only
                assert "state" in ro.own_exch
                _, man = ro.own_exch["state"]
                assert man is not None and man[0] == "compressed", man
            orig = [d.copy() for d in vec_data]
            for d in vec_data:
                d += 999.0
            eng.stores[1].wipe()
            eng.restore()
            assert eng.stats.reconstructed_restores >= 1
            for r in range(n):
                if r == 1:  # rebuilt from parity over compressed bytes: lossy
                    assert np.abs(vec_data[r] - orig[r]).max() / np.abs(orig[r]).max() < 0.02
                else:
                    assert np.array_equal(vec_data[r], orig[r]), r
            eng.close()
    assert sizes["port", "compressed"] < sizes["port", "plain"], sizes
    assert sizes["port", "plain"] == sizes["reference", "plain"]
    assert sizes["port", "compressed"] == sizes["reference", "compressed"]


class _Vec:
    """tests/test_replica.py's entity: one f32 vector per rank, numpy
    payloads for the reference, CPU tensors for the port."""

    def __init__(self, data: list, torch_payload: bool) -> None:
        self.data = data
        self.torch_payload = torch_payload

    def snapshot_shards(self, k):
        conv = torch.from_numpy if self.torch_payload else (lambda a: a)
        return [{"v": conv(self.data[r].copy()), "origin": conv(np.asarray(r, np.int64))} for r in range(k)]

    def restore_shards(self, shards):
        for origin, payload in shards.items():
            v = payload["v"]
            self.data[origin] = (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).copy()
