"""The port's virtual cluster and fault injection against the JAX package's.

tests/test_runtime_units.py's cluster and injector cases (revoke semantics,
spares then the shrink fallback, regrow, fire-once kills, the MTBF rate)
and tests/test_replica.py's heartbeat cases run on both packages with the
same seeds, and must give the same results. Then the elastic drill: an
engine attached to a cluster, ``kill -> stabilize("elastic") ->
engine.restore_elastic(M) -> cluster.resize(M)`` and a re-protecting
checkpoint, with the stabilization report, the engine's journal and the
restored state compared (the port on ``device="cpu"``). Exact everywhere.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import _torch_jax_oracle as oracle
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.core.distribution import DataLostError
from repro_torch.launch.steps import state_from_numpy, state_to_numpy
from repro_torch.runtime import cluster as t_cluster
from repro_torch.runtime import failures as t_failures
from repro_torch.runtime.state import RngEntity, ShardedStateEntity, ShardPlan
from repro_torch.utils.pytree import tree_flatten


def _packages():
    from repro.runtime import cluster as j_cluster
    from repro.runtime import failures as j_failures

    return {"port": (t_cluster, t_failures), "reference": (j_cluster, j_failures)}


def _both(drive) -> dict:
    """``drive(cluster_module, failures_module)`` on both packages."""
    out = {name: drive(c, f) for name, (c, f) in _packages().items()}
    assert out["port"] == out["reference"]
    return out["port"]


def _report(rep) -> dict:
    return dataclasses.asdict(rep)


# ---------------------------------------------------------------------------
# cluster and injector units
# ---------------------------------------------------------------------------

def test_cluster_revoke_semantics():
    def drive(cm, fm):
        c = cm.VirtualCluster(4)
        c.barrier()
        c.kill(2)
        raised = []
        for _ in range(2):  # every communication fails until stabilized
            try:
                c.barrier()
            except fm.ProcessFaultException as e:
                raised.append((e.ranks, e.phase, str(e)))
        rep = c.stabilize("shrink")
        c.barrier()
        return raised, _report(rep), sorted(c.alive()), c.fault_log

    raised, rep, alive, log = _both(drive)
    assert len(raised) == 2 and raised[0][0] == [2]
    assert rep["policy"] == "shrink" and rep["n_ranks_after"] == 3
    assert rep["load_factor"] == pytest.approx(4 / 3)


def test_cluster_spares_then_shrink_fallback():
    def drive(cm, fm):
        c = cm.VirtualCluster(4, n_spares=1)
        c.kill(0)
        first = _report(c.stabilize("spare"))
        c.kill(1)
        second = _report(c.stabilize("spare"))  # no spares left: shrink
        return first, second, c.spares_left

    first, second, left = _both(drive)
    assert first["policy"] == "spare" and first["spares_used"] == 1
    assert second["policy"] == "shrink" and left == 0


def test_cluster_regrow_and_resize():
    def drive(cm, fm):
        c = cm.VirtualCluster(4)
        c.regrow(6)
        grown = (c.n_ranks, sorted(c.alive()))
        c.kill(5)
        c.resize(3)
        return grown, c.n_ranks, sorted(c.alive()), c.revoked, c.fault_log

    grown, n, alive, revoked, _ = _both(drive)
    assert grown == (6, list(range(6))) and (n, alive, revoked) == (3, [0, 1, 2], False)


def test_injector_fire_once_across_rollbacks():
    def drive(cm, fm):
        inj = fm.FailureInjector(4, schedule={5: [2]}, checkpoint_schedule={1: [3]})
        return [inj.kills_at_step(5), inj.kills_at_step(5), inj.kills_at_checkpoint(1),
                inj.kills_at_checkpoint(1)]

    assert _both(drive) == [[2], [], [3], []]


@pytest.mark.parametrize("burst_size", [1, 3])
def test_injector_mtbf_draws_match_the_reference(burst_size):
    """The same seed kills the same ranks at the same steps; the empirical
    rate tracks 1/mtbf per rank (eq. 1)."""
    def drive(cm, fm):
        inj = fm.FailureInjector(64, mtbf_rank_s=100.0, step_time_s=1.0, seed=3,
                                 burst_size=burst_size, burst_group=8)
        return [inj.kills_at_step(s) for s in range(400)], inj.expected_system_mtbf_s()

    kills, mtbf = _both(drive)
    assert mtbf == pytest.approx(100.0 / 64)
    if burst_size == 1:
        expect = 64 * 400 / 100.0
        assert 0.5 * expect < sum(map(len, kills)) < 1.5 * expect


def test_injector_group_burst_and_silent_kills():
    def drive(cm, fm):
        inj = fm.FailureInjector(8, silent_schedule={2: [6]}, max_detection_ticks=5)
        doomed = inj.schedule_group_burst(3, 1, 4, 2)
        out = [doomed, inj.kills_at_step(1), inj.silent_kills_at_step(2), inj.kills_at_step(3),
               inj.kills_at_step(4), inj.note_detection(6), inj.note_detection(1)]
        return out

    assert _both(drive) == [[4, 5], [], [6], [4, 5], [], 2, None]


def test_heartbeat_monitor_matches_the_reference():
    """tests/test_replica.py's three heartbeat cases and
    tests/test_topology_policy.py's journal tuning, on both packages."""
    class Straggler:
        def slowdown_percentile(self, pct=95.0):
            return 2.0

    def failures(times):
        return [{"kind": "failure", "ts": t, "rank": 0} for t in times]

    def drive(cm, fm):
        out = []
        hb = cm.HeartbeatMonitor(4, miss_threshold=3)
        out += [hb.observe({0, 1, 2, 3}, t) for t in range(1, 4)]
        out += [hb.observe({0, 1, 3}, t) for t in range(4, 8)]
        hb = cm.HeartbeatMonitor(2, miss_threshold=3, straggler=Straggler())
        out += [hb.deadline_ticks()] + [hb.observe({0, 1}, t) for t in (1, 2)]
        out += [hb.observe({0}, t) for t in range(3, 9)]
        hb = cm.HeartbeatMonitor(2, miss_threshold=2)
        out += [hb.observe({0, 1}, 1), hb.observe({0}, 3), hb.observe({0, 1}, 4), hb.observe({0}, 6)]
        hb.reset({0, 1}, 10)
        out += [hb.observe({0, 1}, 11), hb.observe({0}, 12), hb.observe({0}, 13)]
        hb = cm.HeartbeatMonitor(4, miss_threshold=3)
        for times in ([], [100.0], [1000.0, 2000.0, 3000.0], [0.0, 1e6], [10.0, 20.0, 30.0]):
            out.append(hb.tune_from_journal(journal=failures(times)))
        return out

    out = _both(drive)
    assert out[5] == [2] and out[-5:] == [3, 3, 10, 24, 3]


def test_heartbeat_gauge_and_journal(tmp_path):
    from repro_torch.obs.journal import EventJournal
    from repro_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    journal = EventJournal(None, reg)
    hb = t_cluster.HeartbeatMonitor(3, miss_threshold=1, registry=reg, journal=journal)
    assert hb.observe({0, 2}, 1) == [1]
    gauge = reg.get("cluster_rank_up")
    assert [gauge.value(rank=r) for r in range(3)] == [1, 0, 1]
    (ev,) = journal.events("heartbeat_lost")
    assert (ev["rank"], ev["missed"], ev["limit"]) == (1, 1, 1)


def test_a_topology_raises_naming_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="A9"):
        t_cluster.VirtualCluster(4, topology=object())


# ---------------------------------------------------------------------------
# the elastic drill, engine attached
# ---------------------------------------------------------------------------

def _reference_engine(n, state_np, specs):
    import jax
    import jax.tree_util as jtu
    from jax.sharding import PartitionSpec as P

    from repro.core.checkpoint import CheckpointEngine as JEngine
    from repro.core.checkpoint import EngineConfig as JConfig
    from repro.runtime.state import RngEntity as JRng
    from repro.runtime.state import ShardedStateEntity as JEntity
    from repro.runtime.state import ShardPlan as JPlan

    sds = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state_np)
    ps = jtu.tree_map(lambda t: P(*t), specs, is_leaf=lambda x: isinstance(x, tuple))
    box = {"s": jax.tree.map(np.copy, state_np)}
    rng = JRng()
    rng.seed, rng.counter = 7, 3
    eng = JEngine(n, JConfig(restore_mode="sync"))
    eng.register("state", JEntity(lambda: box["s"], lambda s: box.update(s=s), JPlan.from_pspecs(sds, ps)))
    eng.register("rng", rng)

    def zero():
        box["s"] = jax.tree.map(np.zeros_like, box["s"])
        rng.seed = rng.counter = 0

    def read():
        return [np.asarray(x) for x in jax.tree.leaves(box["s"])], [rng.seed, rng.counter]

    return eng, SimpleNamespace(zero=zero, read=read)


def _port_engine(n, state_np, specs):
    state = state_from_numpy(state_np, device="cpu")
    rng = RngEntity()
    rng.seed, rng.counter = 7, 3
    eng = CheckpointEngine(n, EngineConfig(restore_mode="sync"), device="cpu")
    eng.register("state", ShardedStateEntity(lambda: state, ShardPlan.from_pspecs(state, specs)))
    eng.register("rng", rng)

    def zero():
        for leaf in tree_flatten(state)[1]:
            leaf.zero_()
        rng.seed = rng.counter = 0

    def read():
        return tree_flatten(state_to_numpy(state))[1], [rng.seed, rng.counter]

    return eng, SimpleNamespace(zero=zero, read=read)


def _events(eng) -> list[dict]:
    return [{k: v for k, v in ev.items() if k not in ("ts", "duration_s")} for ev in eng.journal.events()]


def _drill(cm, make_engine, n, kills, policy, n_new, n_spares=0):
    """checkpoint -> kill -> stabilize(policy) -> restore_elastic(n_new) or,
    after a spare substitution, restore -> resize -> re-protect."""
    state_np, specs = oracle.elastic_engine_state()
    eng, live = make_engine(n, state_np, specs)
    c = cm.VirtualCluster(n, n_spares=n_spares)
    c.attach_engine(eng)
    assert eng.checkpoint({"step": 7})
    live.zero()
    for r in kills:
        c.kill(r, cause="drill")
    rep = c.stabilize(policy)
    if rep.policy == "spare":
        meta = eng.restore()
    else:
        meta = eng.restore_elastic(n_new)
        c.resize(n_new)
    assert eng.checkpoint({"step": 8})
    leaves, rng = live.read()
    return dict(report=_report(rep), step=int(meta["step"]), events=_events(eng), rng=rng,
                leaves=[(a.dtype.name, a.shape, a.tobytes()) for a in leaves],
                world=(eng.n_ranks, c.n_ranks, sorted(c.alive()), sorted(eng.stores)),
                counts=(eng.stats.zero_comm_restores, eng.stats.adopted_restores))


@pytest.mark.parametrize("n,kills,policy,n_new,n_spares", [
    (4, [2], "elastic", 2, 0),
    (4, [2], "elastic", 8, 0),
    (8, [5], "elastic", 7, 0),
    (8, [1, 6], "elastic", 6, 0),   # two ranks of different copy pairs
    (6, [0], "shrink", 5, 0),
    (4, [3], "spare", 4, 1),
])
def test_elastic_drill_matches_the_reference(n, kills, policy, n_new, n_spares):
    """Stabilization report, journal (failure and resize records), restored
    state, world sizes and restore counters: identical; the restored state
    is the checkpointed one."""
    out = {
        "port": _drill(t_cluster, _port_engine, n, kills, policy, n_new, n_spares),
        "reference": _drill(_packages()["reference"][0], _reference_engine, n, kills, policy, n_new, n_spares),
    }
    assert out["port"] == out["reference"]
    got = out["port"]
    state_np, _ = oracle.elastic_engine_state()
    want = [(a.dtype.name, a.shape, np.asarray(a).tobytes()) for a in tree_flatten(state_np)[1]]
    assert got["leaves"] == want and got["rng"] == [7, 3] and got["step"] == 7
    kinds = [e["kind"] for e in got["events"]]
    assert kinds.count("failure") == len(kills)
    assert kinds.count("resize" if policy != "spare" else "recovery") == 1
    assert got["world"][:2] == (n_new, n_new)


def test_elastic_drill_losing_a_copy_pair_raises():
    state_np, specs = oracle.elastic_engine_state()
    eng, _ = _port_engine(8, state_np, specs)
    c = t_cluster.VirtualCluster(8)
    c.attach_engine(eng)
    assert eng.checkpoint({"step": 1})
    c.kill(2)
    c.kill(6)  # rank 2's pairwise partner
    assert c.stabilize("elastic").n_ranks_after == 6
    with pytest.raises(DataLostError):
        eng.restore_elastic(6)


def test_observed_failure_stats_reads_the_journal():
    state_np, specs = oracle.elastic_engine_state()
    eng, _ = _port_engine(4, state_np, specs)
    c = t_cluster.VirtualCluster(4)
    c.attach_engine(eng)
    c.kill(1)
    stats = t_failures.observed_failure_stats(eng.journal)
    assert stats["failures"] == 1 and stats["mtbf_s"] is None
    assert stats == t_failures.observed_failure_stats(eng.journal.events())
