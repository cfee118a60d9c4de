"""The port's failure-domain topology, domain-aware placement and adaptive
protection policy against the JAX package's (mirrors
tests/test_topology_policy.py case for case; its journal-tuned heartbeat
case is twinned in tests/test_torch_cluster.py).

In one process, on the same inputs: topology queries and resizes; the
domain-aware packer over the hypothesis property and the grid (the
infeasible case's warning and its residual conflicts too); LRC through both
engines (the port's on ``device="cpu"``) under every failure combination up
to tolerance; the whole-rack burst under rs and lrc, and the contiguous
xor layout losing data to it; the elastic 12 -> 8 shrink after a burst; the
cluster's domain labels and ``fit_failure_stats``; every policy decision,
its journaled ``policy`` events, ``report()``, and the launch report's
policy timeline; ``topology_of_mesh``. Then engine-level checks: committed
payloads, stripe holders, manifests and codec records equal under a
topology; a codec override between capture and restore decodes with the
captured codec; ``delta`` re-encodes in full after a flip; the itemized
``memory_report``; ``chip_smoke.py``'s phase 8b sequence at a small size;
the rack-burst drill twin. The journals' clocks are replaced by one
deterministic counter per package, so whole journals compare. Tolerance:
exact everywhere.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import _torch_jax_oracle as oracle
from repro.core import codec as jcodec
from repro.core import distribution as jdist
from repro.core import gf256 as jgf
from repro.core import policy as jpolicy
from repro.core import topology as jtopo
from repro.core.checkpoint import CheckpointEngine as JEngine
from repro.core.checkpoint import EngineConfig as JConfig
from repro.launch import report as jreport
from repro.obs import journal as jjournal
from repro.runtime import cluster as jcluster
from repro.runtime import failures as jfailures
from repro_torch.core import codec as tcodec
from repro_torch.core import distribution as tdist
from repro_torch.core import gf256
from repro_torch.core import policy as tpolicy
from repro_torch.core import topology as ttopo
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.launch import report as treport
from repro_torch.launch.steps import numpy_entity
from repro_torch.obs import journal as tjournal
from repro_torch.runtime import cluster as tcluster
from repro_torch.runtime import failures as tfailures

ROOT = Path(__file__).resolve().parents[1]

# A fixed restore chunk unless a test sets one: the adaptive planner's
# choice between the sync and the pipelined restore reads process-wide
# decode rates, which differ between the packages with what ran before.
PORT = SimpleNamespace(
    name="port", topo=ttopo, dist=tdist, codec=tcodec, policy=tpolicy, cluster=tcluster,
    failures=tfailures, journal=tjournal, report=treport, config=EngineConfig, wrap=numpy_entity,
    as_np=lambda t: t.numpy(), bytes_in=torch.from_numpy,
    zeros=lambda i, n: torch.zeros(n, dtype=torch.uint8),
    engine=lambda n, **kw: CheckpointEngine(n, EngineConfig(**{"restore_chunk_bytes": 1024, **kw}), device="cpu"))
REF = SimpleNamespace(
    name="reference", topo=jtopo, dist=jdist, codec=jcodec, policy=jpolicy, cluster=jcluster,
    failures=jfailures, journal=jjournal, report=jreport, config=JConfig, wrap=lambda e: e,
    as_np=np.asarray, bytes_in=lambda b: b, zeros=lambda i, n: np.zeros(n, np.uint8),
    engine=lambda n, **kw: JEngine(n, JConfig(**{"restore_chunk_bytes": 1024, **kw})))

LRC = dict(codec="lrc", parity_group=4, rs_parity=2, lrc_locals=2)


class _Clock:
    """A journal clock: 1000.0, 1001.0, ... (bursts forced equal by hand)."""

    def __init__(self) -> None:
        self.t = 999.0

    def time(self) -> float:
        self.t += 1.0
        return self.t


@pytest.fixture(autouse=True)
def table_backends_and_clocks(monkeypatch):
    """Both packages' GF(2^8) products through the oracle backend (the
    port's other backends have their own tests, and its torch backend runs
    on the CPU), and both journals on a deterministic clock."""
    gf256.set_backend("table")
    jgf.set_backend("table")
    monkeypatch.setattr(tjournal, "time", _Clock())
    monkeypatch.setattr(jjournal, "time", _Clock())
    with gf256.compute_device("cpu"):
        yield
    gf256.set_backend(None)
    jgf.set_backend(None)


def _both(drive):
    """``drive(pkg)`` on both packages, each journal's clock restarted; the
    results must be equal."""
    out = {}
    for pkg in (PORT, REF):
        pkg.journal.time.t = 999.0
        out[pkg.name] = drive(pkg)
    assert out["port"] == out["reference"]
    return out["port"]


def _groups(groups) -> list:
    return [tuple(g.members) for g in groups]


def _events(eng, kind=None) -> list:
    """The journal without its timing fields."""
    return [{k: v for k, v in e.items() if k != "duration_s"} for e in eng.journal.events(kind)]


def _dump(pkg, eng) -> tuple:
    """Every committed store's bytes (own, exchange sets, held stripes) by
    key, as bytes, and their manifests, checksums and codec records."""
    arrays, meta = oracle.dump_engine(eng, pkg.as_np)
    return {k: (np.asarray(v).dtype.str, np.asarray(v).tobytes()) for k, v in arrays.items()}, json.loads(
        json.dumps(meta))


def _topo_json(t) -> dict:
    return {"labels": [list(x) for x in t.labels], "level": t.placement_level, "shape": t.shape,
            "repr": repr(t),
            "domains": {lv: [[d.level, d.index, list(d.ranks), d.label] for d in t.domains(lv)]
                        for lv in ("host", "rack", "pod")}}


# ---------------------------------------------------------------------------
# topology model
# ---------------------------------------------------------------------------

def test_regular_topology_shape_and_queries():
    assert ttopo.LEVELS == jtopo.LEVELS

    def drive(pkg):
        topo = pkg.topo.ClusterTopology.regular(16, ranks_per_host=2, hosts_per_rack=2, racks_per_pod=2)
        out = _topo_json(topo)
        out["of"] = [[topo.domain_of(r, lv) for lv in pkg.topo.LEVELS] for r in range(16)]
        out["label"] = [topo.domain_label(r) for r in range(16)]
        out["max"] = [topo.max_domain_size(lv) for lv in pkg.topo.LEVELS]
        return out

    out = _both(drive)
    assert out["of"][3][1] == 0 and out["of"][4][1] == 1 and out["of"][8][2] == 1
    assert out["label"][5] == "rack:1" and out["max"] == [2, 4, 8]
    assert out["domains"]["rack"][1] == ["rack", 1, [4, 5, 6, 7], "rack:1"]
    assert "racks=4" in out["repr"]


def test_regular_topology_resize_rederives_layout():
    def drive(pkg):
        topo = pkg.topo.ClusterTopology.regular(8, hosts_per_rack=2)
        assert topo.resized(8) is topo
        return [_topo_json(topo.resized(n)) for n in (2, 5, 12)]

    grown = _both(drive)[2]
    assert [lab[1] for lab in grown["labels"]] == [r // 2 for r in range(12)]


def test_irregular_topology_resize_truncates_and_extends_conservatively():
    def drive(pkg):
        topo = pkg.topo.ClusterTopology.from_labels([(0, 0, 0), (1, 0, 0), (2, 1, 0), (3, 1, 0)])
        return [_topo_json(topo.resized(n)) for n in (2, 4, 6)]

    out = _both(drive)
    assert out[0]["labels"] == [[0, 0, 0], [1, 0, 0]] and out[0]["shape"] is None
    assert out[2]["labels"][4][1] not in (0, 1) and out[2]["labels"][4] != out[2]["labels"][5]


# ---------------------------------------------------------------------------
# domain-aware placement
# ---------------------------------------------------------------------------

def _placement(pkg, n, k, per_host, hosts_per_rack) -> list | None:
    """The domain-aware groups (None for an infeasible shape) and, at a
    resized world, the regrouping, with the property checked on both."""
    topo = pkg.topo.ClusterTopology.regular(n, ranks_per_host=per_host, hosts_per_rack=hosts_per_rack)
    if topo.max_domain_size("rack") > -(-n // k):
        return None
    groups = pkg.dist.domain_parity_groups(n, k, topo)
    assert sorted(r for g in groups for r in g.members) == list(range(n))
    sizes = sorted(len(g.members) for g in groups)
    assert sizes[-1] - sizes[0] <= 1
    assert pkg.dist.placement_conflicts(groups, topo) == []
    out = [_groups(groups)]
    m = max(2, n - 2)
    resized = topo.resized(m)
    if resized.max_domain_size("rack") <= -(-m // k):
        regroups = pkg.dist.domain_parity_groups(m, k, resized)
        assert pkg.dist.placement_conflicts(regroups, resized) == []
        out.append(_groups(regroups))
    return out


@settings(deadline=None, max_examples=40)
@given(
    n=st.integers(min_value=2, max_value=40),
    k=st.integers(min_value=2, max_value=6),
    per_host=st.integers(min_value=1, max_value=3),
    hosts_per_rack=st.integers(min_value=1, max_value=3),
)
def test_domain_placement_property(n, k, per_host, hosts_per_rack):
    """Every feasible (world, group size, rack shape): the same groups as
    the reference, partitioning, balanced, never two members of one rack in
    a group, at the drawn world and after an elastic resize."""
    _both(lambda pkg: _placement(pkg, n, k, per_host, hosts_per_rack))


def test_domain_placement_property_grid():
    def drive(pkg):
        return [_placement(pkg, n, k, 1, h) for n in range(2, 33) for k in (2, 3, 4, 5) for h in (1, 2, 3)]

    assert sum(g is not None for g in _both(drive)) > 300


def test_domain_placement_without_topology_is_balanced_contiguous():
    def drive(pkg):
        d = pkg.dist
        assert d.domain_parity_groups(10, 4) == d.balanced_parity_groups(10, 4)
        gmap = d.rank_group_map(d.balanced_parity_groups(10, 4))
        return _groups(d.balanced_parity_groups(10, 4)), [gmap[r] for r in range(10)]

    groups, gmap = _both(drive)
    assert [len(g) for g in groups] == [4, 3, 3] and gmap[3] == 0 and gmap[4] == 1 and gmap[9] == 2


@pytest.fixture
def fresh_infeasible_warnings():
    """Each package warns once per infeasible shape per process: let this
    test's shape warn, and leave both records as they were."""
    saved = {m: set(m._INFEASIBLE_WARNED) for m in (tdist, jdist)}
    for m in saved:
        m._INFEASIBLE_WARNED.clear()
    yield
    for m, keys in saved.items():
        m._INFEASIBLE_WARNED.clear()
        m._INFEASIBLE_WARNED.update(keys)


def test_domain_placement_infeasible_degrades_with_warning(fresh_infeasible_warnings):
    """One 9-rank rack cannot be separated over 3 groups: the same
    best-effort groups, one warning, and the same residual conflicts."""
    def drive(pkg):
        topo = pkg.topo.ClusterTopology.regular(9, hosts_per_rack=9)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            groups = pkg.dist.domain_parity_groups(9, 4, topo)
            pkg.dist.domain_parity_groups(9, 4, topo)  # once per shape
        msgs = [str(x.message) for x in w]
        assert len(msgs) == 1 and "best-effort" in msgs[0]
        return _groups(groups), pkg.dist.placement_conflicts(groups, topo), msgs

    groups, conflicts, _ = _both(drive)
    assert sorted(r for g in groups for r in g) == list(range(9))
    assert conflicts and all(len(rs) < 9 for _, _, rs in conflicts)


# ---------------------------------------------------------------------------
# LRC through both engines
# ---------------------------------------------------------------------------

def _roundtrip(pkg, n, cfg, kills, dim=64):
    """Checkpoint a ShardedVec and a replicated counter, overwrite, wipe
    ``kills``, restore: (the committed stores, the outcome, the counters)."""
    eng = pkg.engine(n, **cfg)
    vec = oracle.ShardedVec(n, dim)
    eng.register("state", pkg.wrap(vec))
    eng.register("counter", pkg.wrap(oracle.Counter()))
    assert eng.checkpoint({"step": 1})
    orig = [d.copy() for d in vec.data]
    dump = _dump(pkg, eng)
    for d in vec.data:
        d += 999.0
    for r in kills:
        eng.stores[r].wipe()
    try:
        eng.restore()
        outcome = all(np.array_equal(vec.data[r], orig[r]) for r in range(n))
    except Exception as e:  # noqa: BLE001 - the class name is the result
        outcome = type(e).__name__
    stats = [eng.stats.reconstructed_restores, eng.stats.zero_comm_restores, eng.stats.tier_escalations]
    return eng, (dump, outcome, stats, _groups(eng._groups()), _events(eng))


@pytest.mark.parametrize("grp", [0, 1])
def test_lrc_every_failure_combo_up_to_tolerance(grp):
    members = range(4 * grp, 4 * grp + 4)
    for e in (1, 2):
        for kills in itertools.combinations(members, e):
            assert _both(lambda pkg: _roundtrip(pkg, 8, LRC, kills)[1])[1] is True, kills


def test_lrc_ragged_last_group_and_cross_group():
    for kills in [(9,), (8, 9), (3, 8), (0, 5)]:
        assert _both(lambda pkg: _roundtrip(pkg, 10, LRC, kills)[1])[1] is True, kills


def test_lrc_beyond_tolerance_raises():
    assert _both(lambda pkg: _roundtrip(pkg, 8, LRC, (0, 1, 2))[1])[1] == "DataLostError"


def test_lrc_generator_structure():
    C = _both(lambda pkg: pkg.codec.lrc_generator(6, 2, 2).tolist())
    assert C[0] == [1, 1, 1, 0, 0, 0] and C[1] == [0, 0, 0, 1, 1, 1]
    assert all(c != 0 for row in C[2:] for c in row)


def test_make_codec_lrc_from_config():
    def drive(pkg):
        codec = pkg.codec.make_codec(pkg.config(codec="lrc", parity_group=6, rs_parity=2, lrc_locals=3))
        assert isinstance(codec, pkg.codec.LRCCodec)
        with pytest.raises(ValueError):
            pkg.codec.make_codec(pkg.config(codec="lrc"))
        return [codec.name, codec.local, codec.global_parity, codec.tolerance(), codec.n_blobs(6)]

    assert _both(drive) == ["lrc", 3, 2, 2, 5]


def test_lrc_single_failure_repair_reads_fewer_bytes_than_rs():
    """At equal tolerance over k=6 a single repair reads the local subgroup
    under LRC and k sources under RS: the same reads, bytes and rebuilt
    bytes as the reference, and the acceptance inequality."""
    k, m, l = 6, 2, 2
    r = np.random.default_rng(7)
    bufs = [r.integers(0, 256, size=512, dtype=np.uint8) for _ in range(k)]

    def drive(pkg):
        out = {}
        for name, codec in (("lrc", pkg.codec.LRCCodec(k, l, m)), ("rs", pkg.codec.RSCodec(k, m))):
            src = [pkg.bytes_in(b) for b in bufs]
            blobs = dict(enumerate(codec.encode(src, codec.n_blobs(k))))
            present = {i: src[i] for i in range(k) if i != 2}
            rebuilt, chunk = codec.decode_into(present, blobs, [2], pkg.zeros)
            chunk(0, max(b.nbytes for b in blobs.values()))
            got = pkg.as_np(rebuilt[2])[: bufs[2].nbytes]
            assert got.tobytes() == bufs[2].tobytes()
            out[name] = [codec.last_decode_reads, codec.last_decode_read_bytes]
        return out

    out = _both(drive)
    (lrc_reads, lrc_bytes), (rs_reads, rs_bytes) = out["lrc"], out["rs"]
    k_local = -(-k // l)
    assert lrc_reads == k_local and rs_reads == k
    assert lrc_bytes < rs_bytes and lrc_bytes * (k + m) <= rs_bytes * (k_local + 1)


# ---------------------------------------------------------------------------
# the whole-rack burst under domain-aware placement
# ---------------------------------------------------------------------------

def _rack_topology(pkg, n=12):
    # racks of 2: with k=4 there are 3 groups >= the largest rack
    return pkg.topo.ClusterTopology.regular(n, hosts_per_rack=2)


@pytest.mark.parametrize("codec", ["rs", "lrc"])
@pytest.mark.parametrize("mode", ["sync", "pipelined"])
def test_rack_burst_recovers_via_codec_tier_with_domain_placement(codec, mode):
    """A whole rack lost costs every group at most one shard under
    domain-aware placement: both engines commit the same payloads, stripe
    holders, manifests and codec records, and restore bit-identically with
    no escalation; the recovery record names the rack."""
    cfg = dict(LRC, codec=codec, restore_mode=mode, restore_chunk_bytes=256 if mode == "pipelined" else 0)

    def drive(pkg):
        topo = _rack_topology(pkg)
        rack1 = topo.domains("rack")[1].ranks
        eng, out = _roundtrip(pkg, 12, dict(cfg, topology=topo), rack1)
        groups = eng._groups()
        assert pkg.dist.placement_conflicts(groups, topo) == []
        assert all(sum(r in g.members for r in rack1) <= 1 for g in groups)
        assert [eng._group_of(r) for r in range(12)] == [gi for r in range(12) for gi, g in enumerate(groups)
                                                         if r in g.members]
        return out

    dump, outcome, stats, groups, events = _both(drive)
    assert outcome is True and stats[0] >= 2 and stats[2] == 0
    assert groups == [(0, 3, 6, 9), (1, 4, 7, 10), (2, 5, 8, 11)]
    assert [e["domains"] for e in events if e["kind"] == "recovery"] == ["rack:1"]
    assert {v["codecs"]["state"] for v in dump[1]["stores"].values()} == {f"{codec}:2:{2 if codec == 'lrc' else 0}"}


def test_contiguous_xor_layout_loses_the_rack_burst():
    """The same burst without a topology: both victims in one contiguous
    group, beyond xor's one parity."""
    assert _both(lambda pkg: _roundtrip(pkg, 12, dict(parity_group=4), (2, 3))[1][1]) == "DataLostError"


def test_elastic_shrink_after_rack_burst():
    """12 -> 8 through a whole-rack loss: the domain-aware LRC checkpoint
    repairs the burst and repartitions; the topology resizes with the
    engine and the new world re-protects domain-aware, the same bytes as
    the reference."""
    def drive(pkg):
        topo = _rack_topology(pkg)
        eng = pkg.engine(12, **LRC, topology=topo)
        vec = oracle.ShardedVec(12)
        eng.register("state", pkg.wrap(vec))
        assert eng.checkpoint({"step": 3})
        orig = [d.copy() for d in vec.data]
        for r in topo.domains("rack")[0].ranks:
            eng.stores[r].wipe()
        for d in vec.data:
            d += 999.0
        assert eng.restore_elastic(8)["step"] == 3
        assert all(np.array_equal(vec.data[r], orig[r]) for r in range(12))
        assert eng.n_ranks == 8 and eng.topology.n_ranks == 8
        assert eng.checkpoint({"step": 4})
        assert pkg.dist.placement_conflicts(eng._groups(), eng.topology) == []
        return _groups(eng._groups()), _dump(pkg, eng), _events(eng)

    groups, _, events = _both(drive)
    assert groups == [(0, 2, 4, 6), (1, 3, 5, 7)]
    assert [e["kind"] for e in events] == ["resize"]


def test_cluster_kill_journals_domain_labels():
    """VirtualCluster.kill stamps each failure with the victim's domain; a
    simultaneous whole-rack kill fits as ONE single-domain burst."""
    def drive(pkg):
        topo = _rack_topology(pkg)
        eng = pkg.engine(8, codec="rs", parity_group=4, rs_parity=2, topology=topo)
        eng.register("state", pkg.wrap(oracle.ShardedVec(8)))
        cluster = pkg.cluster.VirtualCluster(8, topology=topo)
        cluster.attach_engine(eng)
        assert eng.checkpoint({"step": 1})
        for r in (2, 3):  # rack:1
            cluster.kill(r)
        evs = eng.journal.events("failure")
        evs[1]["ts"] = evs[0]["ts"]  # one arrival instant
        return _events(eng, "failure"), pkg.journal.fit_failure_stats(eng.journal.events())

    evs, stats = _both(drive)
    assert [e["domain"] for e in evs] == ["rack:1", "rack:1"]
    assert stats["failures"] == 2 and stats["by_domain"] == {"rack:1": 2}
    assert stats["domain_bursts"] == 1 and stats["max_domain_burst"] == 2


def test_cluster_and_engine_share_one_topology():
    """Whichever of the two is given the topology, attaching shares it (the
    engine's sized to its world, its layout re-packed); ``domain_ranks``
    lists a domain's members."""
    def drive(pkg):
        topo = _rack_topology(pkg, 8)
        eng = pkg.engine(8, **LRC)
        before = _groups(eng._groups())
        cluster = pkg.cluster.VirtualCluster(8, topology=topo)
        cluster.attach_engine(eng)
        after = _groups(eng._groups())
        eng2 = pkg.engine(8, **LRC, topology=topo)
        cluster2 = pkg.cluster.VirtualCluster(8)
        cluster2.attach_engine(eng2)
        assert cluster2.topology is eng2.topology
        return before, after, cluster.domain_ranks(1), cluster2.domain_ranks(3), pkg.cluster.VirtualCluster(
            8).domain_ranks(0)

    before, after, rack1, rack3, none = _both(drive)
    assert before == [(0, 1, 2, 3), (4, 5, 6, 7)] and after == [(0, 2, 4, 6), (1, 3, 5, 7)]
    assert rack1 == [2, 3] and rack3 == [6, 7] and none == []


# ---------------------------------------------------------------------------
# the adaptive protection policy
# ---------------------------------------------------------------------------

def _policy_engine(pkg, codec="rs", k=4, m=2, topo=False):
    eng = pkg.engine(8, codec=codec, parity_group=k, rs_parity=m, lrc_locals=2,
                     topology=_rack_topology(pkg) if topo else None)
    eng.register("state", pkg.wrap(oracle.ShardedVec(8)))
    return eng


def _inject_failures(eng, bursts):
    """Synthetic failure events: one arrival instant per burst, bursts a
    minute apart."""
    t = 1000.0
    for doms in bursts:
        for d in doms:
            eng.journal._events.append({"kind": "failure", "ts": t, "rank": 0, "domain": d})
        t += 60.0


def _decisions(ds) -> list:
    return [dataclasses.asdict(d) for d in ds]


def _policy_state(pol, eng) -> dict:
    return {"decisions": {n: dataclasses.asdict(d) for n, d in sorted(pol.decisions.items())},
            "report": json.loads(json.dumps(pol.report())), "events": _events(eng, "policy"),
            "codecs": {n: eng._codec_spec(eng._codec_for(n)) for n in sorted(eng._entities)},
            "evaluations": pol.evaluations, "changes": pol.changes}


def test_policy_quiet_keeps_configured_codec():
    def drive(pkg):
        eng = _policy_engine(pkg)
        pol = pkg.policy.ProtectionPolicy(eng)
        decisions = pol.evaluate()
        assert pol.apply(decisions) == 0
        return _decisions(decisions), _policy_state(pol, eng)

    (d,), _ = _both(drive)
    assert d["codec"] == "rs" and not d["changed"] and "quiet" in d["reason"]


def test_policy_single_failures_pick_lrc():
    def drive(pkg):
        eng = _policy_engine(pkg)
        _inject_failures(eng, [["rack:0"], ["rack:3"], ["rack:1"]])
        pol = pkg.policy.ProtectionPolicy(eng)
        assert pol.apply() == 1
        first = _policy_state(pol, eng)
        assert pol.apply() == 0  # protection already matches
        # the override round-trips: checkpoint under LRC, a loss, restore
        vec = eng._entities["state"]
        vec = getattr(vec, "entity", vec)
        assert eng.checkpoint({"step": 2})
        orig = [x.copy() for x in vec.data]
        eng.stores[1].wipe()
        eng.restore()
        assert all(np.array_equal(a, b) for a, b in zip(vec.data, orig))
        return first, _policy_state(pol, eng), _dump(pkg, eng)

    first, _, dump = _both(drive)
    assert first["decisions"]["state"]["codec"] == "lrc" and "local repair pays" in first["decisions"]["state"]["reason"]
    assert first["codecs"]["state"] == "lrc:1:2" and first["events"][-1]["codec"] == "lrc"
    assert {v["codecs"]["state"] for v in dump[1]["stores"].values()} == {"lrc:1:2"}


def test_policy_domain_spanning_burst_raises_parity():
    def drive(pkg):
        eng = _policy_engine(pkg, m=1)
        _inject_failures(eng, [["rack:0", "rack:1", "rack:2"], ["rack:3"]])
        pol = pkg.policy.ProtectionPolicy(eng)
        assert pol.apply() == 1
        return _policy_state(pol, eng)

    d = _both(drive)["decisions"]["state"]
    assert d["codec"] == "rs" and d["m"] == 3 and "domain-spanning" in d["reason"]


def test_policy_domain_contained_burst_stays_cheap_with_topology():
    """A 2-wide single-rack burst costs 1 with a topology (LRC); without
    one the discount is off and m rises to 2."""
    def drive(pkg):
        out = []
        for topo, m in ((True, 2), (False, 1)):
            eng = _policy_engine(pkg, m=m, topo=topo)
            _inject_failures(eng, [["rack:1", "rack:1"], ["rack:0"]])
            pol = pkg.policy.ProtectionPolicy(eng)
            pol.apply()
            out.append(_policy_state(pol, eng))
        return out

    with_topo, without = _both(drive)
    assert with_topo["decisions"]["state"]["codec"] == "lrc"
    assert without["decisions"]["state"]["codec"] == "rs" and without["decisions"]["state"]["m"] == 2


def test_policy_small_groups_never_pick_lrc():
    def drive(pkg):
        eng = _policy_engine(pkg, codec="xor", k=2, m=1)
        _inject_failures(eng, [["rack:0"], ["rack:1"]])
        pol = pkg.policy.ProtectionPolicy(eng)
        pol.apply()
        return _policy_state(pol, eng)

    assert _both(drive)["decisions"]["state"]["codec"] == "xor"


def test_policy_attach_reevaluates_at_commit_and_reports():
    def drive(pkg):
        eng = _policy_engine(pkg)
        pol = pkg.policy.ProtectionPolicy(eng).attach()
        assert eng.checkpoint({"step": 1}) and pol.evaluations == 1
        _inject_failures(eng, [["rack:0"], ["rack:2"]])
        assert eng.checkpoint({"step": 2})
        rows = pkg.report.policy_timeline(eng.journal.events())
        lines = pkg.report.render_policy(rows)
        # the timeline's t0 column is relative time: compare the rest
        return _policy_state(pol, eng), [(r["target"], r["detail"]) for r in rows], lines[:4] + [
            ln[10:] for ln in lines[4:]]

    state, rows, lines = _both(drive)
    assert state["evaluations"] == 2 and state["changes"] == 1
    assert state["report"]["decisions"]["state"]["codec"] == "lrc" and state["report"]["stats"]["failures"] == 2
    assert rows and rows[-1][0] == "codec" and "-> lrc" in rows[-1][1]
    assert any("adaptive protection" in ln for ln in lines)


def test_report_cli_renders_the_trace_and_the_policy_journal(tmp_path):
    """``python -m repro_torch.launch.report`` on a trace and a journal the
    port wrote: the same text and JSON as the reference's renderer."""
    from repro_torch.obs.trace import tracer

    journal = tmp_path / "journal.jsonl"
    eng = _policy_engine(PORT)
    eng.journal.path = str(journal)
    pol = tpolicy.ProtectionPolicy(eng).attach()
    tr = tracer()
    tr.reset()
    tr.enable()
    try:
        assert eng.checkpoint({"step": 1})
        _inject_failures(eng, [["rack:0"], ["rack:2"]])
        assert eng.checkpoint({"step": 2})
        eng.stores[1].wipe()
        eng.restore()
    finally:
        tr.disable()
    trace = tmp_path / "trace.json"
    tr.write(str(trace))
    tr.reset()
    assert pol.changes == 1
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for extra in ([], ["--json"]):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.report", str(trace), "--journal",
                               str(journal), *extra], capture_output=True, text=True, env=env, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        if extra:
            got = json.loads(proc.stdout)
            assert len(got["generations"]) == 2 and got["policy"][-1]["target"] == "codec"
        else:
            assert proc.stdout == jreport.render(str(trace), journal=str(journal))
            assert "adaptive protection" in proc.stdout


# ---------------------------------------------------------------------------
# correlated fault injection, mesh topology
# ---------------------------------------------------------------------------

def test_failure_injector_schedule_domain_burst():
    def drive(pkg):
        topo = _rack_topology(pkg)
        inj = pkg.failures.FailureInjector(8)
        doomed = inj.schedule_domain_burst(5, topo, 1)
        out = [doomed, dict(inj.schedule), sorted(inj.kills_at_step(5)), inj.kills_at_step(5)]
        inj2 = pkg.failures.FailureInjector(8)
        inj2.schedule_domain_burst(7, topo, 0, kind="checkpoint")
        return out + [dict(inj2.checkpoint_schedule)]

    assert _both(drive) == [[2, 3], {5: [2, 3]}, [2, 3], [], {7: [0, 1]}]


def test_topology_of_mesh_reads_device_ordering():
    """A mesh with device objects gives their ids' labels, as the
    reference's; the port's VirtualMesh numbers its devices row-major and
    gives the same labels."""
    from repro.sharding.mesh import topology_of_mesh as jtom
    from repro_torch.sharding.mesh import make_mesh
    from repro_torch.sharding.mesh import topology_of_mesh as ttom

    devs = np.array([SimpleNamespace(id=i) for i in range(32)], dtype=object).reshape(4, 8)
    mesh = SimpleNamespace(devices=devs, shape={"data": 4, "model": 8})
    kw = dict(n_ranks=4, host_chips=8, hosts_per_rack=2)
    want = jtom(mesh, **kw)
    for got in (ttom(mesh, **kw), ttom(make_mesh((4, 8), ("data", "model"), device="cpu"), **kw)):
        assert _topo_json(got) == _topo_json(want)
    assert [lab[0] for lab in want.labels] == [0, 1, 2, 3] and [lab[1] for lab in want.labels] == [0, 0, 1, 1]
    assert tdist.placement_conflicts(tdist.domain_parity_groups(4, 2, want), want) == []
    # ranks from the data axes when not given, a pod axis leading
    vm = make_mesh((2, 4, 2), ("pod", "data", "model"), device="cpu")
    pods = SimpleNamespace(devices=np.array([SimpleNamespace(id=i) for i in range(16)], dtype=object).reshape(2, 4, 2),
                           shape={"pod": 2, "data": 4, "model": 2})
    assert _topo_json(ttom(vm, host_chips=4)) == _topo_json(jtom(pods, host_chips=4))
    assert ttom(vm).n_ranks == 8


# ---------------------------------------------------------------------------
# engine level: per-entity codecs, delta after a flip, memory accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["rs", "lrc"])
def test_topology_payloads_stripes_and_codec_records_match(codec):
    """16 ranks on 8 racks (4 groups of 4): the committed stores, the
    stripe holders and the codec records equal the reference's, and a
    burst of a rack restores the same bytes; with no topology the layout
    is the contiguous one."""
    cfg = dict(LRC, codec=codec)

    def drive(pkg):
        topo = pkg.topo.ClusterTopology.regular(16, hosts_per_rack=2)
        eng, out = _roundtrip(pkg, 16, dict(cfg, topology=topo), (2, 3), dim=96)
        holders = {gi: [list(h) for h in eng._codec_for("state").placement(eng._groups(), gi, 16)]
                   for gi in range(4)}
        plain = pkg.engine(16, **cfg)
        return out, holders, _groups(plain._groups())

    (dump, outcome, _, groups, _), holders, plain = _both(drive)
    assert outcome is True
    assert groups == [(0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15)]
    assert plain == [(0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10, 11), (12, 13, 14, 15)]
    assert holders[0][0] == [1, 5, 9, 13]


@pytest.mark.parametrize("flip", ["lower", "clear"])
def test_restore_decodes_with_the_captured_codec(flip):
    """An override set (or cleared) between capture and restore changes
    nothing about the decode: "lower" captures lrc m=2, then lowers to m=1
    and loses two members of one group (only m=2 covers it); "clear"
    captures under an m=1 override, clears it, and the same loss is beyond
    the captured codec: DataLostError in both packages."""
    def drive(pkg):
        eng = pkg.engine(8, **LRC)
        vec = oracle.ShardedVec(8)
        eng.register("state", pkg.wrap(vec))
        if flip == "clear":
            eng.set_entity_codec("state", "lrc", m=1)
        assert eng.checkpoint({"step": 1})
        if flip == "lower":
            eng.set_entity_codec("state", "lrc", m=1)
        else:
            eng.clear_entity_codec("state")
        specs = [eng._codec_spec(eng._codec_for("state")), eng._codec_spec(eng._restore_codec("state"))]
        orig = [d.copy() for d in vec.data]
        for d in vec.data:
            d += 1.0
        for r in (0, 1):
            eng.stores[r].wipe()
        try:
            eng.restore()
            outcome = all(np.array_equal(a, b) for a, b in zip(vec.data, orig))
        except Exception as e:  # noqa: BLE001 - the class name is the result
            outcome = type(e).__name__
        return specs, outcome, _events(eng)

    specs, outcome, _ = _both(drive)
    if flip == "lower":
        assert specs == ["lrc:1:2", "lrc:2:2"] and outcome is True
    else:
        assert specs == ["lrc:2:2", "lrc:1:2"] and outcome == "DataLostError"


def test_set_entity_codec_keeps_the_group_size():
    for pkg in (PORT, REF):
        eng = pkg.engine(8, **LRC)
        eng.set_entity_codec("state", "rs", m=3)
        assert eng._codec_spec(eng._codec_for("state")) == "rs:3:0"
        with pytest.raises(AssertionError, match="group size"):
            eng.set_entity_codec("state", "copy")


def test_delta_reencodes_in_full_after_a_policy_flip():
    """Under ``delta`` the second create patches the parity in place; a flip
    to lrc m=1 makes the third re-encode every unit in full (the baseline
    key holds the codec spec), and its parity equals a fresh engine's full
    encode of the same bytes; the stats and stores equal the reference's."""
    cfg = dict(LRC, delta=True, delta_chunk_bytes=4096)

    def drive(pkg):
        eng = pkg.engine(8, **cfg)
        vec = oracle.ShardedVec(8, 4096)
        eng.register("state", pkg.wrap(vec))
        tallies = []
        for gen in range(3):
            if gen == 2:
                eng.set_entity_codec("state", "lrc", m=1)
            vec.data[gen][:16] += 1.0  # one dirty chunk
            assert eng.checkpoint({"step": gen})
            tallies.append([eng.stats.delta_encodes, eng.stats.full_encodes])
        fresh = pkg.engine(8, **LRC)
        fresh.register("state", pkg.wrap(vec))
        fresh.set_entity_codec("state", "lrc", m=1)
        assert fresh.checkpoint({"step": 2})
        got, want = _dump(pkg, eng)[0], _dump(pkg, fresh)[0]
        assert {k: v for k, v in got.items() if "/parity/" in k} == {k: v for k, v in want.items() if "/parity/" in k}
        return tallies, _dump(pkg, eng)

    tallies, dump = _both(drive)
    assert tallies == [[0, 2], [2, 2], [2, 4]]
    assert {v["codecs"]["state"] for v in dump[1]["stores"].values()} == {"lrc:1:2"}


def test_memory_eq2_pairwise():
    """Pairwise stores own + partner, double-buffered after two checkpoints:
    about 4 payloads per rank; the report equals the reference's."""
    def drive(pkg):
        eng = pkg.engine(4, validate=False)
        eng.register("state", pkg.wrap(oracle.ShardedVec(4, 1000)))
        eng.checkpoint({"step": 1})
        eng.checkpoint({"step": 2})
        return json.loads(json.dumps(eng.memory_report()))

    rep = _both(drive)
    assert all(4 * 4000 <= b < 4 * 4000 * 1.2 for b in rep["bytes_per_rank"].values())
    assert rep["topology"] is None and rep["entity_codecs"] == {}


def test_memory_report_itemizes_redundancy():
    """Per codec the redundancy bytes match the promised overhead, copies >
    rs > xor; with a topology and an override the report names both. Every
    report equals the reference's."""
    n, dim = 8, 4096
    cases = {"copy": dict(validate=False), "xor": dict(parity_group=4, validate=False),
             "rs": dict(codec="rs", parity_group=4, rs_parity=2, validate=False),
             "lrc-topo": dict(LRC, validate=False)}

    def drive(pkg):
        reports = {}
        for name, cfg in cases.items():
            topo = _rack_topology(pkg, n) if name == "lrc-topo" else None
            eng = pkg.engine(n, **cfg, topology=topo)
            eng.register("state", pkg.wrap(oracle.ShardedVec(n, dim)))
            if topo is not None:
                eng.set_entity_codec("state", "lrc", m=1)
            eng.checkpoint({})
            reports[name] = json.loads(json.dumps(eng.memory_report()))
        return reports

    reports = _both(drive)
    shard = dim * 4 + 8
    for name in ("copy", "xor", "rs"):
        rep = reports[name]
        got, want = rep["redundancy_bytes"][name], n * shard * rep["redundancy_overhead"]
        assert rep["codec"] == name and abs(got - want) / want < 0.05, (name, got, want)
    assert reports["copy"]["redundancy_bytes"]["copy"] > reports["rs"]["redundancy_bytes"]["rs"] > \
        reports["xor"]["redundancy_bytes"]["xor"]
    assert reports["rs"]["tolerance"] == 2 and reports["xor"]["tolerance"] == 1
    lrc = reports["lrc-topo"]
    assert lrc["topology"].startswith("ClusterTopology('regular', n=8") and lrc["entity_codecs"] == {"state": "lrc:1:2"}


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 8b sequence, and the drill twin
# ---------------------------------------------------------------------------

def test_phase_8b_sequence_matches_the_reference():
    """16 ranks on 8 racks, LRC k=4 m=2 l=2, a cluster with spares and the
    policy attached: create, the rack-1 burst, restore (before the spare
    substitution: it still sees the failed ranks), stabilize, apply,
    create under the override, a single loss, restore from the payload's
    lrc:1:2 record, stabilize. Journal records, decisions, codec records,
    stores and restored bytes equal."""
    def drive(pkg):
        topo = pkg.topo.ClusterTopology.regular(16, hosts_per_rack=2)
        eng = pkg.engine(16, **LRC, topology=topo)
        vec, counter = oracle.ShardedVec(16, 256), oracle.Counter()
        counter.step = 5
        eng.register("state", pkg.wrap(vec))
        eng.register("counter", pkg.wrap(counter))
        cluster = pkg.cluster.VirtualCluster(16, n_spares=3, topology=topo)
        cluster.attach_engine(eng)
        pol = pkg.policy.ProtectionPolicy(eng).attach()
        out = {"groups": _groups(eng._groups()),
               "conflicts": pkg.dist.placement_conflicts(eng._groups(), topo)}
        assert eng.checkpoint({"step": 1})
        orig = [d.copy() for d in vec.data]
        inj = pkg.failures.FailureInjector(16)
        out["doomed"] = inj.schedule_domain_burst(1, topo, 1)
        for r in inj.kills_at_step(1):
            cluster.kill(r, cause="rack burst")
        evs = eng.journal.events("failure")
        evs[1]["ts"] = evs[0]["ts"]
        for d in vec.data:
            d += 999.0
        counter.step = 0
        eng.restore()
        out["restored1"] = all(np.array_equal(a, b) for a, b in zip(vec.data, orig)) and counter.step == 5
        out["stab1"] = dataclasses.asdict(cluster.stabilize("spare"))
        out["applied"] = pol.apply()
        assert eng.checkpoint({"step": 2})
        out["policy"] = _policy_state(pol, eng)
        out["gen2"] = _dump(pkg, eng)
        cluster.kill(5, cause="host")
        for d in vec.data:
            d -= 1.0
        eng.restore()
        out["restored2"] = all(np.array_equal(a, b) for a, b in zip(vec.data, orig))
        out["stab2"] = dataclasses.asdict(cluster.stabilize("spare"))
        out["stats"] = [eng.stats.reconstructed_restores, eng.stats.tier_escalations, eng.stats.created]
        out["journal"] = _events(eng)
        out["fit"] = pkg.journal.fit_failure_stats(eng.journal.events())
        return json.loads(json.dumps(out, default=str))

    out = _both(drive)
    assert out["groups"] == [[0, 4, 8, 12], [1, 5, 9, 13], [2, 6, 10, 14], [3, 7, 11, 15]]
    assert out["conflicts"] == [] and out["doomed"] == [2, 3]
    assert out["restored1"] and out["restored2"] and out["stats"][1] == 0
    assert [e["domains"] for e in out["journal"] if e["kind"] == "recovery"] == ["rack:1", "rack:2"]
    assert out["applied"] == 2 and out["policy"]["evaluations"] == 3 and out["policy"]["changes"] == 2
    assert out["policy"]["codecs"] == {"counter": "lrc:1:2", "state": "lrc:1:2"}
    assert {v["codecs"]["state"] for v in out["gen2"][1]["stores"].values()} == {"lrc:1:2"}
    assert out["fit"]["domain_bursts"] == 1 and out["fit"]["by_domain"] == {"rack:1": 2, "rack:2": 1}
    assert out["stab1"]["policy"] == out["stab2"]["policy"] == "spare"


def test_rack_burst_drill_twin_passes_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "rack_burst_drill_torch.py"), "--device", "cpu"],
                          capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "rack-burst drill PASSED" in proc.stdout
    assert "domains='rack:1'" in proc.stdout
