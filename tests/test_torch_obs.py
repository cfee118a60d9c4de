"""The port's observability (``repro_torch.obs``, the engine's registry view,
``launch/report.py``, ``utils/logging.py``) against the JAX package's, case
for case with ``tests/test_obs.py`` (all 18, the three ``kill_chunk`` cases
of the mid-pipeline kill included).

Each case runs the reference's scenario on the port and asserts what the
reference asserts, then runs it on the reference too, in the same process,
and holds the two equal wherever both are deterministic: registry values,
snapshots and Prometheus text; counters and histogram counts; span names,
phases and labels (the engine label read as "this engine"); journal records,
each package's clock replaced by a counter (as in
``tests/test_torch_topology_policy.py``) and ``duration_s`` dropped (and a
flush's byte count, which counts headers that pickle each package's own
classes); the
report's rows; the failover timeline; the fitted failure statistics; the
log records' fields. Times and the restore planner's sync/pipelined choice
(it reads process-wide decode rates) are not compared, nor the one engine
metric the port adds (``ckpt_last_delta_ranges``). Tolerance: exact.
"""

from __future__ import annotations

import json
import logging
import math
import re
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import checkpoint as jckpt
from repro.core import gf256 as jgf
from repro.core import storage as jstorage
from repro.launch import report as jreport
from repro.obs import journal as jjournal
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.runtime import cluster as jcluster
from repro.runtime import failures as jfailures
from repro.runtime import server as jserver
from repro.utils import logging as jlog
from repro.utils import timing as jtiming
from repro_torch.core import checkpoint as tckpt
from repro_torch.core import gf256
from repro_torch.core import storage as tstorage
from repro_torch.launch import report as treport
from repro_torch.launch.steps import numpy_entity
from repro_torch.obs import journal as tjournal
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.runtime import cluster as tcluster
from repro_torch.runtime import failures as tfailures
from repro_torch.runtime import server as tserver
from repro_torch.utils import logging as tlog
from repro_torch.utils import timing as ttiming

PORT = SimpleNamespace(
    name="port", ckpt=tckpt, storage=tstorage, report=treport, journal=tjournal, metrics=tmetrics,
    trace=ttrace, cluster=tcluster, failures=tfailures, server=tserver, log=tlog, timing=ttiming,
    log_env="REPRO_TORCH_LOG_JSON", log_root="repro_torch", wrap=numpy_entity,
    engine=lambda n, hook=None, **kw: tckpt.CheckpointEngine(n, tckpt.EngineConfig(**kw), fault_hook=hook,
                                                             device="cpu"))
REF = SimpleNamespace(
    name="reference", ckpt=jckpt, storage=jstorage, report=jreport, journal=jjournal, metrics=jmetrics,
    trace=jtrace, cluster=jcluster, failures=jfailures, server=jserver, log=jlog, timing=jtiming,
    log_env="REPRO_LOG_JSON", log_root="repro", wrap=lambda e: e,
    engine=lambda n, hook=None, **kw: jckpt.CheckpointEngine(n, jckpt.EngineConfig(**kw), fault_hook=hook))
BOTH = (PORT, REF)
# the one engine metric the port adds (a gauge of the last delta patch's ranges)
PORT_ONLY_METRICS = {"ckpt_last_delta_ranges"}


class ShardedVec:
    def __init__(self, n, dim=256):
        self.n = n
        self.data = [
            np.random.default_rng(r).standard_normal(dim).astype(np.float32)
            for r in range(n)
        ]

    def snapshot_shards(self, n):
        return [{"v": self.data[r].copy()} for r in range(n)]

    def restore_shards(self, shards):
        for origin, payload in shards.items():
            self.data[origin] = np.asarray(payload["v"]).copy()


class _Clock:
    """A journal clock: 1000.0, 1001.0, ..."""

    def __init__(self) -> None:
        self.t = 999.0

    def time(self) -> float:
        self.t += 1.0
        return self.t


@pytest.fixture(autouse=True)
def table_backends_and_clocks(monkeypatch):
    """Both packages' GF(2^8) products through the table backend (the port's
    on the CPU) and both journals on a counter clock."""
    gf256.set_backend("table")
    jgf.set_backend("table")
    monkeypatch.setattr(tjournal, "time", _Clock())
    monkeypatch.setattr(jjournal, "time", _Clock())
    with gf256.compute_device("cpu"):
        yield
    gf256.set_backend(None)
    jgf.set_backend(None)


@pytest.fixture
def tr():
    """Both packages' process-global tracers, enabled and clean; disabled
    again after."""
    ts = {pkg.name: pkg.trace.tracer() for pkg in BOTH}
    for t in ts.values():
        t.reset()
        t.enable()
    yield ts
    for t in ts.values():
        t.disable()
        t.reset()


def _both(drive):
    """``drive(pkg)`` on both packages (each journal's clock restarted):
    their results must be equal."""
    out = {}
    for pkg in BOTH:
        pkg.journal.time.t = 999.0
        out[pkg.name] = drive(pkg)
    assert out["port"] == out["reference"]
    return out["port"]


def _events(journal, kind=None) -> list:
    """Journal records without their timing field, and a flush record without
    its byte count (a tier file's header pickles its package's classes)."""
    return [{k: v for k, v in e.items() if k != "duration_s" and not (e["kind"] == "flush" and k == "bytes")}
            for e in journal.events(kind)]


def _spans(events, eng_id=None) -> list:
    """Span and instant records without times or thread ids, the engine label
    replaced by whether it is this engine's, sorted."""
    out = []
    for e in events:
        args = dict(e.get("args", {}))
        if "eng" in args:
            args["eng"] = args["eng"] == eng_id
        out.append(json.dumps({"name": e["name"], "ph": e.get("ph"), "args": args}, sort_keys=True, default=str))
    return sorted(out)


# --------------------------------------------------------------------------- #
# metrics registry
# --------------------------------------------------------------------------- #

def test_registry_counter_gauge_histogram_basics():
    def drive(pkg):
        reg = pkg.metrics.MetricsRegistry()
        c = reg.counter("c_total", "a counter")
        c.inc()
        c.inc(2.5)
        assert c.value() == 3.5
        g = reg.gauge("g", "a gauge")
        g.set(7)
        g.set(4.25)
        assert g.value() == 4.25
        h = reg.histogram("h_seconds", "a histogram")
        for v in (0.001, 0.01, 0.01):
            h.observe(v)
        st = h.stats()
        assert st["count"] == 3
        assert math.isclose(st["sum"], 0.021)
        # get-or-create returns the same object; type conflicts are hard errors
        assert reg.counter("c_total") is c
        with pytest.raises(TypeError):
            reg.gauge("c_total")
        with pytest.raises(TypeError):
            reg.counter("c_total", labelnames=("x",))
        return c.value(), g.value(), st, reg.snapshot(), reg.render_prometheus()

    _both(drive)


def test_registry_labels_and_prometheus_exposition():
    def drive(pkg):
        reg = pkg.metrics.MetricsRegistry()
        c = reg.counter("ev_total", "events", labelnames=("kind",))
        c.inc(kind="failure")
        c.inc(kind="failure")
        c.inc(kind="recovery")
        h = reg.histogram("lat_seconds", "latency", labelnames=("phase",), buckets=(0.1, 1.0))
        h.observe(0.05, phase="encode")
        h.observe(0.5, phase="encode")
        text = reg.render_prometheus()
        assert "# TYPE ev_total counter" in text
        assert 'ev_total{kind="failure"} 2' in text
        assert 'ev_total{kind="recovery"} 1' in text
        # histogram exposition: cumulative buckets + sum + count, le= label last
        assert 'lat_seconds_bucket{phase="encode",le="0.1"} 1' in text
        assert 'lat_seconds_bucket{phase="encode",le="+Inf"} 2' in text
        assert 'lat_seconds_count{phase="encode"} 2' in text
        snap = reg.snapshot()
        assert snap["ev_total"] == {"failure": 2.0, "recovery": 1.0}
        assert snap["lat_seconds"]["encode"]["count"] == 2
        # labeled child handle: same cell, no dict building per call
        child = c.labels(kind="failure")
        child.inc()
        assert c.value(kind="failure") == 3
        return text, snap, reg.render_prometheus()

    _both(drive)


def test_stats_view_is_bit_for_bit_over_registry():
    """CheckpointStats is a view: every field reads and writes a registry
    cell of the documented name; every reference field maps to the same
    kind, metric name and type in the port."""

    def drive(pkg):
        stats = pkg.ckpt.CheckpointStats()
        reg = stats.registry
        for attr, (kind, name, typ, _help) in pkg.ckpt._STATS_METRICS.items():
            assert getattr(stats, attr) == typ(0)
            setattr(stats, attr, typ(3))
            assert reg.get(name).value() == 3, name
            if kind == "counter":
                setattr(stats, attr, getattr(stats, attr) + 1)  # the += idiom
                assert reg.get(name).value() == 4, name
            assert isinstance(getattr(stats, attr), typ)
        with pytest.raises(AttributeError):
            stats.not_a_field = 1
        # the reference's fields (the port adds last_delta_ranges), help texts aside
        table = {a: (k, n, t.__name__) for a, (k, n, t, _) in pkg.ckpt._STATS_METRICS.items()
                 if a in jckpt._STATS_METRICS}
        names = {n for _, n, _ in table.values()}
        return table, {k: v for k, v in reg.snapshot().items() if k in names}

    _both(drive)


def test_engine_stats_match_registry_after_e2e_kill_and_restore():
    def drive(pkg):
        n = 8
        eng = pkg.engine(n, parity_group=4)
        vec = ShardedVec(n)
        eng.register("state", pkg.wrap(vec))
        assert eng.checkpoint({"step": 1})
        assert eng.checkpoint({"step": 2})
        eng.stores[3].wipe()
        eng._alive_fn = lambda: set(range(n)) - {3}
        meta = eng.restore()
        assert meta["step"] == 2
        s, reg = eng.stats, eng.registry
        assert reg.get("ckpt_created_total").value() == s.created == 2
        assert reg.get("restore_total").value() == s.restored == 1
        assert reg.get("restore_last_seconds").value() == s.last_restore_s > 0
        assert reg.get("ckpt_last_bytes_exchanged").value() == s.last_bytes_exchanged
        # per-stage histograms populated by the drain pipeline
        stages = {}
        for phase in ("capture", "encode", "transfer", "verify"):
            stages[phase] = eng._h_stage.stats(phase=phase)["count"]
            assert stages[phase] > 0, phase
        # the Prometheus text carries the same numbers the flat API reports
        text = reg.render_prometheus()
        assert f"ckpt_created_total {s.created}" in text
        assert f"restore_total {s.restored}" in text
        out = dict(created=s.created, restored=s.restored, exchanged=s.last_bytes_exchanged, stages=stages,
                   restored_vec=[v.tobytes() for v in vec.data],
                   names=sorted(set(reg.snapshot()) - PORT_ONLY_METRICS))
        eng.close()
        return out

    _both(drive)


def test_metrics_http_endpoint_agrees_with_stats():
    def drive(pkg):
        n = 4
        eng = pkg.engine(n, parity_group=2)
        eng.register("state", pkg.wrap(ShardedVec(n)))
        assert eng.checkpoint({"step": 1})
        srv = pkg.server.start_metrics_server(lambda: eng.registry, port=0)
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics") as r:
                assert r.status == 200
                text = r.read().decode()
            assert f"ckpt_created_total {eng.stats.created}" in text
            assert "# TYPE ckpt_stage_seconds histogram" in text
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics.json") as r:
                snap = json.load(r)
            assert snap["ckpt_created_total"] == eng.stats.created
            assert snap == eng.registry.snapshot()
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope")
            assert e.value.code == 404
        finally:
            srv.stop()
            eng.close()
        types = sorted(ln for ln in text.splitlines()
                       if ln.startswith("# TYPE") and ln.split()[2] not in PORT_ONLY_METRICS)
        return types, sorted(set(snap) - PORT_ONLY_METRICS), snap["ckpt_created_total"]

    _both(drive)


def test_timer_registry_mirrors_into_histogram():
    def drive(pkg):
        timers = pkg.timing.TimerRegistry()
        with timers("warm"):
            pass
        reg = pkg.metrics.MetricsRegistry()
        timers.attach_metrics(reg)
        with timers("warm"):      # existing timer rewired
            pass
        with timers("fresh"):     # new timers inherit the observer
            pass
        h = reg.get("timer_seconds")
        assert h.stats(name="warm")["count"] == 1
        assert h.stats(name="fresh")["count"] == 1
        snap = timers.snapshot()["warm"]
        # the snapshot keeps its format: the reference's (total, count) tuple,
        # the port's {"0": total, "1": count} tensors (the engine packs tensors)
        total, count = (float(snap["0"]), int(snap["1"])) if isinstance(snap, dict) else snap
        assert (total, count) == (timers("warm").total, 2)
        return h.stats(name="warm")["count"], h.stats(name="fresh")["count"], count, sorted(timers.snapshot())

    _both(drive)


# --------------------------------------------------------------------------- #
# span tracer
# --------------------------------------------------------------------------- #

def test_disabled_tracer_records_nothing():
    def drive(pkg):
        t = pkg.trace.tracer()
        assert not t.enabled
        with t.span("x", gen=1):
            t.instant("y")
        assert t.events() == []
        assert t.open_spans() == 0
        return t.events(), t.open_spans()

    _both(drive)


def test_spans_balance_and_export_chrome_json(tr, tmp_path):
    def drive(pkg):
        t = tr[pkg.name]
        with t.span("outer", gen=1):
            with t.span("inner", gen=1, chunk=0):
                assert t.open_spans() == 2
            t.instant("marker", rank=3)
        assert t.open_spans() == 0
        with pytest.raises(ValueError):
            with t.span("broken"):
                raise ValueError("boom")
        assert t.open_spans() == 0  # the exception still closed the span
        path = tmp_path / f"{pkg.name}.json"
        t.write(str(path))
        doc = json.loads(path.read_text())
        evs = doc["traceEvents"]
        phs = {e["ph"] for e in evs}
        assert phs == {"X", "i", "M"}
        xs = {e["name"] for e in evs if e["ph"] == "X"}
        assert xs == {"outer", "inner", "broken"}
        for e in evs:
            if e["ph"] == "X":
                assert e["dur"] >= 0 and "ts" in e and "pid" in e and "tid" in e
        assert any(e["ph"] == "M" and e["name"] == "thread_name" for e in evs)
        return _spans(evs), sorted(doc)

    _both(drive)


@pytest.mark.parametrize("kill_chunk", [0, 1, 2])
def test_spans_balance_across_mid_pipeline_kill_at_every_chunk(tr, kill_chunk):
    """A rank dying at any pipeline chunk (the engine's "pipeline_chunk"
    fault hook) aborts the checkpoint; every span opened by the drain, on
    background workers too, still closes, the abort is journaled, and the
    create-path spans keep their labels."""

    def drive(pkg):
        t = tr[pkg.name]
        n = 8
        state = {"chunks": 0, "armed": False}

        def hook(phase):
            if phase == "pipeline_chunk" and state["armed"]:
                if state["chunks"] == kill_chunk:
                    state["armed"] = False
                    eng.stores[6].wipe()
                state["chunks"] += 1

        eng = pkg.engine(n, hook=hook, parity_group=4, async_workers=1)
        vec = ShardedVec(n)
        eng.register("state", pkg.wrap(vec))
        assert eng.checkpoint({"step": 1})
        state["armed"] = True
        assert eng.checkpoint_async({"step": 2})
        assert eng.finalize_async() is False
        assert eng.stats.aborted == 1
        assert t.open_spans() == 0
        aborts = eng.journal.events("abort")
        assert len(aborts) == 1 and aborts[0]["gen"] == 2

        eng._fault_hook = lambda phase: None
        eng._alive_fn = lambda: set(range(n)) - {6}
        meta = eng.restore()
        assert meta["step"] == 1
        assert t.open_spans() == 0
        names = {e["name"] for e in t.events()}
        assert {"capture", "encode", "transfer", "verify", "restore"} <= names
        # every create-path span carries its engine and generation labels
        create = []
        for e in t.events():
            if e["name"] in ("capture", "encode", "transfer", "verify"):
                assert e["args"]["eng"] == eng._obs_id
                assert e["args"]["gen"] in (1, 2)
                create.append((e["name"], e["args"]["gen"]))
        eng.close()
        assert len(eng.journal.events("recovery")) == 1
        return (state["chunks"], _events(eng.journal, "abort"), sorted(create), eng.stats.aborted,
                [v.tobytes() for v in vec.data])

    _both(drive)


def test_overlap_efficiency_from_synthetic_trace():
    def ev(name, dur, eng, gen):
        return {"ph": "X", "name": name, "ts": 0.0, "dur": dur * 1e6,
                "tid": 0, "args": {"eng": eng, "gen": gen}}

    doc = {"traceEvents": [
        # async engine 1, gen 1: blocked = capture + finalize_wait = 1.0
        ev("capture", 0.9, 1, 1), ev("finalize_wait", 0.1, 1, 1),
        ev("encode", 2.0, 1, 1), ev("transfer", 0.5, 1, 1),
        ev("verify", 0.5, 1, 1), ev("handshake", 0.0, 1, 1),
        ev("commit", 0.0, 1, 1),
        # sync engine 2, gen 1: serialized = 5.0
        ev("capture", 1.0, 2, 1), ev("encode", 2.5, 2, 1),
        ev("transfer", 0.75, 2, 1), ev("verify", 0.75, 2, 1),
    ]}

    def drive(pkg):
        tmod = pkg.trace
        gens = tmod.generation_breakdown(tmod.load_trace(doc), eng=1)
        assert math.isclose(gens[1]["blocked_s"], 1.0)
        assert math.isclose(gens[1]["serialized_s"], 3.9)
        # self-baseline: 1 - 1.0/3.9
        eff = tmod.trace_overlap_efficiency(doc, eng=1)
        assert math.isclose(eff, 1 - 1.0 / 3.9)
        # A/B baseline from the sync engine's spans: 1 - 1.0/5.0
        ab = tmod.trace_overlap_efficiency(doc, eng=1, sync_eng=2)
        assert math.isclose(ab, 0.8)
        # the sync engine alone has no finalize join -> undefined
        assert tmod.trace_overlap_efficiency(doc, eng=2) is None
        return gens, eff, ab

    _both(drive)


def _masked(text: str) -> list[str]:
    """A report's lines with every number and run of spaces replaced."""
    return [re.sub(r" +", " ", re.sub(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?", "#", ln)).strip() for ln in text.splitlines()]


def test_report_renders_phase_breakdown(tr, tmp_path):
    def drive(pkg):
        n = 4
        eng = pkg.engine(n, parity_group=2, async_workers=1)
        eng.register("state", pkg.wrap(ShardedVec(n)))
        assert eng.checkpoint_async({"step": 1})
        assert eng.finalize_async() is True
        path = tmp_path / f"{pkg.name}.json"
        tr[pkg.name].write(str(path))
        eng.close()
        text = pkg.report.render(str(path), eng=eng._obs_id)
        assert "capture" in text and "finalize_wait" in text
        assert "overlap" in text
        assert "gen" in text.splitlines()[0]
        assert "failover" not in text  # no failover events in a clean trace
        return _masked(text)

    _both(drive)


def test_report_renders_failover_timeline(tr, tmp_path):
    """kill / heartbeat_lost / replica_promote instants and the sync,
    restore and re-enroll spans render as a chronological detect -> promote
    -> rebuild -> re-enroll narrative with the promotion stall totalled."""

    def drive(pkg):
        t = tr[pkg.name]
        t.instant("kill", rank=2, cause="silent_death", silent=True)
        t.instant("heartbeat_lost", rank=2, missed=3)
        t.instant("replica_promote", gen=4, failed_primary=1, failed_shadow=0)
        with t.span("replica_promote_restore", gen=4):
            pass
        with t.span("replica_reenroll"):
            pass
        with t.span("replica_sync", gen=5):
            pass
        path = tmp_path / f"{pkg.name}.json"
        t.write(str(path))
        rows = pkg.report.failover_timeline(pkg.trace.load_trace(str(path)), pkg.trace.load_instants(str(path)))
        assert [r["event"] for r in rows] == [
            "kill", "heartbeat_lost", "replica_promote",
            "replica_promote_restore", "replica_reenroll", "replica_sync",
        ]
        assert rows[0]["t0"] == 0.0 and "rank=2" in rows[0]["detail"]
        text = pkg.report.render(str(path))
        assert "failover timeline" in text
        assert "promotion stall" in text and "heartbeat_lost" in text
        return [(r["event"], r["detail"]) for r in rows], _masked(text)

    _both(drive)


# --------------------------------------------------------------------------- #
# event journal
# --------------------------------------------------------------------------- #

def test_journal_records_kill_and_recovery_and_survives_cold_restart(tmp_path):
    def drive(pkg):
        n = 4
        tier = tmp_path / pkg.name / "tier"
        eng = pkg.engine(n, parity_group=2, tiers=(pkg.storage.disk(str(tier), every=1),))
        vec = ShardedVec(n)
        eng.register("state", pkg.wrap(vec))
        cluster = pkg.cluster.VirtualCluster(n)
        cluster.attach_engine(eng)
        assert eng.checkpoint({"step": 1})
        eng._join_flush()

        cluster.kill(2, cause="unit_test")
        with pytest.raises(pkg.failures.ProcessFaultException):
            cluster.barrier()
        cluster.stabilize("spare")
        meta = eng.restore()
        assert meta["step"] == 1
        fails = eng.journal.events("failure")
        recs = eng.journal.events("recovery")
        assert len(fails) == 1 and fails[0]["rank"] == 2
        assert fails[0]["cause"] == "unit_test"
        assert len(recs) == 1 and recs[0]["failed"] == 1
        assert eng.journal.path is not None
        eng.close()
        first = _events(eng.journal)

        # cold restart: a new engine over the same tier directory replays
        # the journal; the failure history survives the process
        eng2 = pkg.engine(n, parity_group=2, tiers=(pkg.storage.disk(str(tier), every=1),))
        assert eng2.journal.path == eng.journal.path
        assert len(eng2.journal.events("failure")) == 1
        assert len(eng2.journal.events("recovery")) == 1
        assert eng2.journal.events("failure")[0]["rank"] == 2
        replayed = _events(eng2.journal)
        # and the tier data still restores (the journal file never confuses
        # generation discovery)
        vec2 = ShardedVec(n)
        for d in vec2.data:
            d *= 0.0
        eng2.register("state", pkg.wrap(vec2))
        eng2.escalate_from_tiers()
        assert eng2.restore()["step"] == 1
        eng2.close()
        return first, replayed, [v.tobytes() for v in vec2.data] == [v.tobytes() for v in ShardedVec(n).data]

    first, replayed, same = _both(drive)
    assert replayed[: len(first)] == first and same


def test_journal_skips_torn_tail_line(tmp_path):
    def drive(pkg):
        path = tmp_path / f"{pkg.name}.jsonl"
        j = pkg.journal.EventJournal(str(path))
        j.record("failure", rank=1)
        j.record("recovery", mode="spare")
        with open(path, "a") as f:
            f.write('{"kind": "failure", "rank": 2')  # torn write, no newline
        j2 = pkg.journal.EventJournal(str(path))
        assert len(j2) == 2
        assert [e["kind"] for e in j2.events()] == ["failure", "recovery"]
        return _events(j2)

    _both(drive)


def test_journal_counts_into_registry_and_nonscalars_stringified():
    def drive(pkg):
        reg = pkg.metrics.MetricsRegistry()
        j = pkg.journal.EventJournal(registry=reg)
        j.record("failure", rank=0)
        j.record("failure", rank=1, extra=[1, 2])
        j.record("flush", ok=True)
        c = reg.get("journal_events_total")
        assert c.value(kind="failure") == 2
        assert c.value(kind="flush") == 1
        assert j.events("failure")[1]["extra"] == "[1, 2]"
        return _events(j), reg.render_prometheus()

    _both(drive)


def test_fit_failure_stats_mtbf_and_bursts():
    t0 = 1000.0
    events = [{"kind": "failure", "ts": t} for t in (t0, t0 + 1e-4, t0 + 10.0, t0 + 20.0, t0 + 20.0 + 2e-4)]
    events.append({"kind": "recovery", "ts": t0 + 21.0})

    def drive(pkg):
        st = pkg.journal.fit_failure_stats(events)
        assert st["failures"] == 5
        assert st["bursts"] == 3
        assert st["max_burst"] == 2
        assert math.isclose(st["mtbf_s"], 10.0, rel_tol=1e-6)
        # the runtime wrapper accepts a journal or a raw list
        j = pkg.journal.EventJournal()
        for e in events:
            j._events.append(e)
        assert pkg.failures.observed_failure_stats(j) == st
        assert pkg.failures.observed_failure_stats(events) == st
        assert pkg.journal.fit_failure_stats([])["mtbf_s"] is None
        return st, pkg.journal.fit_failure_stats([])

    _both(drive)


# --------------------------------------------------------------------------- #
# structured logging
# --------------------------------------------------------------------------- #

def test_json_logging_emits_structured_fields(monkeypatch, capsys):
    def drive(pkg):
        monkeypatch.setenv(pkg.log_env, "1")
        pkg.log.reconfigure_for_tests()
        try:
            log = pkg.log.bind(pkg.log.get_logger("test.obs"), rank=3, component="test")
            log.info("hello %s", "world", fields={"generation": 7})
            logging.getLogger(pkg.log_root).handlers[0].flush()
            line = capsys.readouterr().err.strip().splitlines()[-1]
            obj = json.loads(line)
            assert obj["msg"] == "hello world"
            assert obj["level"] == "INFO"
            assert obj["component"] == "test.obs"
            assert obj["rank"] == 3 and obj["generation"] == 7
            assert isinstance(obj["ts"], float)
        finally:
            monkeypatch.delenv(pkg.log_env)
            pkg.log.reconfigure_for_tests()
        return {k: v for k, v in obj.items() if k != "ts"}

    _both(drive)


def test_text_logging_appends_bound_fields(monkeypatch, capsys):
    def drive(pkg):
        monkeypatch.delenv(pkg.log_env, raising=False)
        pkg.log.reconfigure_for_tests()
        try:
            log = pkg.log.bind(pkg.log.get_logger("test.obs2"), rank=1)
            log.warning("plain message")
            err = capsys.readouterr().err
            assert "plain message [rank=1]" in err
        finally:
            pkg.log.reconfigure_for_tests()
        return [ln.split("plain message", 1)[1] for ln in err.splitlines() if "plain message" in ln]

    _both(drive)
