"""Append-only structured event journal (DESIGN.md §13); a copy of
``repro.obs.journal``, which imports no JAX.

Records the cluster's resilience history — failures, recoveries,
escalations, elastic resizes, tier-flush outcomes — as JSON-lines, one
object per event, each carrying at minimum ``kind`` and ``ts`` plus
whatever structured fields the caller attaches (rank, generation, cause,
duration, bytes, ...).

The journal is written *through the tier machinery*: an engine with a
persistent storage tier places ``journal.jsonl`` inside that tier's
directory, so the record survives process death and cold restarts exactly
as far as the checkpoint data itself does. On construction an existing
file is replayed into memory, so a restarted run sees the full failure
history — the raw material for MTBF fitting (:func:`fit_failure_stats`,
feeding ROADMAP item 5's burst statistics).

A journal without a path is purely in-memory (diskless engines, tests).
When given a :class:`~repro_torch.obs.metrics.MetricsRegistry` it also counts
events per kind (``journal_events_total{kind=...}``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Iterable

#: Event kinds with a dedicated meaning in analysis/tests. ``record`` accepts
#: any kind string; these are the ones the runtime itself emits.
KINDS = (
    "failure",          # a rank was killed / revoked (cluster.kill)
    "recovery",         # a successful restore (mode, duration, bytes)
    "escalation",       # group decode failed -> tier ladder climbed
    "resize",           # elastic N->M re-encode
    "flush",            # tier flush outcome (ok/error, bytes, duration)
    "flush_skipped",    # cadence point dropped (no queue slot)
    "flush_queued",     # cadence point deferred into the single queue slot
    "abort",            # checkpoint aborted mid-pipeline
    "cold_restart",     # full-cluster restart from persistent tiers
    "heartbeat_lost",   # rank missed the beat threshold (silent death)
    "replica_sync",     # shadow team caught up to a committed generation
    "replica_promote",  # shadow team promoted in place of the primary
    "policy",           # adaptive protection policy decision (DESIGN.md §16)
)


class EventJournal:
    """Append-only event log, optionally persisted as JSON-lines."""

    def __init__(self, path: str | None = None, registry: Any = None) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        self._counter = None
        if registry is not None:
            self._counter = registry.counter(
                "journal_events_total",
                "Structured journal events recorded, by kind.",
                labelnames=("kind",),
            )
        if path is not None and os.path.exists(path):
            self._load(path)

    def _load(self, path: str) -> None:
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue  # torn tail write from a killed process
                    if isinstance(ev, dict) and "kind" in ev:
                        self._events.append(ev)
        except OSError:
            pass

    # -- recording ----------------------------------------------------------
    def record(self, kind: str, **fields: Any) -> dict[str, Any]:
        """Append one event; returns the stored dict (with ``ts`` added)."""
        ev: dict[str, Any] = {"kind": kind, "ts": time.time()}
        for k, v in fields.items():
            if isinstance(v, (str, int, float, bool)) or v is None:
                ev[k] = v
            else:
                ev[k] = str(v)
        with self._lock:
            self._events.append(ev)
            if self.path is not None:
                try:
                    d = os.path.dirname(self.path)
                    if d:
                        os.makedirs(d, exist_ok=True)
                    with open(self.path, "a") as f:
                        f.write(json.dumps(ev, sort_keys=True) + "\n")
                        f.flush()
                except OSError:
                    pass  # journal loss must never fail the pipeline
        if self._counter is not None:
            self._counter.inc(kind=kind)
        return ev

    # -- querying -----------------------------------------------------------
    def events(self, kind: str | None = None) -> list[dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e.get("kind") == kind]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


def fit_failure_stats(events: Iterable[dict[str, Any]]) -> dict[str, Any]:
    """Fit simple failure statistics from journal events: count, observed
    MTBF (mean inter-arrival of ``failure`` events), the burst profile
    (failures sharing one arrival instant — simultaneous group kills), and
    the domain clustering the failure events carry (``domain`` labels from
    ``VirtualCluster.kill``, DESIGN.md §16):

      * ``burst_sizes``     — every burst's size (the tail the adaptive
        policy solves tolerance against);
      * ``by_domain``       — failure count per domain label;
      * ``domain_bursts``   — bursts whose members share ONE domain (the
        correlated whole-rack signature), vs ``bursts`` total;
      * ``max_domain_burst`` — largest single-domain burst observed.

    This is the durable input ROADMAP item 5's topology-aware policy needs;
    with only 0/1 failures the MTBF is ``None`` (not enough arrivals).
    """
    evs = sorted(
        (
            (e["ts"], e.get("domain") or "")
            for e in events
            if e.get("kind") == "failure" and isinstance(e.get("ts"), (int, float))
        ),
        key=lambda td: td[0],
    )
    times = [t for t, _ in evs]
    n = len(times)
    out: dict[str, Any] = {
        "failures": n, "mtbf_s": None, "bursts": 0, "max_burst": 0,
        "burst_sizes": [], "by_domain": {}, "domain_bursts": 0,
        "max_domain_burst": 0,
    }
    if not n:
        return out
    for _, dom in evs:
        if dom:
            out["by_domain"][dom] = out["by_domain"].get(dom, 0) + 1
    # Cluster arrivals closer than 1ms into one burst (group kills land
    # within the same stabilize window).
    bursts: list[int] = []
    burst_doms: list[set[str]] = []
    size, doms = 1, {evs[0][1]} if evs[0][1] else set()
    for prev, cur in zip(evs, evs[1:]):
        if cur[0] - prev[0] < 1e-3:
            size += 1
            if cur[1]:
                doms.add(cur[1])
        else:
            bursts.append(size)
            burst_doms.append(doms)
            size, doms = 1, {cur[1]} if cur[1] else set()
    bursts.append(size)
    burst_doms.append(doms)
    out["bursts"] = len(bursts)
    out["max_burst"] = max(bursts)
    out["burst_sizes"] = bursts
    for b, ds in zip(bursts, burst_doms):
        if b > 1 and len(ds) == 1 and ds:
            out["domain_bursts"] += 1
            out["max_domain_burst"] = max(out["max_domain_burst"], b)
    if len(bursts) > 1:
        first_arrivals = []
        i = 0
        for b in bursts:
            first_arrivals.append(times[i])
            i += b
        gaps = [b - a for a, b in zip(first_arrivals, first_arrivals[1:])]
        if gaps:
            out["mtbf_s"] = sum(gaps) / len(gaps)
    return out
