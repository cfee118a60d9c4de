"""VirtualCluster — single-process simulation of the multi-pod host set
(port of ``repro.runtime.cluster``).

Ranks are failure domains: one rank = one data-axis coordinate of the
production mesh (a group of TPU hosts that live and die together from the
training job's perspective). The cluster owns liveness, the revoked flag, the
spare pool and the ULFM-analogue stabilization pipeline:

  revoke()  — the cluster-wide fault signal (MPI_Comm_revoke: after a fault,
              every subsequent barrier raises until stabilized)
  shrink()  — dense rank renumbering over survivors (MPI_Comm_shrink), used
              by the elastic-shrink recovery policy
  substitute_spares() — the paper's §5.2.4 spare-process policy: dead ranks
              are replaced, the rank count stays constant

The CheckpointEngine's stores are wired to cluster liveness: killing a rank
wipes its in-memory snapshots — diskless checkpoints die with their host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

from repro_torch.core.checkpoint import CheckpointEngine
from repro_torch.core.distribution import shrink_reassignment
from repro_torch.obs.trace import tracer
from repro_torch.runtime.failures import ProcessFaultException
from repro_torch.utils.logging import get_logger

log = get_logger("runtime.cluster")

RecoveryPolicy = Literal["spare", "shrink", "elastic"]


@dataclass
class StabilizationReport:
    policy: str
    failed: list[int]
    n_ranks_before: int
    n_ranks_after: int
    spares_used: int
    reassignment: dict[int, int]
    # Post-recovery load factor: work per surviving rank relative to before
    # (paper §5.2.4 — the imbalance that load balancing must fix).
    load_factor: float


class VirtualCluster:
    def __init__(
        self, n_ranks: int, n_spares: int = 0, topology: object | None = None
    ) -> None:
        self.n_ranks = n_ranks
        self.n_spares = n_spares
        self._alive: set[int] = set(range(n_ranks))
        self._spares_left = n_spares
        self.revoked = False
        self.fault_log: list[tuple[str, list[int]]] = []
        self.engine: CheckpointEngine | None = None
        # Failure-domain topology (core/topology.py): labels every kill's
        # journal record with the rank's domain, the key fit_failure_stats
        # clusters correlated bursts by.
        self.topology = topology.resized(n_ranks) if topology is not None else None

    # ------------------------------------------------------------------ #
    def attach_engine(self, engine: CheckpointEngine) -> None:
        self.engine = engine
        engine._alive_fn = self.alive  # engine liveness = cluster liveness
        # One topology serves both, whichever was given one, so placement
        # and failure labels never disagree about which rack a rank is in.
        if self.topology is None and engine.topology is not None:
            self.topology = engine.topology
        elif self.topology is not None and engine.topology is None:
            engine.topology = self.topology.resized(engine.n_ranks)
            engine._groups_cache = None

    def domain_ranks(self, domain_index: int, level: str | None = None) -> list[int]:
        """Alive-or-dead member ranks of one failure domain (burst targets)."""
        if self.topology is None:
            return []
        return [r for r in range(self.n_ranks) if self.topology.domain_of(r, level) == domain_index]

    def alive(self) -> set[int]:
        return set(self._alive)

    @property
    def failed(self) -> set[int]:
        return set(range(self.n_ranks)) - self._alive

    # ------------------------------------------------------------------ #
    # fault signalling (ULFM analogue)
    # ------------------------------------------------------------------ #
    def kill(self, rank: int, cause: str = "host_failure",
             silent: bool = False) -> None:
        """Host failure: the rank leaves; its in-memory snapshots are erased.

        ``silent=True`` models a rank that stops responding without any
        fault ever surfacing through the communicator (a hung kernel, a
        switch partition): the communicator is NOT revoked, so barriers keep
        succeeding and only the heartbeat monitor's missed-beat timeout can
        notice the death."""
        if rank not in self._alive:
            return
        self._alive.discard(rank)
        if self.engine is not None:
            self.engine.stores[rank].wipe()
            # Durable failure record (DESIGN.md §13): rank, generation at the
            # moment of death, cause — journaled through the engine's tier
            # machinery so MTBF fitting survives restarts.
            self.engine.journal.record(
                "failure", rank=rank, cause=cause,
                gen=self.engine.stats.created,
                alive=len(self._alive), n_ranks=self.n_ranks,
                domain=(self.topology.domain_label(rank)
                        if self.topology is not None and rank < self.topology.n_ranks else ""),
            )
        tracer().instant("kill", rank=rank, cause=cause, silent=silent)
        if not silent:
            self.revoked = True  # next communication raises (MPI_ERR_REVOKED)
        self.fault_log.append(("kill", [rank]))
        log.warning("rank %d killed%s (alive: %d/%d)", rank,
                    " silently" if silent else "", len(self._alive), self.n_ranks)

    def barrier(self, phase: str = "step") -> None:
        """A collective entry point: raises if the communicator is revoked.
        This is how faults surface deterministically at step granularity."""
        if self.revoked:
            raise ProcessFaultException(sorted(self.failed), phase)

    # ------------------------------------------------------------------ #
    # stabilization (revoke -> shrink / spare substitution)
    # ------------------------------------------------------------------ #
    def stabilize(self, policy: RecoveryPolicy = "spare") -> StabilizationReport:
        failed = sorted(self.failed)
        n_before = self.n_ranks
        spares_used = 0
        if policy == "spare" and self._spares_left >= len(failed):
            # Replace every dead rank with a spare; mesh shape is preserved.
            for r in failed:
                self._alive.add(r)
                if self.engine is not None:
                    self.engine.stores[r].revive(r)
                spares_used += 1
            self._spares_left -= spares_used
            reassignment = {r: r for r in range(self.n_ranks)}
            n_after = self.n_ranks
            load = 1.0
        else:
            # Elastic shrink: dense renumbering of survivors (MPI_Comm_shrink
            # semantics); the data axis contracts, survivors inherit the work.
            # Policy "elastic" keeps its name: the caller repartitions the
            # checkpoint onto the shrunken world (engine.restore_elastic)
            # instead of replaying old-world shards.
            policy = "elastic" if policy == "elastic" else "shrink"
            reassignment = shrink_reassignment(self.n_ranks, set(failed))
            n_after = len(reassignment)
            load = n_before / max(n_after, 1)
            # Stores keep their data; the engine renumbers them when it
            # restores onto the shrunken world (restore_elastic).
        self.revoked = False
        report = StabilizationReport(
            policy=policy,
            failed=failed,
            n_ranks_before=n_before,
            n_ranks_after=n_after,
            spares_used=spares_used,
            reassignment=reassignment,
            load_factor=load,
        )
        log.info(
            "stabilized via %s: failed=%s ranks %d->%d load_factor=%.2f",
            report.policy, failed, n_before, n_after, load,
        )
        return report

    def restart_all(self) -> None:
        """Full-restart policy (DESIGN.md §12): after a whole-job loss every
        rank rejoins on a fresh communicator — liveness resets to the full
        world and the revoked flag clears. The ranks' in-memory stores are
        rehydrated separately by the engine's tier-ladder escalation (the
        data, not the hosts, is what the disk generation restores)."""
        self._alive = set(range(self.n_ranks))
        self.revoked = False
        self.fault_log.append(("restart", [self.n_ranks]))
        if self.engine is not None:
            self.engine.journal.record("cold_restart", n_ranks=self.n_ranks)
        log.info("cluster restarted: all %d ranks rejoined", self.n_ranks)

    def regrow(self, n_new_ranks: int) -> None:
        """Elastic scale-up: new hosts join (paper §5.2.4's 'add available
        resources ... as soon as they are available')."""
        assert n_new_ranks >= self.n_ranks
        for r in range(self.n_ranks, n_new_ranks):
            self._alive.add(r)
        self.n_ranks = n_new_ranks

    @property
    def spares_left(self) -> int:
        return self._spares_left

    def resize(self, n_new_ranks: int) -> None:
        """Elastic shrink/grow transition after an N-to-M restore: the new
        world is ranks 0..M-1, all alive. The engine's stores were already
        rebuilt by restore_elastic; this realigns cluster liveness with them
        and clears the revoked flag (the stabilized communicator)."""
        self.n_ranks = n_new_ranks
        self._alive = set(range(n_new_ranks))
        self.revoked = False
        self.fault_log.append(("resize", [n_new_ranks]))
        log.info("cluster resized to %d ranks", n_new_ranks)


class HeartbeatMonitor:
    """Timeout-based liveness: detection without a fault exception.

    Every serving tick each live rank 'beats' (in production: an out-of-band
    UDP ping per host; here: the cluster's alive set observed at the step
    barrier). A rank whose last beat is older than

        ``miss_threshold x straggler-grace``  ticks

    is declared dead. The grace factor comes from
    :meth:`slowdown_percentile` of a straggler detector (the reference's
    ``repro.runtime.straggler.StragglerDetector``, not ported yet):
    the missed-beat budget stretches with the observed straggler tail, so a
    95th-percentile-slow host is flagged slow (straggler machinery) rather
    than dead (failover machinery) — the DESIGN.md §15 discrimination.

    Liveness is exported per rank through the metrics registry as the
    ``cluster_rank_up`` gauge (1 = beating, 0 = declared lost), so the
    Prometheus endpoint shows the fleet's health surface; every declaration
    is journaled as a ``heartbeat_lost`` event.
    """

    def __init__(
        self,
        n_ranks: int,
        miss_threshold: int = 3,
        straggler: object | None = None,
        registry: object | None = None,
        journal: object | None = None,
    ) -> None:
        self.n_ranks = n_ranks
        self.miss_threshold = miss_threshold
        # The construction-time threshold is the tuning FLOOR: fitted-MTBF
        # tuning may stretch patience on a quiet cluster, never sharpen it
        # below what the operator configured (DESIGN.md §16).
        self._base_miss_threshold = miss_threshold
        self.straggler = straggler
        self.journal = journal
        self._last_beat: dict[int, int] = {r: 0 for r in range(n_ranks)}
        self._declared: set[int] = set()
        self._gauge = None
        if registry is not None:
            self._gauge = registry.gauge(
                "cluster_rank_up",
                "Per-rank heartbeat liveness (1 = beating, 0 = lost).",
                labelnames=("rank",),
            )
            for r in range(n_ranks):
                self._gauge.set(1, rank=r)

    def grace(self) -> float:
        """Current dead-vs-straggling grace multiplier (>= 1)."""
        if self.straggler is None:
            return 1.0
        return self.straggler.slowdown_percentile()

    def deadline_ticks(self) -> int:
        """Beats a rank may miss before being declared dead."""
        import math

        return max(1, math.ceil(self.miss_threshold * self.grace()))

    def tune_from_journal(
        self,
        journal: object | None = None,
        tick_seconds: float = 1.0,
        frac: float = 0.01,
        cap_factor: int = 8,
    ) -> int:
        """Drive the miss threshold from the journal's fitted MTBF.

        A quiet cluster (large MTBF) can afford more patience before
        declaring a silent rank dead — false declarations trigger a full
        stabilize/restore cycle, which on a healthy fleet costs more than
        the extra detection latency. The threshold becomes

            ``clamp(base, round(mtbf_ticks * frac), base * cap_factor)``

        so the construction-time value stays the floor (tuning never makes
        detection *hastier* than configured) and the cap bounds worst-case
        detection latency on a near-idle journal. With no journal, no
        fitted MTBF (fewer than two bursts), or a degenerate tick length,
        the threshold reverts to the static base.
        """
        src = journal if journal is not None else self.journal
        events = src.events() if hasattr(src, "events") else (src or [])
        from repro_torch.obs.journal import fit_failure_stats

        stats = fit_failure_stats(events)
        mtbf = stats.get("mtbf_s")
        base = self._base_miss_threshold
        if not mtbf or mtbf <= 0 or tick_seconds <= 0:
            self.miss_threshold = base
            return base
        mtbf_ticks = mtbf / tick_seconds
        tuned = int(round(mtbf_ticks * frac))
        self.miss_threshold = max(base, min(base * cap_factor, tuned))
        if self.journal is not None:
            self.journal.record(
                "policy", target="heartbeat", miss_threshold=self.miss_threshold,
                base=base, mtbf_s=mtbf, tick_seconds=tick_seconds,
            )
        return self.miss_threshold

    def observe(self, beating: set[int], tick: int) -> list[int]:
        """Record this tick's beats; return ranks newly declared dead."""
        for r in beating:
            self._last_beat[r] = tick
            if r in self._declared:
                self._declared.discard(r)  # revived (spare substitution)
                if self._gauge is not None:
                    self._gauge.set(1, rank=r)
        limit = self.deadline_ticks()
        lost = []
        for r, last in self._last_beat.items():
            if r in beating or r in self._declared:
                continue
            if tick - last >= limit:
                self._declared.add(r)
                lost.append(r)
                if self._gauge is not None:
                    self._gauge.set(0, rank=r)
                if self.journal is not None:
                    self.journal.record(
                        "heartbeat_lost", rank=r, tick=tick,
                        last_beat=last, missed=tick - last, limit=limit,
                    )
                tracer().instant("heartbeat_lost", rank=r, missed=tick - last)
                log.warning(
                    "heartbeat lost: rank %d missed %d ticks (limit %d)",
                    r, tick - last, limit,
                )
        return sorted(lost)

    def reset(self, alive: set[int], tick: int) -> None:
        """Re-arm after recovery: every currently-alive rank beats now."""
        for r in alive:
            self._last_beat[r] = tick
            if r in self._declared:
                self._declared.discard(r)
            if self._gauge is not None:
                self._gauge.set(1, rank=r)
