"""Failure model + deterministic fault injection (carried over from
``repro.runtime.failures``; the random draws stay in numpy, so a seed kills
the same ranks in both packages).

``ProcessFaultException`` is the Algorithm-3 signal: raised out of the step
(the analogue of MPI_ERR_PROC_FAILED surfacing through the error handler) and
caught in the trainer's main loop, where the deterministic recovery pipeline
runs (stabilize → restore).

``FailureInjector`` drives *when* hosts die: either an explicit
(step -> ranks) schedule (tests, the paper's kill-signal experiment in §7.5)
or an MTBF-driven Bernoulli process per rank per step (eq. 1: system failure
rate scales with rank count), fully deterministic given the seed.

Multi-failure bursts: real clusters lose correlated sets of hosts (a rack
power domain, a shared switch) — exactly the event single-parity redundancy
cannot survive and the Reed-Solomon codec exists for (DESIGN.md §8).
``schedule_group_burst`` targets ``count`` members of one redundancy group;
``burst_size > 1`` widens every MTBF-driven kill into a correlated burst of
adjacent ranks inside the victim's ``burst_group`` (clipped at the group
boundary so the burst stays a within-group event).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class ProcessFaultException(RuntimeError):
    """A process/host fault was signaled; the main loop must recover."""

    def __init__(self, ranks: list[int], phase: str = "step") -> None:
        super().__init__(f"host fault: ranks {ranks} died during {phase}")
        self.ranks = ranks
        self.phase = phase


@dataclass
class FailureInjector:
    n_ranks: int
    mtbf_rank_s: float | None = None        # per-rank MTBF (None = schedule only)
    step_time_s: float = 1.0                # simulated step duration
    seed: int = 0
    schedule: dict[int, list[int]] = field(default_factory=dict)  # step -> ranks
    # Ranks may also die *during* a checkpoint; phase-targeted kills for the
    # Algorithm-2 tests:
    checkpoint_schedule: dict[int, list[int]] = field(default_factory=dict)
    # Correlated bursts: every MTBF kill takes out burst_size ranks of the
    # victim's burst_group-sized group (1 = independent failures, the default).
    burst_size: int = 1
    burst_group: int = 0
    # Silent deaths: the rank stops heartbeating but never raises
    # ProcessFaultException at the barrier — only the heartbeat monitor's
    # missed-beat timeout can notice (step -> ranks).
    silent_schedule: dict[int, list[int]] = field(default_factory=dict)
    # Kills aimed at the *shadow* team (step -> replica-local ranks), for the
    # replica-dies-during-catch-up orderings.
    replica_schedule: dict[int, list[int]] = field(default_factory=dict)
    # Detection-latency assertion: when set, note_detection() asserts every
    # silent death is noticed within this many ticks of the kill.
    max_detection_ticks: int | None = None
    # Optional callback invoked as detection_hook(rank, latency_ticks) for
    # every detected silent death (tests install custom assertions here).
    detection_hook: object = None
    _fired: set = field(default_factory=set)
    _tick: int = 0  # wall-clock step count (monotonic across rollbacks)
    _death_tick: dict[int, int] = field(default_factory=dict)  # rank -> tick of silent kill

    def schedule_group_burst(
        self, step: int, group_index: int, group_size: int, count: int,
        kind: str = "step",
    ) -> list[int]:
        """Schedule ``count`` concurrent failures inside one redundancy group
        (the first ``count`` members, deterministically). ``kind`` selects the
        step schedule or the mid-checkpoint one. Returns the doomed ranks."""
        start = group_index * group_size
        members = list(range(start, min(start + group_size, self.n_ranks)))
        assert count <= len(members), (count, members)
        doomed = members[:count]
        target = self.schedule if kind == "step" else self.checkpoint_schedule
        target.setdefault(step, []).extend(doomed)
        return doomed

    def schedule_domain_burst(
        self, step: int, topology, domain_index: int,
        level: str | None = None, kind: str = "step",
    ) -> list[int]:
        """Schedule the loss of one *entire* failure domain (a whole rack's
        power feed, a pod's shared switch): every rank whose
        ``topology.domain_of(rank, level)`` equals ``domain_index`` dies at
        ``step`` simultaneously. This is the correlated event domain-aware
        parity placement (DESIGN.md §16) exists to survive — with at most
        one group member per domain, a whole-domain burst costs each group
        exactly one shard. Returns the doomed ranks."""
        doomed = [
            r for r in range(min(self.n_ranks, topology.n_ranks))
            if topology.domain_of(r, level) == domain_index
        ]
        assert doomed, (domain_index, level)
        target = self.schedule if kind == "step" else self.checkpoint_schedule
        target.setdefault(step, []).extend(doomed)
        return doomed

    def _widen_burst(self, rank: int) -> list[int]:
        """Expand an MTBF kill into its correlated within-group burst."""
        if self.burst_size <= 1:
            return [rank]
        g = self.burst_group or self.n_ranks
        lo, hi = (rank // g) * g, min((rank // g + 1) * g, self.n_ranks)
        return [lo + (rank - lo + i) % (hi - lo) for i in range(min(self.burst_size, hi - lo))]

    def kills_at_step(self, step: int) -> list[int]:
        """Kills are wall-clock events: a scheduled kill fires exactly once
        even though the logical step is replayed after a rollback."""
        self._tick += 1
        kills = []
        for r in self.schedule.get(step, []):
            key = ("step", step, r)
            if key not in self._fired:
                self._fired.add(key)
                kills.append(r)
        if self.mtbf_rank_s:
            p = min(self.step_time_s / self.mtbf_rank_s, 1.0)
            rng = np.random.default_rng(self.seed * 1_000_003 + self._tick)
            draws = rng.random(self.n_ranks)
            for r in np.nonzero(draws < p)[0]:
                kills.extend(self._widen_burst(int(r)))
        return sorted(set(kills))

    def silent_kills_at_step(self, step: int) -> list[int]:
        """Ranks that go silent at ``step``: they keep the process alive as
        far as the barrier is concerned but stop heartbeating, so only the
        timeout path detects them. Records the kill tick so the detection
        latency can be asserted by :meth:`note_detection`."""
        kills = []
        for r in self.silent_schedule.get(step, []):
            key = ("silent", step, r)
            if key not in self._fired:
                self._fired.add(key)
                kills.append(r)
                self._death_tick[r] = self._tick
        return sorted(set(kills))

    def replica_kills_at_step(self, step: int) -> list[int]:
        """Kills aimed at the shadow team's (replica-local) ranks."""
        kills = []
        for r in self.replica_schedule.get(step, []):
            key = ("replica", step, r)
            if key not in self._fired:
                self._fired.add(key)
                kills.append(r)
        return sorted(set(kills))

    def note_detection(self, rank: int) -> int | None:
        """Called by the runtime when the heartbeat monitor declares ``rank``
        dead. Returns the detection latency in ticks for silently-killed ranks
        (None for ranks the injector didn't silence), asserting it against
        ``max_detection_ticks`` and invoking ``detection_hook`` if configured.
        """
        death = self._death_tick.pop(rank, None)
        if death is None:
            return None
        latency = self._tick - death
        if self.max_detection_ticks is not None:
            assert latency <= self.max_detection_ticks, (
                f"silent death of rank {rank} took {latency} ticks to detect "
                f"(> {self.max_detection_ticks})"
            )
        if self.detection_hook is not None:
            self.detection_hook(rank, latency)
        return latency

    def kills_at_checkpoint(self, ckpt_index: int) -> list[int]:
        kills = []
        for r in self.checkpoint_schedule.get(ckpt_index, []):
            key = ("ckpt", ckpt_index, r)
            if key not in self._fired:
                self._fired.add(key)
                kills.append(r)
        return sorted(set(kills))

    def expected_system_mtbf_s(self) -> float | None:
        """Eq. 1: mu = mu_ind / N."""
        if not self.mtbf_rank_s:
            return None
        return self.mtbf_rank_s / self.n_ranks


def observed_failure_stats(journal) -> dict:
    """Fit failure statistics from an engine's durable event journal
    (DESIGN.md §13): observed count, MTBF (mean inter-burst arrival), and the
    burst profile — the empirical counterpart of ``expected_system_mtbf_s``
    that topology-aware policy fits its schedule against.
    Accepts an :class:`repro_torch.obs.journal.EventJournal` or a raw event
    list."""
    from repro_torch.obs.journal import fit_failure_stats

    events = journal.events() if hasattr(journal, "events") else journal
    return fit_failure_stats(events)
