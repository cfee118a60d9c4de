"""Straggler detection & mitigation, carried over from
``repro.runtime.straggler`` unchanged (numpy only).

At multi-pod scale slow hosts are the dual problem to dead hosts: the step
barrier makes every rank wait for the slowest. The detector keeps per-rank
step-duration EWMAs (fed by the runtime's heartbeat; in simulation by the
injector's synthetic delays) and flags ranks whose EWMA exceeds
``threshold x`` the cluster median over a window.

Mitigation escalates, mirroring the recovery machinery the checkpoint scheme
already provides:
  1. flag + log (observability),
  2. after ``evict_after`` consecutive windows: recommend eviction — the rank
     is treated exactly like a failed host (kill -> stabilize -> restore from
     the last checkpoint), which the paper's spare-substitution policy makes
     cheap. A straggler eviction costs one rollback interval, which the Daly
     model prices; ``worth_evicting`` does that cost/benefit check.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class StragglerReport:
    flagged: list[int]
    evict: list[int]
    median_s: float
    slowdowns: dict[int, float]


@dataclass
class StragglerDetector:
    n_ranks: int
    threshold: float = 1.5       # x median => straggler
    window: int = 8              # steps per evaluation window
    evict_after: int = 3         # consecutive flagged windows before eviction
    ewma: float = 0.3
    _step_times: dict[int, float] = field(default_factory=dict)
    _flag_counts: dict[int, int] = field(default_factory=dict)
    _steps_seen: int = 0

    def record_step(self, per_rank_seconds: dict[int, float]) -> StragglerReport | None:
        for r, t in per_rank_seconds.items():
            prev = self._step_times.get(r, t)
            self._step_times[r] = (1 - self.ewma) * prev + self.ewma * t
        self._steps_seen += 1
        if self._steps_seen % self.window != 0:
            return None
        return self._evaluate()

    def _evaluate(self) -> StragglerReport:
        times = self._step_times
        med = float(np.median(list(times.values()))) if times else 0.0
        flagged, evict, slow = [], [], {}
        for r, t in times.items():
            ratio = t / med if med > 0 else 1.0
            if ratio > self.threshold:
                flagged.append(r)
                slow[r] = ratio
                self._flag_counts[r] = self._flag_counts.get(r, 0) + 1
                if self._flag_counts[r] >= self.evict_after:
                    evict.append(r)
            else:
                self._flag_counts[r] = 0
        return StragglerReport(sorted(flagged), sorted(evict), med, slow)

    def forget(self, rank: int) -> None:
        self._step_times.pop(rank, None)
        self._flag_counts.pop(rank, None)

    def slowdown_percentile(self, pct: float = 95.0) -> float:
        """Observed per-rank slowdown (EWMA step time over the cluster median)
        at the given percentile. The heartbeat monitor multiplies its
        missed-beat threshold by this grace factor so a rank that is merely
        ``pct``-percentile slow is treated as a straggler, not a corpse —
        the dead/straggling discrimination DESIGN.md §15 tunes."""
        times = list(self._step_times.values())
        if not times:
            return 1.0
        med = float(np.median(times))
        if med <= 0:
            return 1.0
        ratios = [t / med for t in times]
        return max(1.0, float(np.percentile(ratios, pct)))


def worth_evicting(
    slowdown: float,
    step_time_s: float,
    rollback_steps: int,
    horizon_steps: int,
) -> bool:
    """Evicting costs one rollback (re-computing ``rollback_steps``); keeping a
    straggler costs (slowdown-1) x step_time for the remaining horizon."""
    cost_keep = (slowdown - 1.0) * step_time_s * horizon_steps
    cost_evict = rollback_steps * step_time_s
    return cost_keep > cost_evict
