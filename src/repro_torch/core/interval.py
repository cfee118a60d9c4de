"""Checkpoint-interval theory (paper §5.2.5, §7.3; eqs. 1, 3, 7; eq. 2),
carried over from ``repro.core.interval`` unchanged (it is jax-free).

  * eq. 1: system MTBF          mu = mu_ind / N
  * eq. 3: Young/Daly optimum   T_FO = sqrt(2 mu C)
  * eq. 7: overhead at T_FO     C / sqrt(2 mu C)
  * eq. 2: memory factor        MEM = S (1 + 2 R)

plus an adaptive scheduler that re-estimates C from measured checkpoint
durations and converts T_FO into a step period for the training loop, and
the **per-level schedule** for the storage-tier ladder (DESIGN.md §12):
cheap diskless checkpoints at the Daly optimum of ordinary host failures,
disk generations every k-th commit at the Daly optimum of the failures the
diskless tier cannot survive (beyond-tolerance bursts, whole-job loss) —
Young/Daly applied per level, each against its own failure class and cost.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def system_mtbf(mtbf_individual_s: float, n_nodes: int) -> float:
    """Eq. 1: the failure rate is proportional to the node count."""
    assert n_nodes >= 1
    return mtbf_individual_s / n_nodes


def optimal_interval(mtbf_s: float, checkpoint_s: float) -> float:
    """Eq. 3 (first-order Young/Daly): T_FO = sqrt(2 mu C).

    Only valid when mu >> C; callers should check ``overhead`` stays small.
    """
    assert mtbf_s > 0 and checkpoint_s >= 0
    return math.sqrt(2.0 * mtbf_s * checkpoint_s)


def overhead(checkpoint_s: float, mtbf_s: float) -> float:
    """Eq. 7: fraction of runtime spent checkpointing at the optimal interval."""
    if checkpoint_s == 0:
        return 0.0
    return checkpoint_s / optimal_interval(mtbf_s, checkpoint_s)


def memory_factor(n_copies: int) -> float:
    """Eq. 2 factor: 1 + 2R (double-buffered R-copy in-memory snapshots).

    R counts copies held per process: pairwise R=2 (own + partner) -> 5x."""
    return 1.0 + 2.0 * n_copies


def parity_memory_factor(group_size: int) -> float:
    """Erasure-coded variant: own copy + 1/g parity slice, double-buffered."""
    return 1.0 + 2.0 * (1.0 + 1.0 / group_size)


@dataclass
class CheckpointScheduler:
    """Converts the Daly interval into a step period, adaptively.

    The paper notes the estimate "may only serve as an orientation" because mu
    and C drift; we re-estimate C as a running mean of measured checkpoint
    durations and recompute the period after every checkpoint.
    """

    mtbf_s: float
    step_time_s: float            # estimated (re-measured by the trainer)
    checkpoint_s: float = 1.0     # prior for C before first measurement
    min_period: int = 1
    max_period: int = 100_000
    _c_samples: list = field(default_factory=list)

    def record_checkpoint_duration(self, seconds: float) -> None:
        self._c_samples.append(seconds)
        k = min(len(self._c_samples), 16)
        self.checkpoint_s = sum(self._c_samples[-k:]) / k

    def record_step_time(self, seconds: float) -> None:
        self.step_time_s = 0.9 * self.step_time_s + 0.1 * seconds

    @property
    def interval_s(self) -> float:
        return optimal_interval(self.mtbf_s, max(self.checkpoint_s, 1e-9))

    @property
    def period_steps(self) -> int:
        steps = int(round(self.interval_s / max(self.step_time_s, 1e-9)))
        return max(self.min_period, min(steps, self.max_period))

    def due(self, step: int, last_checkpoint_step: int) -> bool:
        return (step - last_checkpoint_step) >= self.period_steps

    @property
    def expected_overhead(self) -> float:
        return overhead(self.checkpoint_s, self.mtbf_s)


def multilevel_intervals(
    mtbf_levels_s: list[float], cost_levels_s: list[float]
) -> list[float]:
    """Per-level Young/Daly optima for a storage-tier ladder: level ℓ guards
    the failure classes levels < ℓ cannot handle (level 0: ordinary host
    failures at the system MTBF; level 1: beyond-tolerance bursts / full-job
    loss at their own, much longer, MTBF), each with its own checkpoint cost
    C_ℓ. Returns T_ℓ = sqrt(2 μ_ℓ C_ℓ) per level — the ladder's flush
    cadence is the ratio T_ℓ / T_0 (see :class:`MultiLevelScheduler`)."""
    assert len(mtbf_levels_s) == len(cost_levels_s)
    return [
        optimal_interval(mu, max(c, 1e-9))
        for mu, c in zip(mtbf_levels_s, cost_levels_s)
    ]


@dataclass
class MultiLevelScheduler:
    """Adaptive per-level schedule for the tier ladder.

    ``base`` is the diskless (level-0) scheduler the trainer already runs;
    each persistent level gets its own failure MTBF (``level_mtbf_s[ℓ-1]``)
    and an adaptively re-estimated flush cost (running mean of measured
    flush durations, like the base scheduler's C). ``flush_every(ℓ)``
    converts the interval ratio into "flush this tier every k-th committed
    level-0 checkpoint" — the quantity ``EngineConfig.tiers[ℓ-1].every``
    consumes.
    """

    base: CheckpointScheduler
    level_mtbf_s: list[float]
    flush_s: list[float] = field(default_factory=list)   # C_ℓ priors
    max_every: int = 10_000
    _samples: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        while len(self.flush_s) < len(self.level_mtbf_s):
            self.flush_s.append(1.0)

    def record_flush_duration(self, level: int, seconds: float) -> None:
        """Fold one measured flush of persistent level ``level`` (1-based,
        level 0 being the diskless tier) into its cost estimate."""
        samples = self._samples.setdefault(level, [])
        samples.append(seconds)
        k = min(len(samples), 16)
        self.flush_s[level - 1] = sum(samples[-k:]) / k

    def interval_s(self, level: int) -> float:
        if level == 0:
            return self.base.interval_s
        return optimal_interval(
            self.level_mtbf_s[level - 1], max(self.flush_s[level - 1], 1e-9)
        )

    def flush_every(self, level: int) -> int:
        """Commits between flushes of persistent level ``level`` (>= 1):
        the per-level Daly interval expressed in level-0 checkpoints."""
        ratio = self.interval_s(level) / max(self.base.interval_s, 1e-9)
        return max(1, min(int(round(ratio)), self.max_every))
