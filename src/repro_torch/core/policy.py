"""Adaptive per-entity protection policy (DESIGN.md §16); a copy of
``repro.core.policy``, which imports no JAX.

The engine's codec is a static, launch-time choice; real failure behaviour
is not. This module closes the loop: at every commit point the policy
re-fits the durable journal's failure statistics
(:func:`repro_torch.obs.journal.fit_failure_stats` — burst sizes, domain
clustering, MTBF) and solves for the cheapest codec + parity count that
covers what the cluster has actually been losing, Daly-style: observed
behaviour, not the configured worst case, sets the protection level.

Decision table (per entity, at fixed group size k):

  ===================================  ==========================================
  observed failure regime              decision
  ===================================  ==========================================
  quiet (no failures yet)              keep the engine's configured codec
  single-rank losses dominate, k >= 4  ``lrc`` — single-failure repair reads
                                       only the local subgroup (k_local reads
                                       instead of k), tolerance unchanged
  correlated multi-rank bursts         ``rs`` with m = largest per-group loss
                                       any observed burst could cost
  ===================================  ==========================================

The *per-group* cost of a burst is where topology earns its keep: under
domain-aware placement a single-domain burst (whole rack) costs every
parity group at most ONE shard, so a rack loss argues for cheap-repair
LRC, not for more parity. Bursts that span domains are the genuinely
dangerous kind and drive m up.

Overrides are applied through :meth:`CheckpointEngine.set_entity_codec`,
take effect from the NEXT capture (restore always decodes with the spec
recorded in the payload, never live policy state), and every *change* is
journaled as a ``policy`` event. ``ProtectionPolicy.attach`` registers the
policy as a commit hook; :meth:`report` feeds ``repro_torch.launch.report``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from repro_torch.obs.journal import fit_failure_stats
from repro_torch.utils.logging import get_logger

log = get_logger("core.policy")


@dataclass
class PolicyDecision:
    """One entity's protection choice for the next capture."""

    entity: str
    codec: str          # codec family to protect with ("rs", "lrc", ...)
    m: int              # parity count (rs_parity / LRC global parities)
    reason: str         # human-readable rationale (journaled + reported)
    changed: bool       # True when this differs from the active codec


class ProtectionPolicy:
    """Re-evaluates per-entity protection from fitted failure statistics.

    ``min_parity``/``max_parity`` clamp the solved parity count (m never
    exceeds k-1 either — beyond that RS overhead passes replication).
    ``lrc_min_group`` is the smallest k for which LRC's local groups are
    worth their extra blob (k < 4 gives k_local >= k/2, hardly cheaper
    than a global read).
    """

    def __init__(
        self,
        engine,
        min_parity: int = 1,
        max_parity: int = 4,
        lrc_min_group: int = 4,
    ) -> None:
        self.engine = engine
        self.min_parity = min_parity
        self.max_parity = max_parity
        self.lrc_min_group = lrc_min_group
        self.decisions: dict[str, PolicyDecision] = {}
        self.evaluations = 0
        self.changes = 0
        self.last_stats: dict[str, Any] = {}

    # ------------------------------------------------------------------ #
    def _group_cost(self, stats: dict[str, Any]) -> int:
        """Largest number of shards any parity group could lose to one of
        the observed bursts. Domain-contained bursts cost 1 under
        domain-aware placement; domain-spanning bursts must be assumed
        adversarial (all victims in one group, clamped at k)."""
        k = max(self.engine.cfg.parity_group, 1)
        topo = getattr(self.engine, "topology", None)
        cost = 0
        sizes = stats.get("burst_sizes") or []
        n_single_domain = stats.get("domain_bursts", 0)
        # Largest-first: the biggest bursts are the ones that matter; we
        # can't match sizes to domain labels from the aggregate, so credit
        # the domain-contained discount to the largest bursts (they are the
        # rack-loss signature domain placement was built for).
        credited = n_single_domain if topo is not None else 0
        for size in sorted(sizes, reverse=True):
            if size <= 1:
                cost = max(cost, 1)
            elif credited > 0 and size <= stats.get("max_domain_burst", 0):
                credited -= 1
                cost = max(cost, 1)
            else:
                cost = max(cost, min(size, k))
        return cost

    def evaluate(self) -> list[PolicyDecision]:
        """Fit the journal and produce one decision per registered entity
        (no side effects — :meth:`apply` installs them)."""
        eng = self.engine
        if not eng.cfg.parity_group:
            return []  # no erasure layout to tune
        stats = fit_failure_stats(eng.journal.events())
        self.last_stats = stats
        self.evaluations += 1
        k = eng.cfg.parity_group
        base = eng.codec
        base_name = base.name
        base_m = getattr(base, "m", getattr(base, "global_parity", 0)) or 1

        if not stats["failures"]:
            codec, m, reason = base_name, base_m, "quiet: no observed failures"
        else:
            cost = max(self._group_cost(stats), self.min_parity)
            m = min(cost, self.max_parity, max(1, k - 1))
            singles_dominate = cost <= 1
            if singles_dominate and k >= self.lrc_min_group:
                codec = "lrc"
                reason = (
                    f"single-shard losses dominate "
                    f"(max per-group cost {cost}, "
                    f"{stats['domain_bursts']}/{stats['bursts']} bursts "
                    f"domain-contained): local repair pays"
                )
                m = max(m, self.min_parity)
            elif cost > 1:
                codec = "rs"
                reason = (
                    f"domain-spanning bursts observed "
                    f"(max per-group cost {cost}): global parity m={m}"
                )
            else:
                codec, reason = base_name, f"k={k} too small for LRC; keep {base_name}"
                m = max(m, base_m) if codec == base_name else m

        out = []
        for name in sorted(eng._entities):
            active = eng._codec_for(name)
            active_spec = eng._codec_spec(active)
            changed = active_spec.split(":")[0] != codec or (
                (getattr(active, "m", getattr(active, "global_parity", 0)) or 0) != m
                and codec in ("rs", "lrc")
            )
            out.append(PolicyDecision(name, codec, m, reason, changed))
        return out

    def apply(self, decisions: list[PolicyDecision] | None = None) -> int:
        """Install the decisions on the engine; journal every change.
        Returns the number of entities whose protection changed."""
        if decisions is None:
            decisions = self.evaluate()
        eng = self.engine
        n_changed = 0
        for d in decisions:
            self.decisions[d.entity] = d
            if not d.changed:
                continue
            if d.codec == eng.codec.name and d.m == (
                getattr(eng.codec, "m", getattr(eng.codec, "global_parity", 0)) or 0
            ):
                eng.clear_entity_codec(d.entity)
            else:
                eng.set_entity_codec(d.entity, d.codec, m=d.m)
            n_changed += 1
            self.changes += 1
            eng.journal.record(
                "policy", target="codec", entity=d.entity, codec=d.codec,
                m=d.m, reason=d.reason,
                failures=self.last_stats.get("failures", 0),
                bursts=self.last_stats.get("bursts", 0),
                domain_bursts=self.last_stats.get("domain_bursts", 0),
            )
            log.info("policy: %s -> %s m=%d (%s)", d.entity, d.codec, d.m, d.reason)
        return n_changed

    # ------------------------------------------------------------------ #
    def attach(self) -> "ProtectionPolicy":
        """Register as a commit hook: re-evaluate at every commit point."""
        self.engine.add_commit_hook(self._on_commit)
        return self

    def _on_commit(self, engine) -> None:
        try:
            self.apply()
        except Exception:  # policy must never fail a commit
            log.exception("protection policy evaluation failed")

    # ------------------------------------------------------------------ #
    def report(self) -> dict[str, Any]:
        """Snapshot for ``repro_torch.launch.report`` / memory_report."""
        return {
            "evaluations": self.evaluations,
            "changes": self.changes,
            "stats": dict(self.last_stats),
            "decisions": {
                n: {"codec": d.codec, "m": d.m, "reason": d.reason}
                for n, d in sorted(self.decisions.items())
            },
        }
