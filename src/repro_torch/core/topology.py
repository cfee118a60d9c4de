"""Failure-domain topology model (DESIGN.md §16); a copy of
``repro.core.topology``, which imports no JAX.

Real clusters do not fail rank-by-rank: hosts share power supplies, racks
share PDUs and ToR switches, pods share a DCN spine. The source paper's
2^18-process scaling argument assumes *uncorrelated* failures — the gap the
resiliency survey (Agullo et al. 2020) flags for diskless schemes, and the
one ROADMAP item 5 closes: a whole-rack loss must not be able to take out
two members of one parity group.

``ClusterTopology`` maps every rank (a failure-axis coordinate, i.e. a host
group from the training job's perspective) to a nested domain hierarchy

    host ⊂ rack ⊂ pod

and is the single input to

  * domain-aware parity-group placement
    (:func:`repro_torch.core.distribution.domain_parity_groups`),
  * domain-labelled failure events (``VirtualCluster.kill`` →
    ``obs.journal.fit_failure_stats`` burst clustering), and
  * correlated fault injection
    (``FailureInjector.schedule_domain_burst``).

The model is deliberately tiny and frozen: a tuple of per-rank labels plus
the regular shape parameters needed to re-derive it at a different world
size (the elastic N-to-M path resizes topologies alongside engines).
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: Domain levels, innermost first. ``domain_of(rank, "rack")`` answers "which
#: rack does this rank live in"; placement separates groups at one level.
LEVELS = ("host", "rack", "pod")


@dataclass(frozen=True)
class FailureDomain:
    """One node of the domain hierarchy: a level, its index at that level,
    and the ranks it contains. ``label`` is the journal/fit_failure_stats
    clustering key (stable across resizes of a regular topology)."""

    level: str
    index: int
    ranks: tuple[int, ...]

    @property
    def label(self) -> str:
        return f"{self.level}:{self.index}"


@dataclass(frozen=True)
class ClusterTopology:
    """rank -> (host, rack, pod) indices for ``n_ranks`` failure-axis ranks.

    Construct via :meth:`regular` (the common fixed-shape cluster) or
    :meth:`from_labels` (arbitrary assignments, e.g. read from an inventory
    file). ``placement_level`` names the level parity-group placement and
    burst statistics separate on (racks by default — the unit that shares a
    PDU and a ToR switch).
    """

    #: per-rank (host_idx, rack_idx, pod_idx) triples, len == n_ranks
    labels: tuple[tuple[int, int, int], ...]
    placement_level: str = "rack"
    #: regular-shape parameters (ranks per host/rack/pod) kept so ``resized``
    #: re-derives the same layout at a new world size; None for irregular
    #: topologies built from explicit labels (those resize by truncation /
    #: modular extension).
    shape: tuple[int, int, int] | None = None
    name: str = field(default="topology", compare=False)

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def regular(
        cls,
        n_ranks: int,
        ranks_per_host: int = 1,
        hosts_per_rack: int = 4,
        racks_per_pod: int = 4,
        placement_level: str = "rack",
        name: str = "regular",
    ) -> "ClusterTopology":
        """The fixed-shape cluster: ranks fill hosts, hosts fill racks, racks
        fill pods, in rank order (matching the mesh's row-major device
        ordering, so rank adjacency == physical adjacency — exactly the
        layout that makes naive contiguous parity groups domain-correlated).
        """
        assert n_ranks >= 1 and ranks_per_host >= 1
        assert hosts_per_rack >= 1 and racks_per_pod >= 1
        per_rack = ranks_per_host * hosts_per_rack
        per_pod = per_rack * racks_per_pod
        labels = tuple(
            (r // ranks_per_host, r // per_rack, r // per_pod)
            for r in range(n_ranks)
        )
        return cls(
            labels=labels,
            placement_level=placement_level,
            shape=(ranks_per_host, per_rack, per_pod),
            name=name,
        )

    @classmethod
    def from_labels(
        cls,
        labels: list[tuple[int, int, int]],
        placement_level: str = "rack",
        name: str = "custom",
    ) -> "ClusterTopology":
        return cls(
            labels=tuple(tuple(int(x) for x in lab) for lab in labels),
            placement_level=placement_level,
            name=name,
        )

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #
    @property
    def n_ranks(self) -> int:
        return len(self.labels)

    def domain_of(self, rank: int, level: str | None = None) -> int:
        """Domain index of ``rank`` at ``level`` (placement level default)."""
        level = level or self.placement_level
        return self.labels[rank][LEVELS.index(level)]

    def domain_label(self, rank: int, level: str | None = None) -> str:
        level = level or self.placement_level
        return f"{level}:{self.domain_of(rank, level)}"

    def domains(self, level: str | None = None) -> list[FailureDomain]:
        """All domains at ``level``, each with its member ranks (sorted by
        domain index — deterministic placement input)."""
        level = level or self.placement_level
        li = LEVELS.index(level)
        by_idx: dict[int, list[int]] = {}
        for r, lab in enumerate(self.labels):
            by_idx.setdefault(lab[li], []).append(r)
        return [
            FailureDomain(level=level, index=i, ranks=tuple(rs))
            for i, rs in sorted(by_idx.items())
        ]

    def max_domain_size(self, level: str | None = None) -> int:
        return max((len(d.ranks) for d in self.domains(level)), default=0)

    # ------------------------------------------------------------------ #
    # elastic resize
    # ------------------------------------------------------------------ #
    def resized(self, n_ranks: int) -> "ClusterTopology":
        """The same topology at a different world size (elastic N-to-M).

        Regular topologies re-derive from their shape parameters — new ranks
        land in new hosts/racks/pods per the fixed cluster shape. Irregular
        ones truncate, or extend by repeating the label pattern with fresh
        domain indices (conservative: extended ranks never share a domain
        with existing ones)."""
        if n_ranks == self.n_ranks:
            return self
        if self.shape is not None:
            per_host, per_rack, per_pod = self.shape
            labels = tuple(
                (r // per_host, r // per_rack, r // per_pod)
                for r in range(n_ranks)
            )
            return ClusterTopology(
                labels=labels,
                placement_level=self.placement_level,
                shape=self.shape,
                name=self.name,
            )
        if n_ranks < self.n_ranks:
            labels = self.labels[:n_ranks]
        else:
            mh = max(lab[0] for lab in self.labels) + 1
            mr = max(lab[1] for lab in self.labels) + 1
            mp = max(lab[2] for lab in self.labels) + 1
            extra = []
            for r in range(self.n_ranks, n_ranks):
                j = r - self.n_ranks
                extra.append((mh + j, mr + j, mp + j))
            labels = self.labels + tuple(extra)
        return ClusterTopology(
            labels=labels,
            placement_level=self.placement_level,
            shape=None,
            name=self.name,
        )

    def __repr__(self) -> str:  # compact: topologies embed in configs/logs
        n_d = {lv: len(self.domains(lv)) for lv in LEVELS}
        return (
            f"ClusterTopology({self.name!r}, n={self.n_ranks}, "
            f"hosts={n_d['host']}, racks={n_d['rack']}, pods={n_d['pod']}, "
            f"level={self.placement_level!r})"
        )
