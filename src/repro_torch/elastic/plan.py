"""Pure repartition planner: old-world shard coordinates -> new-world shards
(carried over unchanged from ``repro.elastic.plan``).

Given the global-coordinate manifests of a checkpoint created on N ranks
(core.serialization.LeafSlice per leaf per origin), the physical residency of
every recovered origin payload in the *new* world, and a new world size M,
``plan_repartition`` emits a minimal-movement assignment of row ranges to the
M new ranks.

"Minimal movement" is exact, not heuristic: every byte of a uniquely-owned
leaf has exactly one recovered source location, so the only freedom is in
replicated leaves — where the planner always prefers a copy already resident
on the destination host. The resulting ``bytes_moved`` therefore equals the
information-theoretic lower bound for the given residency (asserted by
the tests, and reported in ``ElasticReport``).

The planner is pure (no tensors, no engine state): it is shared by the
host executor and the row-gather executor on the card (elastic/reshard.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.serialization import LeafSlice


@dataclass(frozen=True)
class Segment:
    """Copy ``rows`` rows of leaf ``leaf`` from ``origin``'s recovered shard.

    ``src_start`` is relative to the origin shard's held range (i.e. row 0 of
    the recovered payload array), ``dst_start`` relative to the new shard.
    ``local`` marks rows already resident on the destination host — they cost
    no movement.
    """

    leaf: int
    origin: int
    src_start: int
    dst_start: int
    rows: int
    local: bool


@dataclass(frozen=True)
class LeafTarget:
    """New-world ownership of one leaf on one new rank."""

    start: int  # global row range this new rank must hold
    stop: int
    split: bool  # False: the leaf is replicated in the new world


@dataclass
class RepartitionPlan:
    n_old: int
    n_new: int
    # new rank -> leaf index -> target range + ordered segments filling it
    targets: list[dict[int, LeafTarget]]
    segments: list[list[Segment]]
    bytes_total: int = 0        # bytes the new world must hold, summed over ranks
    bytes_moved: int = 0        # bytes crossing hosts under this plan
    bytes_lower_bound: int = 0  # minimum possible movement given residency
    notes: list[str] = field(default_factory=list)

    @property
    def movement_ratio(self) -> float:
        """1.0 = optimal. >1 would mean wasted traffic (never, by design)."""
        if self.bytes_lower_bound == 0:
            return 1.0 if self.bytes_moved == 0 else float("inf")
        return self.bytes_moved / self.bytes_lower_bound


@dataclass
class ElasticReport:
    """Aggregate of one restore_elastic call across all entities."""

    n_old: int
    n_new: int
    plans: dict[str, RepartitionPlan] = field(default_factory=dict)

    def add(self, name: str, plan: RepartitionPlan) -> None:
        self.plans[name] = plan

    @property
    def bytes_total(self) -> int:
        return sum(p.bytes_total for p in self.plans.values())

    @property
    def bytes_moved(self) -> int:
        return sum(p.bytes_moved for p in self.plans.values())

    @property
    def bytes_lower_bound(self) -> int:
        return sum(p.bytes_lower_bound for p in self.plans.values())

    @property
    def movement_ratio(self) -> float:
        lb = self.bytes_lower_bound
        if lb == 0:
            return 1.0 if self.bytes_moved == 0 else float("inf")
        return self.bytes_moved / lb


def new_world_targets(
    coords0: list[LeafSlice], n_new: int
) -> list[dict[int, LeafTarget]]:
    """Per-new-rank ownership. A leaf splits over M iff its failure-domain
    dim length is divisible by M (the same rule ShardPlan.split_dim applies at
    the next checkpoint); otherwise every new rank holds the full leaf."""
    out: list[dict[int, LeafTarget]] = [{} for _ in range(n_new)]
    for i, ls in enumerate(coords0):
        if ls.axis is None:
            for j in range(n_new):
                out[j][i] = LeafTarget(0, 1, split=False)
            continue
        g = ls.global_shape[ls.axis]
        if g % n_new == 0 and g >= n_new:
            rows = g // n_new
            for j in range(n_new):
                out[j][i] = LeafTarget(j * rows, (j + 1) * rows, split=True)
        else:
            for j in range(n_new):
                out[j][i] = LeafTarget(0, g, split=False)
    return out


def _holders(coords: list[list[LeafSlice]], leaf: int, lo: int, hi: int):
    """Origins whose held range overlaps [lo, hi) for ``leaf`` (old world)."""
    for origin, per_leaf in enumerate(coords):
        ls = per_leaf[leaf]
        s, e = max(ls.start, lo), min(ls.stop, hi)
        if s < e:
            yield origin, s, e


def plan_repartition(
    coords: list[list[LeafSlice]],
    n_new: int,
    residency: dict[int, int | None],
    row_nbytes: list[int] | None = None,
) -> RepartitionPlan:
    """Assign every row range of the logical entity to the M new ranks.

    ``coords[origin][leaf]`` — old-world coordinates (N origins).
    ``residency[origin]`` — new rank whose host holds origin's recovered
    payload (None: reconstructed/evicted, resident nowhere).
    ``row_nbytes[leaf]`` — bytes per row (full-leaf bytes for replicated
    leaves), used only for the movement accounting.
    """
    n_old = len(coords)
    assert n_old >= 1 and n_new >= 1
    n_leaves = len(coords[0]) if coords else 0
    rb = row_nbytes if row_nbytes is not None else [1] * n_leaves
    targets = new_world_targets(coords[0], n_new)

    segments: list[list[Segment]] = [[] for _ in range(n_new)]
    bytes_total = bytes_moved = lower = 0
    notes: list[str] = []

    for j in range(n_new):
        for i, tgt in sorted(targets[j].items()):
            need = tgt.stop - tgt.start
            bytes_total += need * rb[i]
            ls0 = coords[0][i]
            if ls0.axis is None:
                # Replicated leaf: one full copy per new rank; prefer a local one.
                origin = _pick_replicated_source(coords, i, j, residency)
                local = residency.get(origin) == j
                segments[j].append(Segment(i, origin, 0, 0, 1, local))
                if not local:
                    bytes_moved += rb[i]
                if not any(residency.get(o) == j for o in range(n_old)):
                    lower += rb[i]  # fresh host: someone must send it
                continue
            # Axis-ful leaf: tile the target range with overlapping holders.
            covered = tgt.start
            local_rows = 0
            while covered < tgt.stop:
                cands = list(_holders(coords, i, covered, tgt.stop))
                # Among holders of the next uncovered row, prefer the local one.
                at = [c for c in cands if c[1] <= covered]
                if not at:
                    raise ValueError(
                        f"leaf {i}: rows [{covered},{tgt.stop}) of the global "
                        f"entity are held by no origin shard"
                    )
                at.sort(key=lambda c: (residency.get(c[0]) != j, c[0]))
                origin, _, e = at[0]
                ls = coords[origin][i]
                take = min(e, tgt.stop) - covered
                local = residency.get(origin) == j
                segments[j].append(
                    Segment(i, origin, covered - ls.start, covered - tgt.start, take, local)
                )
                if local:
                    local_rows += take
                else:
                    bytes_moved += take * rb[i]
                covered += take
            # Lower bound: rows of the target range NOT resident on host j.
            avail = _local_rows_available(coords, i, j, tgt, residency)
            lower += (need - avail) * rb[i]
            if avail < local_rows:  # pragma: no cover - plan would be buggy
                notes.append(f"leaf {i} rank {j}: local rows exceed availability")

    return RepartitionPlan(
        n_old=n_old,
        n_new=n_new,
        targets=targets,
        segments=segments,
        bytes_total=bytes_total,
        bytes_moved=bytes_moved,
        bytes_lower_bound=lower,
        notes=notes,
    )


def _pick_replicated_source(
    coords: list[list[LeafSlice]], leaf: int, j: int, residency: dict[int, int | None]
) -> int:
    for origin in range(len(coords)):
        if residency.get(origin) == j:
            return origin
    return 0


def _local_rows_available(
    coords: list[list[LeafSlice]],
    leaf: int,
    j: int,
    tgt: LeafTarget,
    residency: dict[int, int | None],
) -> int:
    """Rows of ``tgt`` already resident on new rank ``j``'s host (union of the
    held ranges of origins resident there; ranges never overlap for split
    leaves, and fully overlap for old-replicated ones)."""
    spans = []
    for origin, per_leaf in enumerate(coords):
        if residency.get(origin) != j:
            continue
        ls = per_leaf[leaf]
        s, e = max(ls.start, tgt.start), min(ls.stop, tgt.stop)
        if s < e:
            spans.append((s, e))
    spans.sort()
    total = 0
    cursor = tgt.start
    for s, e in spans:
        s = max(s, cursor)
        if s < e:
            total += e - s
            cursor = e
    return total
