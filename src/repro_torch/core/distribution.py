"""Snapshot distribution and recovery assignment (paper Algorithms 1 and 4)
and parity groups.

The subset of ``repro.core.distribution`` the device tier and the host
engine need, copied: the scheme registry with ``pairwise``/``neighbor``/
``mirror``, ``multi_copy_shifts``, ``perm_pairs`` and ``inverse_perm`` (the
rank permutations a partner copy travels along), Algorithm 4's
``recovery_plan`` with ``DataLostError``, ``parity_groups``/``group_of``
(the striped codecs' group partition), the failure-domain-aware layouts
``balanced_parity_groups``/``domain_parity_groups`` with
``placement_conflicts``, ``blob_holder_group`` (where each group's
redundancy blobs live) and ``parity_recovery_plan`` (Algorithm 4 for XOR
groups). "Rank" is a failure-domain index: a host of
the engine, or a coordinate of the virtual mesh's redundancy axis.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable


class DataLostError(RuntimeError):
    """All ranks holding a given block's backup failed (paper: 'Checkpoint not
    restorable as only one copy was made')."""


def pairwise_schedule(n_ranks: int, rank: int) -> tuple[int, int]:
    """Verbatim Algorithm 1: returns (send_to, recv_from) for ``rank``."""
    if n_ranks <= 1:
        return rank, rank
    shift = n_ranks // 2
    send_to = (rank + shift) % n_ranks
    if shift > rank:
        recv_from = n_ranks - (shift - rank)
    else:
        recv_from = rank - shift
    return send_to, recv_from


def shifted_schedule(n_ranks: int, rank: int, shift: int) -> tuple[int, int]:
    send_to = (rank + shift) % n_ranks
    recv_from = (rank - shift) % n_ranks
    return send_to, recv_from


def mirror_schedule(n_ranks: int, rank: int) -> tuple[int, int]:
    """Hot-replica half-rotation: rank r pairs with its twin at r + N/2."""
    assert n_ranks % 2 == 0, (
        f"mirror scheme needs an even (primary+shadow) axis, got {n_ranks}"
    )
    twin = (rank + n_ranks // 2) % n_ranks
    return twin, twin


SchemeFn = Callable[[int, int], tuple[int, int]]
_SCHEMES: dict[str, SchemeFn] = {
    "pairwise": pairwise_schedule,
    "neighbor": lambda n, r: shifted_schedule(n, r, 1 if n > 1 else 0),
    "mirror": mirror_schedule,
}


def register_scheme(name: str, fn: SchemeFn) -> None:
    _SCHEMES[name] = fn


def get_scheme(name: str) -> SchemeFn:
    return _SCHEMES[name]


def multi_copy_shifts(n_ranks: int, n_copies: int) -> list[int]:
    """R evenly spaced shifts; shift 0 excluded. R=1 reduces to pairwise."""
    if n_ranks <= 1:
        return []
    if n_copies == 1:
        return [n_ranks // 2]
    shifts = []
    for j in range(1, n_copies + 1):
        s = max(1, round(j * n_ranks / (n_copies + 1))) % n_ranks
        if s == 0:
            s = 1
        if s not in shifts:
            shifts.append(s)
    return shifts


def perm_pairs(n_ranks: int, scheme: str = "pairwise", shift: int | None = None) -> list[tuple[int, int]]:
    """(src, dst) pairs of the permutation along the redundancy axis."""
    if n_ranks <= 1:
        return []
    if shift is not None:
        return [(i, (i + shift) % n_ranks) for i in range(n_ranks)]
    fn = get_scheme(scheme)
    return [(i, fn(n_ranks, i)[0]) for i in range(n_ranks)]


def inverse_perm(pairs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    return [(dst, src) for src, dst in pairs]


# ---------------------------------------------------------------------------
# Algorithm 4 — pair-wise snapshot recovery distribution
# ---------------------------------------------------------------------------

def pairwise_recovery(
    rank_prev: int,
    n_prev: int,
    reassignment: Callable[[int], int],
    survived: Callable[[int], bool],
) -> int:
    """Verbatim Algorithm 4: the *new* rank that must restore the block whose
    origin is the pre-fault rank ``rank_prev``."""
    if not survived(rank_prev):
        shift = n_prev // 2
        rank_backup_prev = (rank_prev + shift) % n_prev
        if not survived(rank_backup_prev):
            raise DataLostError(
                f"rank {rank_prev} and its backup {rank_backup_prev} both failed"
            )
        return reassignment(rank_backup_prev)
    return reassignment(rank_prev)


def shrink_reassignment(n_prev: int, failed: set[int]) -> dict[int, int]:
    """Survivors densely renumbered in old-rank order (MPI_Comm_shrink)."""
    new = {}
    nxt = 0
    for r in range(n_prev):
        if r not in failed:
            new[r] = nxt
            nxt += 1
    return new


def recovery_plan(n_prev: int, failed: set[int], scheme: str = "pairwise") -> dict[int, int]:
    """origin_prev_rank -> new_rank responsible for restoring its blocks.

    Applies Algorithm 4 for every pre-fault rank; raises DataLostError if any
    block is unrecoverable under the given scheme.
    """
    reassign_map = shrink_reassignment(n_prev, failed)
    survived = lambda r: r not in failed
    reassign = lambda r: reassign_map[r]
    plan = {}
    for origin in range(n_prev):
        if scheme == "pairwise":
            plan[origin] = pairwise_recovery(origin, n_prev, reassign, survived)
        else:
            fn = get_scheme(scheme)
            if survived(origin):
                plan[origin] = reassign(origin)
            else:
                backup = fn(n_prev, origin)[0]
                if not survived(backup):
                    raise DataLostError(f"rank {origin} and backup {backup} both failed")
                plan[origin] = reassign(backup)
    return plan


# ---------------------------------------------------------------------------
# Parity groups
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParityGroup:
    members: tuple[int, ...]


def parity_groups(n_ranks: int, group_size: int) -> list[ParityGroup]:
    """Contiguous groups of ``group_size``; the last group is short when the
    world size is not a multiple."""
    assert group_size >= 1 and n_ranks >= 1
    return [
        ParityGroup(tuple(range(g, min(g + group_size, n_ranks))))
        for g in range(0, n_ranks, group_size)
    ]


def group_of(rank: int, group_size: int) -> int:
    return rank // group_size


def rank_group_map(groups: list[ParityGroup]) -> dict[int, int]:
    """rank -> group index for a group list (the domain-aware layouts break
    the ``rank // group_size`` identity)."""
    return {r: gi for gi, g in enumerate(groups) for r in g.members}


def balanced_parity_groups(n_ranks: int, group_size: int) -> list[ParityGroup]:
    """Contiguous groups with balanced sizes: same group count as
    ``parity_groups`` (ceil(n/k)) but the remainder is spread one rank per
    group instead of piling into a short tail. Sizes differ by at most one —
    the property the device tier's ragged stripe layout relies on (stripe
    slots sized for the largest group waste at most one word per member)."""
    assert group_size >= 1 and n_ranks >= 1
    n_groups = -(-n_ranks // group_size)
    base, rem = divmod(n_ranks, n_groups)
    groups, start = [], 0
    for gi in range(n_groups):
        size = base + (1 if gi < rem else 0)
        groups.append(ParityGroup(tuple(range(start, start + size))))
        start += size
    return groups


_INFEASIBLE_WARNED: set[tuple] = set()


def domain_parity_groups(
    n_ranks: int,
    group_size: int,
    topology=None,
    level: str | None = None,
) -> list[ParityGroup]:
    """Parity groups that never put two members in one failure domain.

    Without a topology this is :func:`balanced_parity_groups`. With one, a
    greedy packer walks domains largest-first and drops each rank into the
    group with the most free capacity among groups that do not yet contain
    that domain (lowest index on ties) — guaranteed to succeed whenever the
    largest domain fits in the group count (max_domain_size <= ceil(n/k),
    since balanced capacities differ by at most one). A whole-domain loss
    then costs every affected group at most ONE member, i.e. any codec with
    tolerance >= 1 survives a rack burst.

    Infeasible topologies (one domain larger than the group count) degrade
    to best effort — the group with the fewest same-domain members wins —
    with a once-per-shape warning; :func:`placement_conflicts` reports the
    residual co-locations.
    """
    if topology is None:
        return balanced_parity_groups(n_ranks, group_size)
    assert topology.n_ranks >= n_ranks, (
        f"topology covers {topology.n_ranks} ranks, need {n_ranks}"
    )
    n_groups = -(-n_ranks // group_size)
    base, rem = divmod(n_ranks, n_groups)
    capacity = [base + (1 if gi < rem else 0) for gi in range(n_groups)]
    members: list[list[int]] = [[] for _ in range(n_groups)]
    group_domains: list[set[int]] = [set() for _ in range(n_groups)]

    by_domain: dict[int, list[int]] = {}
    for r in range(n_ranks):
        by_domain.setdefault(topology.domain_of(r, level), []).append(r)
    # Largest domains first: they have the fewest legal groups left late in
    # the packing, so they must claim group slots before small domains do.
    order = sorted(by_domain.items(), key=lambda kv: (-len(kv[1]), kv[0]))

    for dom, ranks in order:
        for r in sorted(ranks):
            free = [
                gi for gi in range(n_groups)
                if len(members[gi]) < capacity[gi] and dom not in group_domains[gi]
            ]
            if free:
                gi = max(free, key=lambda g: (capacity[g] - len(members[g]), -g))
            else:  # infeasible domain: minimize the co-location damage
                avail = [
                    gi for gi in range(n_groups)
                    if len(members[gi]) < capacity[gi]
                ]
                gi = min(
                    avail,
                    key=lambda g: (
                        sum(
                            1 for m in members[g]
                            if topology.domain_of(m, level) == dom
                        ),
                        len(members[g]) - capacity[g],
                        g,
                    ),
                )
                key = (n_ranks, group_size, topology.labels)
                if key not in _INFEASIBLE_WARNED:
                    _INFEASIBLE_WARNED.add(key)
                    warnings.warn(
                        f"domain {topology.domain_label(r, level)} has more "
                        f"members than the {n_groups} parity groups can "
                        f"separate; placement is best-effort "
                        f"(n={n_ranks}, k={group_size})",
                        stacklevel=2,
                    )
            members[gi].append(r)
            group_domains[gi].add(dom)
    return [ParityGroup(tuple(sorted(ms))) for ms in members]


def placement_conflicts(
    groups: list[ParityGroup], topology, level: str | None = None
) -> list[tuple[int, str, tuple[int, ...]]]:
    """Co-location violations: (group_index, domain_label, ranks) for every
    group holding two or more members of one failure domain. Empty for any
    feasible domain-aware placement — the property the tier-1 suite asserts."""
    out = []
    for gi, grp in enumerate(groups):
        by_dom: dict[int, list[int]] = {}
        for r in grp.members:
            by_dom.setdefault(topology.domain_of(r, level), []).append(r)
        for dom, rs in sorted(by_dom.items()):
            if len(rs) > 1:
                lv = level or topology.placement_level
                out.append((gi, f"{lv}:{dom}", tuple(rs)))
    return out


def blob_holder_group(n_groups: int, gi: int, b: int) -> int:
    """Holder group of group ``gi``'s redundancy blob ``b``: neighbor
    ``gi+1+b`` (wrapping, skipping ``gi`` itself unless it is the only group
    in the world). Encode routing, restore routing and the decode-rows
    precompute all derive from this one rule."""
    others = [(gi + 1 + t) % n_groups for t in range(n_groups)]
    others = [h for h in others if h != gi] or [gi]
    return others[b % len(others)]


def parity_recovery_plan(n_prev: int, failed: set[int], group_size: int) -> dict[int, int]:
    """Algorithm 4 for XOR parity-group mode: origin_prev_rank -> new_rank
    that reconstructs (or locally restores) its blocks. A thin wrapper over
    the codec layer's generic plan: one failure per group, and every stripe
    of the group's parity blob (on the next group, wrapping) intact; the
    lowest surviving member rebuilds, and a singleton group's stripe holder
    adopts its parity, which IS its snapshot."""
    from repro_torch.core.codec import XorCodec, codec_recovery_plan

    return codec_recovery_plan(n_prev, failed, XorCodec(group_size))
