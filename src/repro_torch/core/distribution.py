"""Snapshot distribution and recovery assignment (paper Algorithms 1 and 4)
and parity groups.

The subset of ``repro.core.distribution`` the device tier and the host
engine need, copied: the scheme registry with ``pairwise``/``neighbor``/
``mirror``, ``multi_copy_shifts``, ``perm_pairs`` and ``inverse_perm`` (the
rank permutations a partner copy travels along), Algorithm 4's
``recovery_plan`` with ``DataLostError``, ``parity_groups``/``group_of``
(the striped codecs' group partition) and ``blob_holder_group`` (where each
group's redundancy blobs live). "Rank" is a failure-domain index: a host of
the engine, or a coordinate of the virtual mesh's redundancy axis.
"""

from __future__ import annotations

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


def blob_holder_group(n_groups: int, gi: int, b: int) -> int:
    """Holder group of group ``gi``'s redundancy blob ``b``: neighbor
    ``gi+1+b`` (wrapping, skipping ``gi`` itself unless it is the only group
    in the world). Encode routing, restore routing and the decode-rows
    precompute all derive from this one rule."""
    others = [(gi + 1 + t) % n_groups for t in range(n_groups)]
    others = [h for h in others if h != gi] or [gi]
    return others[b % len(others)]
