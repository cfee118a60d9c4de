"""Snapshot distribution primitives (paper Algorithm 1) and parity groups.

The subset of ``repro.core.distribution`` the device tier needs, copied:
the scheme registry with ``pairwise``/``neighbor``/``mirror``, ``perm_pairs``
and ``inverse_perm`` (the rank permutations a partner copy travels along),
``parity_groups``/``group_of`` (the striped codecs' group partition) and
``blob_holder_group`` (where each group's redundancy blobs live). "Rank" is
an index along the redundancy axis of the virtual mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


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


def get_scheme(name: str) -> SchemeFn:
    return _SCHEMES[name]


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
