"""Reshard executor: apply a RepartitionPlan to recovered shard payloads
(port of ``repro.elastic.reshard``).

The host executor (``reshard_leaves``) slices and concatenates CPU tensors,
as the reference does with numpy. The card executor routes the row movement
through the row-gather kernel (``ops.gather_rows``, B6): the program that
builds each new rank's shard directly in device memory from the recovered
rows, which the engine has already unpacked onto the card.

Both are bit-exact: the tests hold them against each other and against the
reference leaf by leaf.
"""

from __future__ import annotations

import torch

from repro_torch.elastic.plan import RepartitionPlan, Segment
from repro_torch.kernels import ops


def _segments_by_leaf(plan: RepartitionPlan, j: int) -> dict[int, list[Segment]]:
    by_leaf: dict[int, list[Segment]] = {}
    for seg in plan.segments[j]:
        by_leaf.setdefault(seg.leaf, []).append(seg)
    return {i: sorted(segs, key=lambda s: s.dst_start) for i, segs in by_leaf.items()}


def reshard_leaves(
    plan: RepartitionPlan,
    payload_leaves: dict[int, list[torch.Tensor]],
    axes: list[int | None],
) -> list[list[torch.Tensor]]:
    """Build the M new shards' leaf lists from recovered origin leaf lists.

    ``payload_leaves[origin][leaf]`` — the recovered old-world shard tensors.
    ``axes[leaf]`` — the leaf's failure-domain dim (None = replicated; such a
    leaf is passed on by reference). Returns ``new_shards[new_rank][leaf]``.
    """
    out: list[list[torch.Tensor]] = []
    for j in range(plan.n_new):
        by_leaf = _segments_by_leaf(plan, j)
        leaves: list[torch.Tensor] = []
        for i in sorted(plan.targets[j]):
            segs = by_leaf.get(i, [])
            axis = axes[i]
            if axis is None:
                (seg,) = segs  # replicated leaf: a single full-copy segment
                leaves.append(payload_leaves[seg.origin][i])
                continue
            pieces = [payload_leaves[s.origin][i].narrow(axis, s.src_start, s.rows) for s in segs]
            leaves.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=axis))
        out.append(leaves)
    return out


# ---------------------------------------------------------------------------
# the card executor (B6)
# ---------------------------------------------------------------------------

def stack_rows(sources: dict[int, torch.Tensor], axis: int) -> tuple[torch.Tensor, dict[int, int], tuple[int, ...]]:
    """The sources stacked in origin order into one (rows, row_elems) matrix
    with ``axis`` leading: one copy (``torch.cat`` of the moved-axis views).
    Returns the matrix, each origin's first row in it, and the trailing
    shape of a row."""
    order = sorted(sources)
    base: dict[int, int] = {}
    off = 0
    for origin in order:
        base[origin] = off
        off += sources[origin].shape[axis]
    stacked = torch.cat([sources[o].movedim(axis, 0) for o in order])
    return stacked.reshape(stacked.shape[0], -1), base, tuple(stacked.shape[1:])


def segment_index(segments: list[Segment], base: dict[int, int]) -> torch.Tensor:
    """The plan's segments (in ``dst_start`` order) as a flat int32 row-index
    vector into the stacked matrix, on the CPU."""
    segs = sorted(segments, key=lambda s: s.dst_start)
    return torch.cat([
        torch.arange(s.src_start, s.src_start + s.rows, dtype=torch.int64) + base[s.origin] for s in segs
    ]).to(torch.int32)


def gather_leaf(stacked: torch.Tensor, idx: torch.Tensor, tail: tuple[int, ...], axis: int) -> torch.Tensor:
    """One new shard of a leaf: one ``ops.gather_rows`` call (B6 on the card),
    the rows reshaped and the axis moved back (a view)."""
    out = ops.gather_rows(stacked, idx)
    return out.reshape((idx.shape[0], *tail)).movedim(0, axis)


def reshard_leaf_device(sources: dict[int, torch.Tensor], segments: list[Segment], axis: int) -> torch.Tensor:
    """Row-gather path for one leaf of one new rank (the reference's
    signature): each source viewed as (rows, row_elems) with ``axis``
    leading, stacked into one matrix, the plan's segments flattened into a
    row-index vector, one gather. Returns a tensor on the sources' device."""
    stacked, base, tail = stack_rows(sources, axis)
    return gather_leaf(stacked, segment_index(segments, base), tail, axis)


def reshard_leaves_device(
    plan: RepartitionPlan,
    payload_leaves: dict[int, list[torch.Tensor]],
    axes: list[int | None],
) -> list[list[torch.Tensor]]:
    """``reshard_leaves`` through the row gather: the same new shards, built
    on the payloads' device. Where the reference's ``reshard_leaf_device``
    stacks a leaf's sources on every call, this stacks each leaf once and
    launches one gather per new rank from it (the same result); the stacked
    matrix is freed before the next leaf's. Replicated leaves are passed on
    by reference, as in ``reshard_leaves``."""
    out: list[list[torch.Tensor]] = [[] for _ in range(plan.n_new)]
    by_rank = [_segments_by_leaf(plan, j) for j in range(plan.n_new)]
    for i in sorted(plan.targets[0]):
        axis = axes[i]
        if axis is None:
            for j in range(plan.n_new):
                (seg,) = by_rank[j][i]
                out[j].append(payload_leaves[seg.origin][i])
            continue
        stacked, base, tail = stack_rows({o: leaves[i] for o, leaves in payload_leaves.items()}, axis)
        for j in range(plan.n_new):
            out[j].append(gather_leaf(stacked, segment_index(by_rank[j][i], base), tail, axis))
        del stacked
    return out
