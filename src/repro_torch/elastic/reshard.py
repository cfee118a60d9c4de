"""Reshard executor: apply a RepartitionPlan to recovered shard payloads
(port of ``repro.elastic.reshard``).

The host executor (``reshard_leaves``) slices and concatenates CPU tensors,
as the reference does with numpy. The card executor routes the row movement
through the run-table copy (B6, ``kernels/reshard.py``): each new shard of a
split leaf is one launch that reads the origin shards where the engine
unpacked them on the card and writes the new shard in the leaf's own layout.
The reference stacks a leaf's origin shards into one matrix first, because
its Pallas gather takes one array; the kernel here takes addresses, so
nothing is stacked.

Both are bit-exact: the tests hold them against each other and against the
reference leaf by leaf.
"""

from __future__ import annotations

import math

import torch

from repro_torch.elastic.plan import RepartitionPlan, Segment
from repro_torch.kernels import reshard as rk


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

def leaf_runs(sources: dict[int, torch.Tensor], segments: list[Segment], axis: int
              ) -> tuple[torch.Tensor, list[int], tuple[int, ...]]:
    """The run table that builds one new shard of a split leaf from its
    origin shards in place. Viewed as (outer, rows, inner) around ``axis``,
    a plan segment is one strided run: per outer slice, ``rows x inner``
    contiguous elements in its origin and in the new shard. A run whose
    slices lie back to back on both sides is one contiguous run, and
    contiguous runs that continue each other merge. Returns the table
    (source numbers index the origins in sorted order), that order, and the
    new shard's shape. A few runs per leaf: built in plain Python, which
    costs less than array operations at this size."""
    order = sorted(sources)
    first = sources[order[0]]
    outer, inner = math.prod(first.shape[:axis]), math.prod(first.shape[axis + 1 :])
    row = inner * first.element_size()
    segs = sorted((s for s in segments if s.rows > 0), key=lambda s: s.dst_start)
    rows_new = sum(s.rows for s in segs)
    new_step = rows_new * row
    runs: list[list[int]] = []
    for s in segs if outer and row else ():
        k, nbytes, src_step = order.index(s.origin), s.rows * row, sources[s.origin].shape[axis] * row
        run = [k, s.src_start * row, s.dst_start * row, nbytes, outer, src_step, new_step]
        if outer == 1 or src_step == new_step == nbytes:
            run[3:] = [nbytes * outer, 1, 0, 0]
            last = runs[-1] if runs else None
            if (last is not None and last[4] == 1 and last[0] == k and last[1] + last[3] == run[1]
                    and last[2] + last[3] == run[2]):
                last[3] += run[3]
                continue
        runs.append(run)
    shape = (*first.shape[:axis], rows_new, *first.shape[axis + 1 :])
    return torch.tensor(runs, dtype=torch.int64).reshape(-1, len(rk.COLUMNS)), order, shape


def reshard_leaf_device(sources: dict[int, torch.Tensor], segments: list[Segment], axis: int) -> torch.Tensor:
    """One new shard of one split leaf (the reference's signature): one
    launch of the run-table copy over ``leaf_runs``, reading the origin
    shards in place, writing a contiguous tensor on their device."""
    table, order, shape = leaf_runs(sources, segments, axis)
    first = sources[order[0]]
    out = torch.empty(shape, dtype=first.dtype, device=first.device)
    return rk.copy_runs_into([sources[o].contiguous() for o in order], out, table)


def reshard_leaves_device(
    plan: RepartitionPlan,
    payload_leaves: dict[int, list[torch.Tensor]],
    axes: list[int | None],
) -> list[list[torch.Tensor]]:
    """``reshard_leaves`` through the run-table copy: the same new shards,
    built on the payloads' device, one launch per split leaf per new rank.
    The new shards are views of one allocation, 256-byte aligned: one
    request to the card's allocator, where one per shard cost a fresh
    device allocation each. Replicated leaves are passed on by reference,
    as in ``reshard_leaves``."""
    out: list[list[torch.Tensor | None]] = [[] for _ in range(plan.n_new)]
    by_rank = [_segments_by_leaf(plan, j) for j in range(plan.n_new)]
    jobs, size = [], 0
    for i in sorted(plan.targets[0]):
        sources = {o: leaves[i] for o, leaves in payload_leaves.items()}
        for j in range(plan.n_new):
            if axes[i] is None:
                (seg,) = by_rank[j][i]
                out[j].append(sources[seg.origin])
                continue
            table, order, shape = leaf_runs(sources, by_rank[j][i], axes[i])
            first = sources[order[0]]
            jobs.append((j, len(out[j]), [sources[o].contiguous() for o in order], table, shape, first.dtype, size))
            size += -(-math.prod(shape) * first.element_size() // 256) * 256
            out[j].append(None)
    if jobs:
        buffer = torch.empty(size, dtype=torch.uint8, device=jobs[0][2][0].device)
        for j, at, sources, table, shape, dtype, offset in jobs:
            nbytes = math.prod(shape) * sources[0].element_size()
            new = buffer[offset : offset + nbytes].view(dtype).view(shape)
            out[j][at] = rk.copy_runs_into(sources, new, table)
    return out
