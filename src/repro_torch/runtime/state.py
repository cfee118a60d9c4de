"""Train/serve state as distributed checkpoint entities (port of
``repro.runtime.state``).

``ShardedStateEntity`` adapts a live state (a nested dict of tensors, on the
card or the CPU) to the engine's DistributedEntity protocol: snapshot shards
are slices along each leaf's failure-domain (data-axis) dimension, the
per-host shards a real multi-host job would serialize. Leaves with no
data-sharded dim are replicated to every rank.

The slicing plan derives from the state's specs (``launch/steps.py``'s
``train_state_layout``), so the split dims are the ZeRO-1 data dims of the
production layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.serialization import LeafSlice
from repro_torch.sharding.mesh import axes_of, full_rank
from repro_torch.utils.pytree import Path, tree_flatten, tree_unflatten

DATA_AXES = ("pod", "data")


def _data_dim(pspec: tuple, ndim: int) -> int | None:
    """First dim sharded over a failure-domain axis, or None."""
    for i, e in enumerate(full_rank(pspec, ndim)):
        if any(a in DATA_AXES for a in axes_of(e)):
            return i
    return None


@dataclass
class ShardPlan:
    """Per-leaf split dimension (None = replicated) + global shapes."""

    dims: list[int | None]
    shapes: list[tuple[int, ...]]
    treedef: list[Path]   # leaf key paths, sorted-key order

    @classmethod
    def from_pspecs(cls, sds_tree: Any, pspec_tree: Any) -> "ShardPlan":
        paths, leaves = tree_flatten(sds_tree)
        ps_paths, pspecs = tree_flatten(pspec_tree)
        if ps_paths != paths:
            raise ValueError("the spec tree differs from the state tree")
        dims = [_data_dim(ps, len(sd.shape)) for sd, ps in zip(leaves, pspecs)]
        shapes = [tuple(int(s) for s in sd.shape) for sd in leaves]
        return cls(dims, shapes, paths)

    def split_dim(self, i: int, n_ranks: int) -> int | None:
        """Effective split dim for leaf i (None = replicated to every rank)."""
        d = self.dims[i]
        if d is None or self.shapes[i][d] % n_ranks != 0:
            return None
        return d

    def shard_coords(self, n_ranks: int) -> list[list[LeafSlice]]:
        """Global-coordinate manifest: per rank, each leaf's slice of the
        logical entity. ``axis`` records the leaf's failure-domain dim even
        when ``n_ranks`` does not divide it (the shard then holds the full
        range)."""
        out: list[list[LeafSlice]] = []
        for r in range(n_ranks):
            coords: list[LeafSlice] = []
            for i, shape in enumerate(self.shapes):
                d = self.dims[i]
                if d is None:
                    coords.append(LeafSlice(shape, None, 0, 1))
                    continue
                g = shape[d]
                if self.split_dim(i, n_ranks) is None:
                    coords.append(LeafSlice(shape, d, 0, g))
                else:
                    rows = g // n_ranks
                    coords.append(LeafSlice(shape, d, r * rows, (r + 1) * rows))
            out.append(coords)
        return out

    def leaves(self, tree: Any) -> list[Any]:
        paths, leaves = tree_flatten(tree)
        if paths != self.treedef:
            raise ValueError("tree does not match the plan's structure")
        return leaves


class ShardedStateEntity:
    """DistributedEntity over a live state returned by ``get_state``.

    ``snapshot_shards`` copies each leaf to the host once (card leaves: one
    device-to-host copy each; CPU leaves are read in place) and hands out
    views of it split along the data dim. ``restore_shards`` writes the
    restored shards back **in place** into the live tensors (the reference
    builds a new tree and calls a setter), so no second copy of the state is
    made on the card. Exposes ``shard_coords`` (the plan's global-coordinate
    manifest), which the engine attaches to each shard's manifest.
    """

    def __init__(self, get_state: Callable[[], Any], plan: ShardPlan) -> None:
        self._get = get_state
        self.plan = plan

    def shard_coords(self, n_ranks: int) -> list[list[LeafSlice]]:
        return self.plan.shard_coords(n_ranks)

    # -- snapshot ------------------------------------------------------------
    def snapshot_shards(self, n_ranks: int) -> list[Any]:
        leaves = self.plan.leaves(self._get())
        shard_leaves: list[list[torch.Tensor]] = [[] for _ in range(n_ranks)]
        for i, leaf in enumerate(leaves):
            a = leaf.detach().to("cpu")
            dim = self.plan.split_dim(i, n_ranks)
            pieces = [a] * n_ranks if dim is None else a.chunk(n_ranks, dim)
            for r in range(n_ranks):
                shard_leaves[r].append(pieces[r])
        return [tree_unflatten(self.plan.treedef, ls) for ls in shard_leaves]

    # -- partner exchange subset (paper §5.2.1: replicated data needs no
    #    exchange — only uniquely-owned leaves travel to the partner) --------
    def partner_payload(self, shard: Any, n_ranks: int) -> Any:
        leaves = self.plan.leaves(shard)
        return {
            str(i): leaves[i]
            for i in range(len(leaves))
            if self.plan.split_dim(i, n_ranks) is not None
        }

    def merge_payload(self, partner_subset: Any, survivor_full: Any, n_ranks: int) -> Any:
        """Rebuild a dead rank's payload: uniquely-owned leaves from the
        partner copy + replicated leaves from any survivor's own snapshot."""
        leaves = list(self.plan.leaves(survivor_full))
        for key, piece in partner_subset.items():
            leaves[int(key)] = piece
        return tree_unflatten(self.plan.treedef, leaves)

    # -- restore ---------------------------------------------------------
    def restore_shards(self, shards: dict[int, Any]) -> None:
        n = max(shards) + 1
        if set(shards) != set(range(n)):
            raise ValueError(f"missing origins: {sorted(shards)}")
        per_origin = [self.plan.leaves(shards[r]) for r in range(n)]
        live = self.plan.leaves(self._get())
        for i, target in enumerate(live):
            dim = self.plan.split_dim(i, n)
            with torch.no_grad():
                if dim is None:
                    target.copy_(per_origin[0][i])
                else:
                    for r, piece in enumerate(target.chunk(n, dim)):
                        piece.copy_(per_origin[r][i])


class RngEntity:
    """Host-side RNG seed/counter entity (replicated)."""

    def __init__(self) -> None:
        self.seed = 0
        self.counter = 0

    def snapshot(self):
        return {"seed": torch.tensor(self.seed, dtype=torch.int64),
                "counter": torch.tensor(self.counter, dtype=torch.int64)}

    def restore(self, snap):
        self.seed = int(snap["seed"])
        self.counter = int(snap["counter"])
