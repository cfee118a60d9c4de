"""Logical-axis -> mesh-axis rules, resolved against a virtual mesh (the
part of ``repro.sharding.axes`` the train-state and decode-session layouts
need). A spec is a tuple of per-dim entries (``None``, an axis name, or a
tuple of names) with trailing ``None``s trimmed, as ``tuple(PartitionSpec)``
gives."""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.sharding.mesh import VirtualMesh
from repro_torch.sharding.spec import ParamSpec
from repro_torch.utils.pytree import tree_map

AxisVal = Any  # str | tuple[str, ...] | None


@dataclass(frozen=True)
class ShardingRules:
    """Logical dim name -> mesh axes."""

    rules: dict[str, AxisVal] = field(default_factory=dict)

    def get(self, dim: str | None) -> AxisVal:
        if dim is None:
            return None
        return self.rules.get(dim, None)

    def override(self, **kw: AxisVal) -> "ShardingRules":
        return ShardingRules({**self.rules, **kw})


_COMMON = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "embed": None,
    "experts": None,
    "moe_group": ("pod", "data"),
    "ssm_heads": "model",
    "ssm_state": None,
    "ssm_inner": "model",
    "conv": None,
    "layers": None,
    "kv_seq": None,
    "vision": None,
}

TP_RULES = ShardingRules(dict(_COMMON))
FSDP_RULES = ShardingRules({**_COMMON, "embed": ("pod", "data")})

# Decode: the KV cache's sequence dim carries the memory; shard it over
# "model" and release kv_heads from "model" (one mesh axis may appear in at
# most one spec dim). With batch 1 the batch cannot shard at all, so the
# cache's sequence dim takes every axis.
DECODE_OVERRIDES = dict(kv_seq="model", kv_heads=None)
LONG_DECODE_OVERRIDES = dict(batch=None, kv_seq=("data", "model"), kv_heads=None)


def rules_for_shape(base: ShardingRules, shape_kind: str, global_batch: int) -> ShardingRules:
    """Per-input-shape rule adjustments (the reference's)."""
    if shape_kind == "decode":
        if global_batch == 1:
            return base.override(**LONG_DECODE_OVERRIDES)
        return base.override(**DECODE_OVERRIDES)
    return base


def resolve_axis(val: AxisVal, dim_size: int, mesh: VirtualMesh) -> AxisVal:
    """Drop mesh axes that don't exist or don't divide the dim."""
    if val is None:
        return None
    axes = (val,) if isinstance(val, str) else tuple(val)
    out = []
    prod = 1
    for a in axes:
        if a not in mesh.shape:
            continue
        sz = mesh.shape[a]
        if dim_size % (prod * sz) != 0 or dim_size < prod * sz:
            continue
        out.append(a)
        prod *= sz
    if not out:
        return None
    return out[0] if len(out) == 1 else tuple(out)


def _as_tuple(e: AxisVal) -> tuple[str, ...]:
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def _dedupe_entries(entries: list[AxisVal]) -> list[AxisVal]:
    """A mesh axis may appear in at most one spec dim; first (leftmost) wins."""
    used: set[str] = set()
    out: list[AxisVal] = []
    for e in entries:
        axes = [a for a in _as_tuple(e) if a not in used]
        used.update(axes)
        out.append(None if not axes else (axes[0] if len(axes) == 1 else tuple(axes)))
    return out


def _trim(entries: list[AxisVal]) -> tuple:
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def dims_to_pspec(dims: tuple, shape: tuple[int, ...], rules: ShardingRules, mesh: VirtualMesh) -> tuple:
    """The spec of a tensor with logical ``dims`` and ``shape`` (an input or
    activation's, or a ParamSpec's)."""
    entries = [resolve_axis(rules.get(dim), size, mesh) for size, dim in zip(shape, dims)]
    return _trim(_dedupe_entries(entries))


def spec_to_pspec(spec: ParamSpec, rules: ShardingRules, mesh: VirtualMesh) -> tuple:
    return dims_to_pspec(spec.dims, spec.shape, rules, mesh)


def tree_pspecs(tree: Any, rules: ShardingRules, mesh: VirtualMesh) -> Any:
    """:func:`spec_to_pspec` of every ParamSpec of a nested dict."""
    return tree_map(lambda s: spec_to_pspec(s, rules, mesh), tree)


def tree_shardings(tree: Any, rules: ShardingRules, mesh: VirtualMesh) -> Any:
    """The reference's ``tree_shardings``: a ``NamedSharding`` per leaf is
    XLA's placement of a global array over a device mesh, which means
    nothing to PyTorch. A leaf's sharding in the port is its spec (a
    :class:`VirtualMesh` stacks the coordinates, a ``ProcessMesh`` process
    holds its block), so this returns :func:`tree_pspecs`."""
    return tree_pspecs(tree, rules, mesh)


def zero1_pspec(spec: ParamSpec, rules: ShardingRules, mesh: VirtualMesh) -> tuple:
    """ZeRO-1 sharding for optimizer state: the param's spec with a
    still-replicated dim additionally sharded over the data axes (largest
    dividing combination wins), so every optimizer byte has one owner."""
    base = spec_to_pspec(spec, rules, mesh)
    entries = list(base) + [None] * (len(spec.shape) - len(base))
    used = {a for e in entries for a in _as_tuple(e)}
    data_ax = [a for a in ("pod", "data") if a in mesh.shape and a not in used]
    if not data_ax:
        return base
    combos: list[tuple[str, ...]] = []
    for rlen in range(len(data_ax), 0, -1):
        combos.extend(itertools.combinations(data_ax, rlen))
    combos.sort(key=lambda c: -int(np.prod([mesh.shape[a] for a in c])))
    rep_dims = sorted((i for i, e in enumerate(entries) if e is None), key=lambda i: -spec.shape[i])
    for i in rep_dims:
        for combo in combos:
            size = int(np.prod([mesh.shape[a] for a in combo]))
            if spec.shape[i] % size == 0 and spec.shape[i] >= size:
                entries[i] = combo[0] if len(combo) == 1 else combo
                return _trim(entries)
    return base


def tree_zero1_pspecs(tree: Any, rules: ShardingRules, mesh: VirtualMesh) -> Any:
    """:func:`zero1_pspec` of every ParamSpec of a nested dict."""
    return tree_map(lambda s: zero1_pspec(s, rules, mesh), tree)
