"""Declarative parameter specifications (shape, logical dim names, dtype,
init rule) and what derives from them: initialization (``init_tree``),
shape/dtype stand-ins (``specs_to_shape_dtype``) and parameter counting
(``tree_count``)."""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from repro_torch.utils import threefry
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dims: tuple[str | None, ...]  # logical dim names; len == len(shape)
    dtype: Any = torch.bfloat16
    init: str = "fan_in"  # fan_in | normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self) -> None:
        assert len(self.shape) == len(self.dims), (self.shape, self.dims)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one state leaf (``jax.ShapeDtypeStruct``'s role)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def specs_to_shape_dtype(tree: Any) -> Any:
    """ParamSpec tree -> TensorSpec tree (stand-ins that allocate nothing)."""
    return tree_map(lambda s: TensorSpec(tuple(s.shape), s.dtype), tree)


def stack_spec(spec: ParamSpec, n: int) -> ParamSpec:
    """Add a leading stacked-layers dim (scan-over-layers parameters)."""
    return replace(spec, shape=(n, *spec.shape), dims=("layers", *spec.dims))


def stack_tree(tree: Any, n: int) -> Any:
    return tree_map(lambda s: stack_spec(s, n), tree)


def init_std(spec: ParamSpec) -> float | None:
    """The standard deviation of a leaf's normal draw; None for the constant
    inits (``zeros``, ``ones``). ``fan_in``: the product of every dim but
    the last (output) one."""
    if spec.init in ("zeros", "ones"):
        return None
    if spec.init == "normal":
        return spec.scale
    if spec.init == "fan_in":
        fan_in = max(int(np.prod(spec.shape[:-1], dtype=np.int64)), 1) if len(spec.shape) > 1 else spec.shape[0]
        return spec.scale / math.sqrt(fan_in)
    raise ValueError(f"unknown init {spec.init}")


def draw_normal(shape, std: float, dtype, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """``std`` times a standard normal draw in f32, cast to ``dtype``."""
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


def init_leaf(spec: ParamSpec, key: threefry.Key, device: torch.device) -> torch.Tensor:
    """One leaf on ``device``: the reference's ``std · normal(key)`` in f32,
    cast to the leaf's dtype, or its constant."""
    std = init_std(spec)
    if std is None:
        fill = torch.zeros if spec.init == "zeros" else torch.ones
        return fill(spec.shape, dtype=spec.dtype, device=device)
    x = threefry.normal(key, spec.shape, device)
    return x.mul_(torch.tensor(std, dtype=torch.float32, device=device)).to(spec.dtype)


def init_tree(key: threefry.Key, tree: Any, device: Any = "cpu") -> Any:
    """Initialize a ParamSpec tree into tensors on ``device`` as the
    reference does: one key per leaf, ``split`` from ``key`` in sorted-path
    order, each leaf drawn on the device that holds it."""
    dev = torch.device(device)
    paths, specs = tree_flatten(tree)
    keys = threefry.split(key, len(specs))
    return tree_unflatten(paths, [init_leaf(s, k, dev) for s, k in zip(specs, keys)])


def tree_count(tree: Any) -> int:
    """Total parameter count of a ParamSpec tree."""
    return sum(s.size for s in tree_flatten(tree)[1])
