"""Declarative parameter specifications (shape, logical dim names, dtype)."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dims: tuple[str | None, ...]  # logical dim names; len == len(shape)
    dtype: Any = torch.bfloat16
    init: str = "fan_in"  # fan_in | normal | norm
    scale: float = 1.0

    def __post_init__(self) -> None:
        assert len(self.shape) == len(self.dims), (self.shape, self.dims)


def stack_spec(spec: ParamSpec, n: int) -> ParamSpec:
    """Add a leading stacked-layers dim (scan-over-layers parameters)."""
    return replace(spec, shape=(n, *spec.shape), dims=("layers", *spec.dims))

