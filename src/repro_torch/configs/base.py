"""ModelConfig: the fields of ``repro.configs.base.ModelConfig`` that the
train-state layout needs, with torch dtypes."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

LAYER_KINDS = ("attn", "local", "cross", "mamba")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    layer_pattern: tuple[str, ...] = ("attn",)
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu
    tie_embeddings: bool = False
    param_dtype: Any = torch.bfloat16
    sharding_preset: str = "tp"       # tp | fsdp
    optimizer_dtype: Any = torch.float32  # moments dtype

    def __post_init__(self) -> None:
        assert self.num_layers % len(self.layer_pattern) == 0, (
            f"{self.name}: {self.num_layers} layers not divisible by pattern "
            f"period {len(self.layer_pattern)}"
        )
        for k in self.layer_pattern:
            assert k in LAYER_KINDS, k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256 so the vocab dim shards
        evenly on any mesh axis."""
        return -(-self.vocab_size // 256) * 256

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's reduced())."""
        return replace(
            self,
            name=f"{self.name}-reduced",
            num_layers=len(self.layer_pattern),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            param_dtype=torch.float32,
            sharding_preset="tp",
        )
