"""ModelConfig: the fields of ``repro.configs.base.ModelConfig`` that the
train-state layout and the dense forward pass read, with torch dtypes.

The MoE, SSM and modality fields are carried so that a config which sets
them is recognised: the port's model declares dense decoders only, and
raises for the rest (ROADMAP A10)."""

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
    norm_eps: float = 1e-5
    rope_theta: float = 500_000.0
    sliding_window: int = 4096
    attn_softcap: float | None = None    # gemma2: 50.0
    final_softcap: float | None = None   # gemma2: 30.0, grok: 30.0
    tie_embeddings: bool = False
    scale_embed: bool = False            # gemma: h *= sqrt(d_model)

    # MoE, SSM and modality: 0 / False for the dense decoders the port runs
    num_experts: int = 0
    ssm_state: int = 0
    is_encoder: bool = False
    vision_tokens: int = 0
    frontend_stub_dim: int = 0

    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    sharding_preset: str = "tp"       # tp | fsdp
    remat: str = "full"               # none | full ("dots" is not ported)
    attn_chunk: int = 1024            # blockwise-attention query/KV chunk
    scan_layers: bool = True          # the reference's lax.scan; the port always loops
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

    @property
    def has_moe(self) -> bool:
        return self.num_experts > 0

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
            num_experts=min(self.num_experts, 4),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            vision_tokens=16 if self.vision_tokens else 0,
            frontend_stub_dim=32 if self.frontend_stub_dim else 0,
            sliding_window=32,
            attn_chunk=32,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
            sharding_preset="tp",
            remat="none",
        )
