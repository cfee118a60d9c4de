"""ModelConfig: one dataclass covering all ten architecture families (the
fields of ``repro.configs.base.ModelConfig``, with torch dtypes).

The port's model runs every family: dense, MoE, Mamba-2 (SSM), the hybrid
pattern, the encoder and the VLM. The modality fields (``is_encoder``,
``vision_tokens``, ``frontend_stub_dim``) select the encoder's frame inputs
and the VLM's vision stub and cross-attention slots. ``moe_mode`` picks the expert weights' layout
(``"ep"`` shards the experts' dim over ``data``), which the shard plan, every
rank's shards and the manifests follow. ``fsdp_gather_per_layer`` is the
reference's GSPMD knob: inert on one card, carried so that ``replace()``
calls written for the reference work."""

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

    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_every: int = 1  # MoE replaces the dense MLP in every k-th layer
    moe_capacity_factor: float = 1.25  # >= num_experts/experts_per_tok -> dropless

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4

    # Modality
    is_encoder: bool = False          # encoder-only: no decode step
    vision_tokens: int = 0            # >0: cross-attn layers attend to a vision stub
    frontend_stub_dim: int = 0        # >0: inputs are precomputed frame/patch embeds

    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    sharding_preset: str = "tp"       # tp | fsdp
    moe_mode: str = "tp"              # tp | ep: ep shards the experts' dim over "data"
    fsdp_gather_per_layer: bool = True  # the reference's GSPMD option; inert here
    remat: str = "full"               # none | full | dots
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
    def attention_free(self) -> bool:
        return all(k == "mamba" for k in self.layer_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if prefill/decode memory does not grow quadratically in
        seq_len: SSM and hybrid (mostly-SSM) stacks; the long_500k
        applicability rule reads it."""
        n_attn = sum(k in ("attn", "local", "cross") for k in self.layer_pattern)
        return n_attn == 0 or (self.family in ("ssm", "hybrid"))

    @property
    def has_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    def with_(self, **kw: Any) -> "ModelConfig":
        return replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's reduced())."""
        period = len(self.layer_pattern)
        return replace(
            self,
            name=f"{self.name}-reduced",
            num_layers=period,  # one full period
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            vision_tokens=16 if self.vision_tokens else 0,
            frontend_stub_dim=32 if self.frontend_stub_dim else 0,
            sliding_window=32,
            attn_chunk=32,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
            sharding_preset="tp",
            remat="none",
        )
