"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab_size=131_072,
    layer_pattern=("attn",),
    mlp_kind="gelu",          # grok uses a gelu MLP inside experts
    rope_theta=10_000.0,
    final_softcap=30.0,       # grok tanh output softcap
    num_experts=8,
    experts_per_tok=2,
    moe_every=1,
    sharding_preset="fsdp",
)
