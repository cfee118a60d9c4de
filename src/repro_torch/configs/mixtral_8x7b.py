"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    layer_pattern=("local",),  # SWA per the assignment
    sliding_window=4096,
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    num_experts=8,
    experts_per_tok=2,
    moe_every=1,
    sharding_preset="fsdp",
)
