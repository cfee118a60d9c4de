"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer [arXiv:2403.19887; hf].

Adaptation note (the reference's, see DESIGN.md): Jamba's SSM layers are
Mamba-1; the model reuses the Mamba2 SSD block (chunked dual form) with a
reduced state size, a changed assumption.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    # 1 attention layer per 8 (1:7 attn:mamba), attention at slot 3 of each period.
    layer_pattern=("mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba"),
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    num_experts=16,
    experts_per_tok=2,
    moe_every=2,            # MoE replaces the dense MLP in every 2nd layer
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,         # d_inner = 16384 -> 256 SSD heads
    ssm_conv=4,
    sharding_preset="fsdp",
)
