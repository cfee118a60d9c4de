"""mamba2-780m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,           # unused (attention-free)
    d_ff=0,               # SSD block replaces the MLP (per the assignment d_ff=0)
    vocab_size=50_280,
    layer_pattern=("mamba",),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,       # d_inner = 3072 -> 48 SSD heads
    ssm_conv=4,
    tie_embeddings=True,
    sharding_preset="tp",
)
