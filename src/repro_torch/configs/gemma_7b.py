"""gemma-7b [dense] — GeGLU, head_dim=256 [arXiv:2403.08295; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab_size=256_000,
    layer_pattern=("attn",),
    mlp_kind="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    scale_embed=True,
    norm_eps=1e-6,
    sharding_preset="tp",
)
