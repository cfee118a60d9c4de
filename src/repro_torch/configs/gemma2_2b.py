"""gemma2-2b [dense] — local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    layer_pattern=("local", "attn"),  # alternating sliding-window / global
    sliding_window=4096,
    mlp_kind="geglu",
    rope_theta=10_000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    scale_embed=True,
    norm_eps=1e-6,
    sharding_preset="tp",
)
