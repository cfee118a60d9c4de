"""llama-3.2-vision-90b [vlm] — 100L with interleaved cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Per the assignment the modality frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (vision_tokens x d_model after the projection the
stub owns); the backbone interleaves one cross-attention layer per period of 5
(100 layers = 80 self-attn + 20 cross-attn).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    layer_pattern=("attn", "attn", "attn", "attn", "cross"),
    mlp_kind="swiglu",
    rope_theta=500_000.0,
    vision_tokens=1600,       # precomputed patch embeddings (stub frontend)
    frontend_stub_dim=1280,   # stub patch-embedding width before projection
    sharding_preset="fsdp",
)
