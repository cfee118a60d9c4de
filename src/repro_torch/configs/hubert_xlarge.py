"""hubert-xlarge [audio] — encoder-only transformer backbone (w2v2-style)
[arXiv:2106.07447; unverified].

The conv waveform frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings of width ``frontend_stub_dim``; the
backbone owns only the input projection + encoder stack + masked-prediction
head over the 504-codebook vocab.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    layer_pattern=("attn",),
    mlp_kind="gelu",
    rope_theta=10_000.0,
    is_encoder=True,
    frontend_stub_dim=512,  # conv-frontend output width (stubbed)
    sharding_preset="tp",
)
