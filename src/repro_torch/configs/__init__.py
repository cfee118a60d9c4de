"""Architecture config registry: ``get_config(arch)`` / ``--arch`` ids, all
ten of the reference's, and the port's model builds every one of them."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, InputShape, applicability, runnable_cells

from repro_torch.configs.llama_3_2_vision_90b import CONFIG as _llama_vision_90b
from repro_torch.configs.llama3_2_1b import CONFIG as _llama32_1b
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2_2b
from repro_torch.configs.gemma_7b import CONFIG as _gemma_7b
from repro_torch.configs.granite_3_8b import CONFIG as _granite_3_8b
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral_8x7b
from repro_torch.configs.grok_1_314b import CONFIG as _grok_1_314b
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2_780m
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert_xlarge
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba_15_large

CONFIGS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _llama_vision_90b,
        _llama32_1b,
        _gemma2_2b,
        _gemma_7b,
        _granite_3_8b,
        _mixtral_8x7b,
        _grok_1_314b,
        _mamba2_780m,
        _hubert_xlarge,
        _jamba_15_large,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[name]


def list_archs() -> list[str]:
    return sorted(CONFIGS)


__all__ = [
    "ModelConfig",
    "InputShape",
    "SHAPES",
    "CONFIGS",
    "get_config",
    "list_archs",
    "applicability",
    "runnable_cells",
]
