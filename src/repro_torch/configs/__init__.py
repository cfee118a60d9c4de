"""Model configurations the port supports (``get_config(arch)``)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.llama3_2_1b import CONFIG as _llama32_1b

CONFIGS: dict[str, ModelConfig] = {c.name: c for c in (_llama32_1b,)}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(CONFIGS)}")
    return CONFIGS[name]


__all__ = ["ModelConfig", "CONFIGS", "get_config"]
