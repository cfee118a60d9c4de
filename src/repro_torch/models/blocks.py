"""One transformer-stack "slot": pre-norm attention + dense FFN. A period =
cfg.layer_pattern of slots; the model loops over periods with per-slot
parameters stacked.

Mamba and MoE slots (and cross-attention) wait for ROADMAP A10; each
raises ``NotImplementedError`` naming its item.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, mlp
from repro_torch.models.common import rmsnorm, rmsnorm_spec


def _dense_slot(cfg: ModelConfig, slot: int) -> str:
    kind = cfg.layer_pattern[slot]
    if kind == "mamba":
        raise NotImplementedError(f"{cfg.name}: Mamba-2 (SSM) slots wait for ROADMAP A10")
    if cfg.has_moe:
        raise NotImplementedError(f"{cfg.name}: MoE slots wait for ROADMAP A10")
    return kind


def block_specs(cfg: ModelConfig, slot: int) -> dict[str, Any]:
    kind = _dense_slot(cfg, slot)
    specs: dict[str, Any] = {"ln1": rmsnorm_spec(cfg.d_model)}
    specs["mixer"] = attention.abstract_params(cfg, cross=(kind == "cross"))
    if cfg.d_ff > 0:
        specs["ln2"] = rmsnorm_spec(cfg.d_model)
        specs["ffn"] = mlp.abstract_params(cfg)
    return specs


def apply_block(
    params: dict[str, Any],
    h: torch.Tensor,
    cfg: ModelConfig,
    slot: int,
    *,
    q_offset: int = 0,
) -> tuple[torch.Tensor, dict[str, Any], torch.Tensor]:
    """Full-sequence block application. Returns (h, cache_entry, moe_aux)."""
    kind = _dense_slot(cfg, slot)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    hin = rmsnorm(h, params["ln1"], cfg.norm_eps)
    mixed, cache = attention.apply(params["mixer"], hin, cfg, kind=kind, q_offset=q_offset)
    h = h + mixed

    if cfg.d_ff > 0:
        hin = rmsnorm(h, params["ln2"], cfg.norm_eps)
        h = h + mlp.apply(params["ffn"], hin, cfg)
    return h, cache, aux


def decode_block(
    params: dict[str, Any],
    h: torch.Tensor,
    cache: dict[str, Any],
    pos: torch.Tensor,
    cfg: ModelConfig,
    slot: int,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """One token through the slot; the slot's KV cache is written in place."""
    kind = _dense_slot(cfg, slot)
    hin = rmsnorm(h, params["ln1"], cfg.norm_eps)
    mixed, cache = attention.decode(params["mixer"], hin, cache, pos, cfg, kind=kind)
    h = h + mixed

    if cfg.d_ff > 0:
        hin = rmsnorm(h, params["ln2"], cfg.norm_eps)
        h = h + mlp.apply(params["ffn"], hin, cfg)
    return h, cache


def block_cache_spec(cfg: ModelConfig, slot: int, batch: int, max_seq: int) -> dict[str, Any]:
    return attention.decode_cache_spec(cfg, batch, max_seq, _dense_slot(cfg, slot))
