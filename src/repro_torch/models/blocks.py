"""One stack "slot": pre-norm mixer (attn/local self-attention,
cross-attention over the projected vision stub, or a Mamba-2 SSD block) +
optional FFN (dense MLP or MoE). A period = cfg.layer_pattern of slots; the
model loops over periods with per-slot parameters stacked.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, mlp, moe, ssm
from repro_torch.models.common import ShardCtx, no_sharding_rule, rmsnorm, rmsnorm_spec


def slot_is_moe(cfg: ModelConfig, slot: int) -> bool:
    return cfg.has_moe and cfg.d_ff > 0 and (slot % cfg.moe_every == cfg.moe_every - 1)


def block_specs(cfg: ModelConfig, slot: int) -> dict[str, Any]:
    kind = cfg.layer_pattern[slot]
    specs: dict[str, Any] = {"ln1": rmsnorm_spec(cfg.d_model)}
    if kind == "mamba":
        specs["mixer"] = ssm.abstract_params(cfg)
    else:
        specs["mixer"] = attention.abstract_params(cfg, cross=(kind == "cross"))
    if cfg.d_ff > 0:
        specs["ln2"] = rmsnorm_spec(cfg.d_model)
        specs["ffn"] = moe.abstract_params(cfg) if slot_is_moe(cfg, slot) else mlp.abstract_params(cfg)
    return specs


def apply_block(
    params: dict[str, Any],
    h: torch.Tensor,
    cfg: ModelConfig,
    slot: int,
    *,
    vision_kv: torch.Tensor | None = None,
    q_offset: int = 0,
    ctx: ShardCtx | None = None,
) -> tuple[torch.Tensor, dict[str, Any], torch.Tensor]:
    """Full-sequence block application; a "cross" slot attends to
    ``vision_kv``. Returns (h, cache_entry, moe_aux)."""
    kind = cfg.layer_pattern[slot]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    hin = rmsnorm(h, params["ln1"], cfg.norm_eps)
    if kind == "mamba":
        mixed, cache = ssm.apply(params["mixer"], hin, cfg, ctx=ctx)
    else:
        mixed, cache = attention.apply(params["mixer"], hin, cfg, kind=kind,
                                       kv_src=vision_kv if kind == "cross" else None, q_offset=q_offset, ctx=ctx)
    h = h + mixed

    if cfg.d_ff > 0:
        hin = rmsnorm(h, params["ln2"], cfg.norm_eps)
        if slot_is_moe(cfg, slot):
            out, aux = moe.apply(params["ffn"], hin, cfg, ctx=ctx)
        else:
            out = mlp.apply(params["ffn"], hin, cfg, ctx=ctx)
        h = h + out
    return h, cache, aux


def decode_block(
    params: dict[str, Any],
    h: torch.Tensor,
    cache: dict[str, Any],
    pos: torch.Tensor,
    cfg: ModelConfig,
    slot: int,
    *,
    ctx: ShardCtx | None = None,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """One token through the slot; the slot's cache (k/v, or the SSM's conv
    history and state) is written in place."""
    if slot_is_moe(cfg, slot):
        no_sharding_rule(h, "MoE in decode (one routing group over the batch)")
    kind = cfg.layer_pattern[slot]
    hin = rmsnorm(h, params["ln1"], cfg.norm_eps)
    if kind == "mamba":
        mixed, cache = ssm.decode(params["mixer"], hin, cache, cfg, ctx=ctx)
    else:
        mixed, cache = attention.decode(params["mixer"], hin, cache, pos, cfg, kind=kind, ctx=ctx)
    h = h + mixed

    if cfg.d_ff > 0:
        hin = rmsnorm(h, params["ln2"], cfg.norm_eps)
        if slot_is_moe(cfg, slot):
            out, _ = moe.apply(params["ffn"], hin, cfg, ctx=ctx, num_groups=1)
        else:
            out = mlp.apply(params["ffn"], hin, cfg, ctx=ctx)
        h = h + out
    return h, cache


def block_cache_spec(cfg: ModelConfig, slot: int, batch: int, max_seq: int) -> dict[str, Any]:
    kind = cfg.layer_pattern[slot]
    if kind == "mamba":
        return ssm.cache_spec(cfg, batch)
    return attention.decode_cache_spec(cfg, batch, max_seq, kind)
