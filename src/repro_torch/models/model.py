"""Model facade: bundles the config, the param and cache declarations, the
loss, prefill and the decode step.

The model is plain functions over a nested dict of tensors in the
reference's stacked-layer layout, not a tree of ``nn.Module``s: that layout
is what the shard plan, the manifests and the checkpoint bytes are keyed on.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.common import ShardCtx
from repro_torch.sharding.axes import FSDP_RULES, TP_RULES, ShardingRules
from repro_torch.sharding.mesh import resolve_device
from repro_torch.sharding.spec import init_tree, tree_count
from repro_torch.utils import threefry


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @cached_property
    def abstract_params(self) -> Any:
        return lm.abstract_params(self.cfg)

    def abstract_cache(self, batch: int, max_seq: int) -> Any:
        return lm.abstract_cache(self.cfg, batch, max_seq)

    @cached_property
    def n_params(self) -> int:
        return tree_count(self.abstract_params)

    @cached_property
    def n_active_params(self) -> int:
        return lm.active_param_count(self.cfg)

    @property
    def rules(self) -> ShardingRules:
        rules = FSDP_RULES if self.cfg.sharding_preset == "fsdp" else TP_RULES
        if self.cfg.moe_mode == "ep" and self.cfg.num_experts:
            # expert parallelism: the experts' dim shards over "data", so each
            # data coordinate owns whole experts (the plan and every shard
            # follow)
            rules = rules.override(experts="data")
        return rules

    def init(self, key: threefry.Key, device: Any = None) -> Any:
        """Params on ``device`` (``cuda`` unless the caller asks for another)
        from a threefry key, the reference's draws leaf for leaf."""
        return init_tree(key, self.abstract_params, resolve_device(device))

    def init_cache(self, batch: int, max_seq: int, device: Any = None) -> Any:
        """A zero decode cache on ``device`` (``cuda`` unless the caller asks
        for another)."""
        return init_tree(threefry.PRNGKey(0), self.abstract_cache(batch, max_seq), resolve_device(device))

    def loss(self, params: Any, batch: dict[str, torch.Tensor], ctx: ShardCtx | None = None):
        return lm.loss_fn(params, batch, self.cfg, ctx=ctx)

    def prefill(self, params: Any, tokens: torch.Tensor | None = None, frames: torch.Tensor | None = None,
                vision: torch.Tensor | None = None, ctx: ShardCtx | None = None):
        return lm.prefill(params, self.cfg, tokens=tokens, frames=frames, vision=vision, ctx=ctx)

    def decode_step(self, params: Any, cache: Any, token: torch.Tensor, pos: torch.Tensor,
                    ctx: ShardCtx | None = None):
        return lm.decode_step(params, cache, token, pos, self.cfg, ctx=ctx)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
