"""Model facade: bundles the config, the param declarations and the loss.

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

    @cached_property
    def n_params(self) -> int:
        return tree_count(self.abstract_params)

    @property
    def rules(self) -> ShardingRules:
        return FSDP_RULES if self.cfg.sharding_preset == "fsdp" else TP_RULES

    def init(self, key: threefry.Key, device: Any = None) -> Any:
        """Params on ``device`` (``cuda`` unless the caller asks for another)
        from a threefry key, the reference's draws leaf for leaf."""
        return init_tree(key, self.abstract_params, resolve_device(device))

    def loss(self, params: Any, batch: dict[str, torch.Tensor]):
        return lm.loss_fn(params, batch, self.cfg)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
