"""Dense MLP variants: SwiGLU (llama/granite/mixtral), GeGLU (gemma), GELU."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ShardCtx, constrain, einsum
from repro_torch.sharding.spec import ParamSpec


def abstract_params(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d, f), ("embed", "mlp"), dtype=dt),
            "w_up": ParamSpec((d, f), ("embed", "mlp"), dtype=dt),
            "w_down": ParamSpec((f, d), ("mlp", "embed"), dtype=dt),
        }
    return {
        "w_in": ParamSpec((d, f), ("embed", "mlp"), dtype=dt),
        "w_out": ParamSpec((f, d), ("mlp", "embed"), dtype=dt),
    }


def _act(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu(approximate=True)


def apply(params: dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
          ctx: ShardCtx | None = None) -> torch.Tensor:
    if cfg.mlp_kind in ("swiglu", "geglu"):
        g = einsum("...d,df->...f", x, params["w_gate"])
        u = einsum("...d,df->...f", x, params["w_up"])
        h = _act(cfg.mlp_kind, g) * u
    else:
        h = _act("gelu", einsum("...d,df->...f", x, params["w_in"]))
    h = constrain(h, ctx, ("batch", "seq", "mlp"))
    w_out = params["w_down"] if "w_down" in params else params["w_out"]
    out = einsum("...f,fd->...d", h, w_out)
    return constrain(out, ctx, ("batch", "seq", "act_embed"))
