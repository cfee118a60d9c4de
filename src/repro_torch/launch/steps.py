"""Train-state layout and state conversion.

``train_state_layout(cfg, mesh)`` gives the leaf paths, shapes, dtypes and
specs of the state that ``repro.launch.steps.build_step(cfg, "train_4k",
mesh)`` builds: ``params`` in ``cfg.param_dtype`` (f32 norms), the AdamW
``opt.master``/``opt.m``/``opt.v`` in f32 with ZeRO-1 specs, and an int32
``step`` scalar. The model's forward pass is not part of this slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.axes import FSDP_RULES, TP_RULES, spec_to_pspec, zero1_pspec
from repro_torch.sharding.mesh import VirtualMesh, resolve_device
from repro_torch.sharding.spec import ParamSpec, stack_spec
from repro_torch.utils.pytree import tree_map


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one state leaf (``jax.ShapeDtypeStruct``'s role)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclass(frozen=True)
class StateLayout:
    sds: dict       # nested dict of TensorSpec
    pspecs: dict    # nested dict of spec tuples (same structure)
    params: dict    # nested dict of the params' ParamSpec (init rules)


def _attention_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, h, kv, hd, dt = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.param_dtype
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), dt),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"), dt),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"), dt),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"), dt),
    }


def _mlp_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d, f), ("embed", "mlp"), dt),
            "w_up": ParamSpec((d, f), ("embed", "mlp"), dt),
            "w_down": ParamSpec((f, d), ("mlp", "embed"), dt),
        }
    return {"w_in": ParamSpec((d, f), ("embed", "mlp"), dt), "w_out": ParamSpec((f, d), ("mlp", "embed"), dt)}


def _norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), torch.float32, init="norm")


def abstract_params(cfg: ModelConfig) -> dict[str, Any]:
    """Parameter declarations of a dense decoder (``repro.models.lm``'s
    ``abstract_params`` for attention layers with a dense MLP)."""
    if cfg.family != "dense" or any(k == "mamba" for k in cfg.layer_pattern):
        raise NotImplementedError(f"{cfg.name}: the port declares dense decoders only")
    p: dict[str, Any] = {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), cfg.param_dtype,
                           init="normal", scale=0.02),
        "final_norm": _norm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        p["head"] = ParamSpec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"), cfg.param_dtype)
    layers = {}
    for j in range(cfg.period):
        block = {"ln1": _norm_spec(cfg.d_model), "mixer": _attention_specs(cfg)}
        if cfg.d_ff > 0:
            block["ln2"] = _norm_spec(cfg.d_model)
            block["ffn"] = _mlp_specs(cfg)
        layers[f"slot{j}"] = tree_map(lambda s: stack_spec(s, cfg.num_periods), block)
    p["layers"] = layers
    return p


def train_state_layout(cfg: ModelConfig, mesh: VirtualMesh) -> StateLayout:
    """Leaf shapes, dtypes and specs of the train state; allocates nothing."""
    rules = FSDP_RULES if cfg.sharding_preset == "fsdp" else TP_RULES
    params = abstract_params(cfg)
    opt = {
        "master": tree_map(lambda s: replace(s, dtype=torch.float32), params),
        "m": tree_map(lambda s: replace(s, dtype=cfg.optimizer_dtype), params),
        "v": tree_map(lambda s: replace(s, dtype=cfg.optimizer_dtype), params),
    }

    def sds(tree):
        return tree_map(lambda s: TensorSpec(tuple(s.shape), s.dtype), tree)

    return StateLayout(
        sds={"params": sds(params), "opt": sds(opt), "step": TensorSpec((), torch.int32)},
        pspecs={
            "params": tree_map(lambda s: spec_to_pspec(s, rules, mesh), params),
            "opt": {k: tree_map(lambda s: zero1_pspec(s, rules, mesh), v) for k, v in opt.items()},
            "step": (),
        },
        params=params,
    )


def init_train_state(layout: StateLayout, mesh: VirtualMesh, generator: torch.Generator, device: Any = None) -> dict:
    """Random train state on ``device`` (the mesh's by default) from a seeded
    ``generator`` on that device: normal weights (fan-in scaled), norm scales
    near zero, ``master`` = the f32 value of the params, normal moments
    (``v`` non-negative), ``step`` = 0. Every leaf has non-trivial bytes, so a
    checkpoint round trip is a real test."""
    dev = resolve_device(mesh.device if device is None else device)
    if dev != mesh.device:
        raise ValueError(f"device {dev} differs from the mesh's {mesh.device}")

    def draw(shape, std: float, dtype) -> torch.Tensor:
        x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return x.mul_(std).to(dtype)

    def param(s: ParamSpec) -> torch.Tensor:
        if s.init == "fan_in":
            fan_in = max(int(np.prod(s.shape[:-1], dtype=np.int64)), 1) if len(s.shape) > 1 else s.shape[0]
            std = s.scale / math.sqrt(fan_in)
        else:  # "normal"; "norm" scales (zeros in the reference) get small noise
            std = s.scale if s.init == "normal" else 0.1
        return draw(s.shape, std, s.dtype)

    params = tree_map(param, layout.params)
    master = tree_map(lambda p: p.to(torch.float32), params)
    m = tree_map(lambda s: draw(s.shape, 1e-3, s.dtype), layout.sds["opt"]["m"])
    v = tree_map(lambda s: draw(s.shape, 1e-3, s.dtype).abs_(), layout.sds["opt"]["v"])
    return {
        "params": params,
        "opt": {"master": master, "m": m, "v": v},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


# ---------------------------------------------------------------------------
# State carried across from the JAX package (numpy trees), bit for bit
# ---------------------------------------------------------------------------

def _leaf_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # an owned copy; keeps 0-d arrays 0-d
    if a.dtype.name == "bfloat16":  # ml_dtypes: same bytes as torch.bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).view(torch.uint32).to(device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def state_from_numpy(tree: Any, device: Any = None) -> Any:
    """A nested dict of numpy arrays (ml_dtypes bf16 leaves included) as
    tensors on ``device``, bit for bit (bf16 through 16-bit integer views,
    never through float)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(np.asarray(a), dev), tree)


def state_to_numpy(tree: Any) -> Any:
    """The reverse of :func:`state_from_numpy`: numpy arrays, bf16 leaves as
    ml_dtypes ``bfloat16``."""
    return tree_map(_leaf_to_numpy, tree)
