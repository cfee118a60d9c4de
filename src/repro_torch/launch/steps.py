"""Train-state layout and state conversion.

``train_state_layout(cfg, mesh)`` gives the leaf paths, shapes, dtypes and
specs of the state that ``repro.launch.steps.build_step(cfg, "train_4k",
mesh)`` builds: ``params`` in ``cfg.param_dtype`` (f32 norms), the AdamW
``opt.master``/``opt.m``/``opt.v`` in f32 with ZeRO-1 specs, and an int32
``step`` scalar. The params' declaration is ``models/lm.py``'s.

``state_from_numpy``/``state_to_numpy`` carry numpy trees (the JAX
package's state) across bit for bit, and ``numpy_entity`` adapts an entity
with numpy payloads to the port's checkpoint engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import abstract_params
from repro_torch.optim.adamw import abstract_opt_state
from repro_torch.sharding.axes import FSDP_RULES, TP_RULES, spec_to_pspec, zero1_pspec
from repro_torch.sharding.mesh import VirtualMesh, resolve_device
from repro_torch.sharding.spec import ParamSpec, TensorSpec, draw_normal, init_std, specs_to_shape_dtype
from repro_torch.utils.pytree import tree_map


@dataclass(frozen=True)
class StateLayout:
    sds: dict       # nested dict of TensorSpec
    pspecs: dict    # nested dict of spec tuples (same structure)
    params: dict    # nested dict of the params' ParamSpec (init rules)


def train_state_layout(cfg: ModelConfig, mesh: VirtualMesh) -> StateLayout:
    """Leaf shapes, dtypes and specs of the train state; allocates nothing."""
    rules = FSDP_RULES if cfg.sharding_preset == "fsdp" else TP_RULES
    params = abstract_params(cfg)
    opt = abstract_opt_state(params, cfg.optimizer_dtype)

    return StateLayout(
        sds={"params": specs_to_shape_dtype(params), "opt": specs_to_shape_dtype(opt),
             "step": TensorSpec((), torch.int32)},
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
        return draw_normal(shape, std, dtype, generator, dev)

    def param(s: ParamSpec) -> torch.Tensor:
        # the model's init rule; constant norm scales get small noise instead
        std = init_std(s)
        return draw(s.shape, 0.1 if std is None else std, s.dtype)

    params = tree_map(param, layout.params)
    # copies even of f32 params: leaves never share storage (restores write
    # them in place)
    master = tree_map(lambda p: p.to(torch.float32, copy=True), params)
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


def numpy_entity(entity: Any) -> Any:
    """A checkpoint entity whose payloads are numpy trees (the JAX package's
    form: a ``DistributedEntity`` with ``snapshot_shards``/``restore_shards``
    and optionally ``partner_payload``/``merge_payload``, or a plain
    ``snapshot``/``restore`` one) as an entity of the port's engine: payloads
    cross as CPU tensors, bit for bit, in both directions. It exposes exactly
    the methods the wrapped entity has, since the engine dispatches on them."""
    if not hasattr(entity, "snapshot_shards"):
        return _NumpySnapshottable(entity)
    if hasattr(entity, "partner_payload"):
        return _NumpySubsetShards(entity)
    return _NumpyShards(entity)


def _cpu(tree: Any) -> Any:
    return state_from_numpy(tree, device="cpu")


class _NumpySnapshottable:
    def __init__(self, entity: Any) -> None:
        self.entity = entity

    def snapshot(self) -> Any:
        return _cpu(self.entity.snapshot())

    def restore(self, snap: Any) -> None:
        self.entity.restore(state_to_numpy(snap))


class _NumpyShards:
    def __init__(self, entity: Any) -> None:
        self.entity = entity

    def snapshot_shards(self, n_ranks: int) -> list[Any]:
        return [_cpu(s) for s in self.entity.snapshot_shards(n_ranks)]

    def restore_shards(self, shards: dict[int, Any]) -> None:
        self.entity.restore_shards({o: state_to_numpy(p) for o, p in shards.items()})


class _NumpySubsetShards(_NumpyShards):
    def partner_payload(self, shard: Any, n_ranks: int) -> Any:
        return _cpu(self.entity.partner_payload(state_to_numpy(shard), n_ranks))

    def merge_payload(self, partner_subset: Any, survivor_full: Any, n_ranks: int) -> Any:
        return _cpu(self.entity.merge_payload(state_to_numpy(partner_subset), state_to_numpy(survivor_full), n_ranks))
