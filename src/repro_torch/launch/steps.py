"""Step functions, their inputs and the train-state layout.

``train_state_layout(cfg, mesh)`` gives the leaf paths, shapes, dtypes and
specs of the state that ``repro.launch.steps.build_step(cfg, "train_4k",
mesh)`` builds: ``params`` in ``cfg.param_dtype`` (f32 norms), the AdamW
``opt.master``/``opt.m``/``opt.v`` in f32 with ZeRO-1 specs, and an int32
``step`` scalar, under the model's rules (``moe_mode="ep"`` included). The
params' declaration is ``models/lm.py``'s.

``train_step`` is the one train step (loss, grads, AdamW in place): the
``Trainer``'s and ``build_step``'s. On a ``ProcessMesh`` (a ``ShardCtx``) the
loss runs under the context and the gradients are redistributed to the
optimizer master's placements before AdamW, the reference's ZeRO-1 step
(each process updates its 1/N of every leaf).

``build_step(cfg, shape_name, mesh)`` is the dry run's cell: the step
function of one input shape on the port's functions (train: loss, grads and
AdamW; prefill; serve: one decode token), its inputs as ``TensorSpec``
trees, their specs on the mesh, the rules and the model. ``input_specs``
gives the inputs alone.

``state_from_numpy``/``state_to_numpy`` carry numpy trees (the JAX
package's state) across bit for bit, and ``numpy_entity`` adapts an entity
with numpy payloads to the port's checkpoint engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import SHAPES, InputShape, ModelConfig
from repro_torch.data.synthetic import BATCH_DIMS
from repro_torch.models.common import ShardCtx
from repro_torch.models.lm import on_mesh
from repro_torch.models.model import Model, build_model
from repro_torch.optim.adamw import AdamWConfig, abstract_opt_state, adamw_update
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.sharding.axes import ShardingRules, dims_to_pspec, rules_for_shape, tree_pspecs, tree_zero1_pspecs
from repro_torch.sharding.mesh import VirtualMesh, resolve_device
from repro_torch.sharding.spec import ParamSpec, TensorSpec, draw_normal, init_std, specs_to_shape_dtype
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten


def train_step(model: Model, state: dict, batch: dict, hp: AdamWConfig, sched: Callable | None,
               ctx: ShardCtx | None = None) -> tuple:
    """One train step on the live ``state``, updated in place: the loss and
    its gradients through ``requires_grad`` aliases of the params (zeros
    for a leaf the loss does not read, as ``jax.grad`` gives), on a mesh
    each gradient redistributed to its ``opt.master`` leaf's placements
    (ZeRO-1: a reduce-scatter over the data axes), then AdamW. Returns
    (loss, metrics, AdamW's stats), undetached."""
    with on_mesh(ctx):
        paths, live = tree_flatten(state["params"])
        leaves = [p.detach().requires_grad_() for p in live]
        loss, metrics = model.loss(tree_unflatten(paths, leaves), batch, ctx=ctx)
        grads = list(torch.autograd.grad(loss, leaves, materialize_grads=True))
        if ctx is not None:
            masters = tree_flatten(state["opt"]["master"])[1]
            grads = [g.redistribute(m.device_mesh, m.placements) for g, m in zip(grads, masters)]
        stats = adamw_update(tree_unflatten(paths, grads), state["params"], state["opt"], state["step"], hp,
                             lr_schedule=sched)
    return loss, metrics, stats


@dataclass(frozen=True)
class StateLayout:
    sds: dict       # nested dict of TensorSpec
    pspecs: dict    # nested dict of spec tuples (same structure)
    params: dict    # nested dict of the params' ParamSpec (init rules)


def train_state_layout(cfg: ModelConfig, mesh: VirtualMesh) -> StateLayout:
    """Leaf shapes, dtypes and specs of the train state; allocates nothing.
    The rules are the model's for a train shape, as ``build_step`` takes
    them."""
    model = build_model(cfg)
    rules = rules_for_shape(model.rules, "train", SHAPES["train_4k"].global_batch)
    params = model.abstract_params
    opt = abstract_opt_state(params, cfg.optimizer_dtype)
    return StateLayout(
        sds={"params": specs_to_shape_dtype(params), "opt": specs_to_shape_dtype(opt),
             "step": TensorSpec((), torch.int32)},
        pspecs={
            "params": tree_pspecs(params, rules, mesh),
            "opt": {k: tree_zero1_pspecs(v, rules, mesh) for k, v in opt.items()},
            "step": (),
        },
        params=params,
    )


# ---------------------------------------------------------------------------
# Step functions of the dry run's cells
# ---------------------------------------------------------------------------

@dataclass
class StepBundle:
    """One (arch x shape x mesh) cell: the step, its inputs and their specs.
    ``args_sds`` are ``TensorSpec`` trees and ``in_pspecs``/``out_pspecs``
    spec-tuple trees of the same structure (``None`` where the reference
    leaves the output's sharding to the compiler); ``donate_argnums`` are
    the arguments the step updates in place."""

    name: str
    fn: Callable
    args_sds: tuple
    in_pspecs: tuple
    out_pspecs: Any
    model: Model
    rules: ShardingRules
    mesh: VirtualMesh
    donate_argnums: tuple = ()


def _batch_sds(cfg: ModelConfig, shape: InputShape) -> dict[str, TensorSpec]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder:
        return {
            "frames": TensorSpec((B, S, cfg.frontend_stub_dim), torch.float32),
            "labels": TensorSpec((B, S), torch.int32),
            "mask": TensorSpec((B, S), torch.bool),
        }
    out = {"tokens": TensorSpec((B, S), torch.int32), "labels": TensorSpec((B, S), torch.int32)}
    if cfg.vision_tokens:
        out["vision"] = TensorSpec((B, cfg.vision_tokens, cfg.frontend_stub_dim), torch.float32)
    return out


def _batch_pspecs(batch_sds: dict, rules: ShardingRules, mesh: VirtualMesh) -> dict:
    return {k: dims_to_pspec(BATCH_DIMS[k], v.shape, rules, mesh) for k, v in batch_sds.items()}


def input_specs(cfg: ModelConfig, shape_name: str) -> dict[str, Any]:
    """``TensorSpec`` stand-ins for every input of the shape's step (nothing
    allocated)."""
    shape = SHAPES[shape_name]
    model = build_model(cfg)
    params = specs_to_shape_dtype(model.abstract_params)
    if shape.kind == "train":
        return {
            "state": {
                "params": params,
                "opt": specs_to_shape_dtype(abstract_opt_state(model.abstract_params, cfg.optimizer_dtype)),
                "step": TensorSpec((), torch.int32),
            },
            "batch": _batch_sds(cfg, shape),
        }
    if shape.kind == "prefill":
        return {"params": params, "batch": _batch_sds(cfg, shape)}
    return {
        "params": params,
        "cache": specs_to_shape_dtype(model.abstract_cache(shape.global_batch, shape.seq_len)),
        "token": TensorSpec((shape.global_batch,), torch.int32),
        "pos": TensorSpec((), torch.int32),
    }


def build_step(cfg: ModelConfig, shape_name: str | InputShape, mesh: VirtualMesh) -> StepBundle:
    """The cell of ``(cfg, shape_name)`` on ``mesh``; an ``InputShape`` in
    place of the name is taken as it is (a probe batch)."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    model = build_model(cfg)
    rules = rules_for_shape(model.rules, shape.kind, shape.global_batch)
    p_specs = model.abstract_params
    params_ps = tree_pspecs(p_specs, rules, mesh)

    if shape.kind == "train":
        layout = train_state_layout(cfg, mesh)
        batch_sds = _batch_sds(cfg, shape)
        hp = AdamWConfig(lr=3e-4)
        sched = warmup_cosine(3e-4, 2000, 100_000)

        def step(state, batch):
            loss, _, _ = train_step(model, state, batch, hp, sched)
            return state, {"loss": loss.detach()}

        return StepBundle(
            name="train_step", fn=step,
            args_sds=(layout.sds, batch_sds),
            in_pspecs=(layout.pspecs, _batch_pspecs(batch_sds, rules, mesh)),
            out_pspecs=(layout.pspecs, None),
            model=model, rules=rules, mesh=mesh, donate_argnums=(0,),
        )

    if shape.kind == "prefill":
        batch_sds = _batch_sds(cfg, shape)

        def prefill_step(params, batch):
            return model.prefill(params, tokens=batch.get("tokens"), frames=batch.get("frames"),
                                 vision=batch.get("vision"))

        return StepBundle(
            name="prefill_step", fn=prefill_step,
            args_sds=(specs_to_shape_dtype(p_specs), batch_sds),
            in_pspecs=(params_ps, _batch_pspecs(batch_sds, rules, mesh)),
            out_pspecs=None, model=model, rules=rules, mesh=mesh,
        )

    # decode: one new token against a seq_len-deep cache
    cache_specs = model.abstract_cache(shape.global_batch, shape.seq_len)
    cache_ps = tree_pspecs(cache_specs, rules, mesh)

    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)

    return StepBundle(
        name="serve_step", fn=serve_step,
        args_sds=(specs_to_shape_dtype(p_specs), specs_to_shape_dtype(cache_specs),
                  TensorSpec((shape.global_batch,), torch.int32), TensorSpec((), torch.int32)),
        in_pspecs=(params_ps, cache_ps, dims_to_pspec(("batch",), (shape.global_batch,), rules, mesh), ()),
        out_pspecs=(None, cache_ps), model=model, rules=rules, mesh=mesh, donate_argnums=(1,),
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
