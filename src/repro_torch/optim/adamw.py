"""AdamW with fp32 master weights, updating the live state in place.

The optimizer state is declared as a ParamSpec tree mirroring the params,
so the ZeRO-1 specs and the checkpoint engine treat it like any other
state. ``adamw_update`` keeps the reference's order of operations (clip by
the global norm, bias correction with ``b**t``, decoupled weight decay on
the master) and writes master, m, v, params and step **in place** into the
live tensors: ``ShardedStateEntity.restore_shards`` writes into the same
tensors, so a restore and the next step keep sharing them.

On a process mesh the leaves are DTensors: grads, master, m and v in the
ZeRO-1 placements, the params in theirs. The global norm is then the norm
of the whole tree over every shard (DTensor reduces each leaf's partial sum
over the processes that split it), so the clip factor is the reference's;
each param takes its new master value cast to its dtype and redistributed
to its own placements.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

from repro_torch.utils.pytree import tree_flatten, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def abstract_opt_state(param_specs: Any, moment_dtype: Any = torch.float32) -> dict[str, Any]:
    """ParamSpec trees for (master, m, v) mirroring the params' logical dims."""
    return {
        "master": tree_map(lambda s: replace(s, dtype=torch.float32, init="zeros"), param_specs),
        "m": tree_map(lambda s: replace(s, dtype=moment_dtype, init="zeros"), param_specs),
        "v": tree_map(lambda s: replace(s, dtype=moment_dtype, init="zeros"), param_specs),
    }


def init_opt_state(params: Any, moment_dtype: Any = torch.float32) -> dict[str, Any]:
    """Opt state from params: master is an f32 **copy** (never an alias, even
    of f32 params: the update and restores write both in place), m and v
    zeros."""
    return {
        "master": tree_map(lambda p: p.to(torch.float32, copy=True), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device), params),
    }


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [x.to(torch.float32).square().sum() for x in tree_flatten(tree)[1]]
    return torch.stack(leaves).sum().sqrt()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt on every device. The CPU's is MKL's
    vector sqrt, within 1 ulp but not correctly rounded, and on a loaded
    thread pool its result for the same input varied from call to call; the
    float64 root rounded once is the IEEE result that CUDA's sqrt gives."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


@torch.no_grad()
def adamw_update(
    grads: Any,
    params: Any,
    opt_state: dict[str, Any],
    step: torch.Tensor,
    hp: AdamWConfig,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> dict[str, torch.Tensor]:
    """One AdamW step from ``grads`` (the params' tree): writes the new
    master, m, v, params (master cast to each param's dtype) and ``step + 1``
    in place. Returns the stats ``grad_norm`` and ``lr``."""
    lr = lr_schedule(step) if lr_schedule is not None else torch.tensor(hp.lr, dtype=torch.float32, device=step.device)
    t = (step + 1).to(torch.float32)

    gnorm = global_norm(grads)
    clip = torch.clamp_max(hp.grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0) if hp.grad_clip > 0 else 1.0

    paths, flat_g = tree_flatten(grads)
    trees = (params, opt_state["m"], opt_state["v"], opt_state["master"])
    flat = []
    for tree in trees:
        p, leaves = tree_flatten(tree)
        if p != paths:
            raise ValueError("grads, params and opt state differ in structure")
        flat.append(leaves)
    for g, p, m, v, master in zip(flat_g, *flat):
        g = g.to(torch.float32) * clip
        m32, v32 = m.to(torch.float32), v.to(torch.float32)
        m_new = hp.b1 * m32 + (1.0 - hp.b1) * g
        v_new = hp.b2 * v32 + (1.0 - hp.b2) * g.square()
        mhat = m_new / (1.0 - hp.b1**t)
        vhat = v_new / (1.0 - hp.b2**t)
        delta = mhat / (_sqrt(vhat) + hp.eps) + hp.weight_decay * master
        master_new = master - lr * delta
        m.copy_(m_new)
        v.copy_(v_new)
        master.copy_(master_new)
        if hasattr(p, "placements"):  # a DTensor: the param's own placements
            master_new = master_new.to(p.dtype).redistribute(p.device_mesh, p.placements)
        p.copy_(master_new)
    step.add_(1)
    return {"grad_norm": gnorm, "lr": lr}
