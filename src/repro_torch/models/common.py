"""Shared model building blocks: activation sharding, norms, RoPE,
softcap, the embedding's declaration, and the JAX package's dtype rule for
a two-operand einsum.

As in the reference, a ``ShardCtx`` (mesh + logical rules) is threaded
through the model, and ``constrain`` pins an activation's sharding at the
reference's call sites. With ``ctx=None`` (one card, and the CPU tests)
``constrain`` returns its input itself and the model computes what it
computes without a mesh. On a :class:`ProcessMesh` the params and the batch
are DTensors, every op runs on DTensors, and ``constrain`` redistributes
its input to the placements of the spec the rules give
(``sharding/mesh.py::placements``): the counterpart of
``with_sharding_constraint``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.sharding.axes import ShardingRules, dims_to_pspec
from repro_torch.sharding.spec import ParamSpec


@dataclass(frozen=True)
class ShardCtx:
    """Mesh + logical rules threaded through the model code for activation
    sharding constraints; ``None`` in its place means no constraints."""

    mesh: Any
    rules: ShardingRules


def constrain(x: torch.Tensor, ctx: ShardCtx | None, dims: tuple[str | None, ...]) -> torch.Tensor:
    """``x`` itself with ``ctx=None``; else ``x`` redistributed to the
    placements of ``dims`` under the rules on the mesh (a DTensor; a plain
    tensor counts as replicated, as each process holds it whole). A partial
    sum is reduced first where it is not a plain sum (the vocab-parallel
    embedding's masked partial goes to its shard through the replicated
    value)."""
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.sharding.mesh import placements

    mesh = ctx.mesh
    dm = mesh.device_mesh
    spec = dims_to_pspec(dims, tuple(x.shape), ctx.rules, mesh)
    target = placements(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim, run_check=False)
    if any(p.is_partial() and type(p) is not Partial for p in x.placements):
        x = x.redistribute(dm, [Replicate() if p.is_partial() and type(p) is not Partial else p
                                for p in x.placements])
    return x.redistribute(dm, target)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` of two operands: mixed dtypes promote (bf16 with f32
    gives f32) where ``torch.einsum`` would raise."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def no_sharding_rule(x: torch.Tensor, what: str) -> None:
    """Raise ``NotImplementedError`` where ``x`` is a DTensor: ``what`` has
    no DTensor sharding rule in the port, since no runtime path of the JAX
    package runs it on a mesh (its dry run compiles it, which the port
    accounts for on meta tensors), and the model never falls back to a
    replicated run in its place."""
    if hasattr(x, "device_mesh"):  # a DTensor
        raise NotImplementedError(f"{what} has no DTensor sharding rule on a ProcessMesh: no runtime path "
                                  f"runs it on a mesh (the dry run accounts for it on meta tensors)")


def local_blocks(*xs: Any) -> list[torch.Tensor]:
    """Each DTensor's block on this process, for a per-shard body that
    reads them all. The body's work is split on every mesh dim that shards
    one of them, so there each replicated input's gradient is a partial sum
    (``to_local``'s ``grad_placements``); on a dim that shards none every
    process does the same work and the gradient stays replicated."""
    from torch.distributed.tensor import Partial

    split = [any(not x.placements[i].is_replicate() for x in xs) for i in range(xs[0].device_mesh.ndim)]
    return [x.to_local(grad_placements=[Partial() if s and p.is_replicate() else p
                                        for p, s in zip(x.placements, split)]) for x in xs]


def from_block(block: torch.Tensor, like: Any, placements: Any, shape: tuple[int, ...]) -> Any:
    """A DTensor of global ``shape`` on ``like``'s mesh from this process's
    ``block`` under ``placements`` (no communication)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(block, like.device_mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), dtype=torch.float32, init="zeros")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # (1 + scale): zero-init scale == identity (gemma/llama convention).
    return (x * (1.0 + scale)).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device: Any = None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers. The
    two halves of head_dim rotate as pairs; angles in f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def embed_spec(vocab: int, d_model: int, dtype: Any) -> ParamSpec:
    return ParamSpec((vocab, d_model), ("vocab", "embed"), dtype=dtype, init="normal", scale=0.02)
