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
    """Raise ``NotImplementedError`` (ROADMAP A15) where ``x`` is a DTensor:
    ``what`` has no DTensor sharding rule in the port, and the model never
    falls back to a replicated run in its place."""
    if hasattr(x, "device_mesh"):  # a DTensor
        raise NotImplementedError(f"{what} has no DTensor sharding rule on a ProcessMesh (ROADMAP A15)")


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
