"""Shared model building blocks: norms, RoPE, softcap, the embedding's
declaration, and the JAX package's dtype rule for a two-operand einsum.

The reference threads a ``ShardCtx`` (mesh + logical rules) through the
model and pins activation shardings with ``constrain``. On one card there
is no mesh to constrain to, so the port has neither: every function here
and in the model modules takes the same arguments less ``ctx``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.sharding.spec import ParamSpec


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` of two operands: mixed dtypes promote (bf16 with f32
    gives f32) where ``torch.einsum`` would raise."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


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
