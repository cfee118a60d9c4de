"""Mamba2 SSD (state-space duality) block (port of ``repro.models.ssm``):
the chunked dual form for train and prefill, the O(1)-state recurrence for
decode.

The chunked form is the reference's: intra-chunk quadratic einsums with a
masked decay matrix, then the inter-chunk recurrence over chunk states,
which the reference runs as a ``lax.scan`` and the port as a loop over the
chunks (it emits the state *entering* each chunk). The JAX package runs no
Pallas kernel here, and the port adds none.

The decay matrix masks ``seg`` to -inf before the ``exp`` (the reference
masks after it). The values are the same, and the backward stays finite:
above the diagonal ``seg`` is a sum of ``-dt·A`` over up to ``CHUNK``
positions, which at full width can exceed f32's ``exp`` range, and
``where(mask, exp(seg), 0)`` would then carry ``0·inf`` into the gradient.

The within-chunk cumulative sum of ``dt·A`` is a product with a
lower-triangular matrix of ones: ``torch.cumsum`` of a float tensor has no
deterministic form on the card, and the bitwise replays need one.

Decode writes the new ``conv`` history and ``state`` into the cache **in
place** (``copy_``) and returns the same tree, as attention's decode does
with k/v: ``lm.decode_step`` hands each layer views of the stacked leaves.

On a ``ProcessMesh`` the forward runs per shard where DTensor's own rules
would gather: the causal conv on each process's channels
(``_conv_per_shard``), then the SSD on each process's batch rows and heads
(``_ssd_per_shard``); the projections and the gated norm stay DTensor ops.
Decode on a DTensor raises: no runtime path runs it on a mesh.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ShardCtx, constrain, einsum, from_block, local_blocks, no_sharding_rule
from repro_torch.sharding.spec import ParamSpec

CHUNK = 128


def conv_dim(cfg: ModelConfig) -> int:
    # x (d_inner) + B (N) + C (N), single SSD group.
    return cfg.d_inner + 2 * cfg.ssm_state


def in_proj_dim(cfg: ModelConfig) -> int:
    # z (d_inner) + xBC (conv_dim) + dt (heads)
    return cfg.d_inner + conv_dim(cfg) + cfg.ssm_heads


def abstract_params(cfg: ModelConfig) -> dict[str, ParamSpec]:
    # in_proj split into z / xBC / dt projections, as the reference declares it
    d, dt = cfg.d_model, cfg.param_dtype
    H = cfg.ssm_heads
    f32 = torch.float32
    return {
        "z_proj": ParamSpec((d, cfg.d_inner), ("embed", "ssm_inner"), dtype=dt),
        "xBC_proj": ParamSpec((d, conv_dim(cfg)), ("embed", "ssm_inner"), dtype=dt),
        "dt_proj": ParamSpec((d, H), ("embed", "ssm_heads"), dtype=dt),
        "conv_w": ParamSpec((conv_dim(cfg), cfg.ssm_conv), ("ssm_inner", "conv"), dtype=dt, init="normal", scale=0.1),
        "conv_b": ParamSpec((conv_dim(cfg),), ("ssm_inner",), dtype=f32, init="zeros"),
        "A_log": ParamSpec((H,), ("ssm_heads",), dtype=f32, init="zeros"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), dtype=f32, init="zeros"),
        "D": ParamSpec((H,), ("ssm_heads",), dtype=f32, init="ones"),
        "norm": ParamSpec((cfg.d_inner,), ("ssm_inner",), dtype=f32, init="zeros"),
        "out_proj": ParamSpec((cfg.d_inner, d), ("ssm_inner", "embed"), dtype=dt),
    }


def cache_spec(cfg: ModelConfig, batch: int) -> dict[str, ParamSpec]:
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    return {
        "conv": ParamSpec((batch, cfg.ssm_conv - 1, conv_dim(cfg)), ("batch", None, "ssm_inner"),
                          dtype=cfg.compute_dtype, init="zeros"),
        "state": ParamSpec((batch, H, P, N), ("batch", "ssm_heads", None, None), dtype=torch.float32, init="zeros"),
    }


def _project(params: dict[str, torch.Tensor], x: torch.Tensor):
    z = einsum("...d,de->...e", x, params["z_proj"])
    xBC = einsum("...d,de->...e", x, params["xBC_proj"])
    dt = einsum("...d,de->...e", x, params["dt_proj"])
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv along seq. xBC: (B, L, C); w: (C, K)."""
    B, L, C = xBC.shape
    K = w.shape[1]
    if history is None:
        history = torch.zeros((B, K - 1, C), dtype=xBC.dtype, device=xBC.device)
    xp = torch.cat([history, xBC], dim=1)  # (B, L+K-1, C)
    out = torch.zeros((B, L, C), dtype=torch.float32, device=xBC.device)
    for i in range(K):
        out = out + xp[:, i : i + L, :].to(torch.float32) * w[:, i].to(torch.float32)
    return F.silu(out + b).to(xBC.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    y = y.to(torch.float32) * F.silu(z.to(torch.float32))
    var = y.square().mean(dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + eps) * (1.0 + scale)).to(z.dtype)


def _ssd(xs: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, dt: torch.Tensor, dt_bias: torch.Tensor,
         A_log: torch.Tensor, Dp: torch.Tensor, Q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD over the heads of ``xs`` (B, L, H, P), with the
    single group's ``Bm``/``Cm`` (B, L, N) and the raw ``dt`` (B, L, H).
    Returns (y (B, L, H·P) f32 with the skip term, the final state
    (B, H, P, N))."""
    Bsz, L, H, P = xs.shape
    N = Bm.shape[-1]
    nc = L // Q
    f32 = torch.float32

    dt = F.softplus(dt.to(f32) + dt_bias)  # (B, L, H)
    A = -torch.exp(A_log)  # (H,) negative
    dA = dt * A  # (B, L, H), <= 0

    # chunked views
    xc = xs.reshape(Bsz, nc, Q, H, P).to(f32)
    Bc = Bm.reshape(Bsz, nc, Q, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, Q, N).to(f32)
    dtc = dt.reshape(Bsz, nc, Q, H)
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xs.device))
    # inclusive cumsum within each chunk, as a product with the triangle
    dAcs = torch.einsum("ij,bcjh->bcih", tril.to(f32), dA.reshape(Bsz, nc, Q, H))

    # ---- intra-chunk (quadratic, masked decay matrix) --------------------
    seg = dAcs[:, :, :, None, :] - dAcs[:, :, None, :, :]  # (B,nc,Q,Q,H) = a_i - a_j
    Ldecay = torch.exp(torch.where(tril[None, None, :, :, None], seg, float("-inf")))
    att = torch.einsum("bcln,bcsn->bcls", Cc, Bc)  # (B,nc,Q,Q)
    xdt = xc * dtc[..., None]  # (B,nc,Q,H,P)
    y_diag = torch.einsum("bclsh,bcshp->bclhp", att[..., None] * Ldecay, xdt)

    # ---- chunk states + inter-chunk recurrence ---------------------------
    decay_states = torch.exp(dAcs[:, :, -1:, :] - dAcs)  # (B,nc,Q,H)
    states = torch.einsum("bcsn,bcshp->bchpn", Bc, (decay_states * dtc)[..., None] * xc)
    chunk_decay = torch.exp(dAcs[:, :, -1, :])  # (B,nc,H)

    carry = torch.zeros((Bsz, H, P, N), dtype=f32, device=xs.device)
    prev = []
    for c in range(nc):  # the reference's lax.scan: emit the state entering chunk c
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,H,P,N)

    state_decay_out = torch.exp(dAcs)  # (B,nc,Q,H)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) * state_decay_out[..., None]

    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    y = y + Dp[None, None, :, None] * xs.to(f32)
    return y.reshape(Bsz, L, H * P), carry


def _conv_per_shard(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_causal_conv`` on each process's channels: the conv is per
    channel, so where ``xBC``'s channels are sharded and the conv's weights
    alike each process convolves its own, and where the batch is sharded
    its own rows."""
    if not hasattr(xBC, "device_mesh"):
        return _causal_conv(xBC, w, b)
    from torch.distributed.tensor import Replicate, Shard

    for i, p in enumerate(xBC.placements):
        want = Shard(0) if p == Shard(2) else Replicate()
        if p not in (Shard(0), Shard(2), Replicate()) or w.placements[i] != want or b.placements[i] != want:
            raise ValueError(f"conv layout on mesh dim {i}: xBC {p}, weights {w.placements[i]}, {b.placements[i]}")
    return from_block(_causal_conv(*local_blocks(xBC, w, b)), xBC, xBC.placements, tuple(xBC.shape))


def _ssd_per_shard(xBC: torch.Tensor, dt: torch.Tensor, params: dict[str, torch.Tensor], cfg: ModelConfig,
                   Q: int, ctx: ShardCtx | None) -> tuple[torch.Tensor, torch.Tensor]:
    """``_ssd`` on the conv output ``xBC`` (B, L, conv_dim): on a mesh, each
    process runs its batch rows and its heads (``dt`` constrained to
    ``ssm_heads``). ``xBC``'s channels are x (heads-major), then B and C, so
    its shards do not fall on the heads: the channels are gathered, and
    each process reads its heads' columns of x and the whole of B and C."""
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    d = cfg.d_inner
    hp = [params["dt_bias"], params["A_log"], params["D"]]
    if not hasattr(xBC, "device_mesh"):
        Bsz, L, _ = xBC.shape
        return _ssd(xBC[..., :d].reshape(Bsz, L, H, P), xBC[..., d : d + N], xBC[..., d + N :], dt, *hp, Q)
    from torch.distributed.tensor import Replicate, Shard

    dt = constrain(dt, ctx, ("batch", "seq", "ssm_heads"))
    mesh = xBC.device_mesh
    xBC = xBC.redistribute(mesh, [Shard(0) if p == Shard(0) else Replicate() for p in xBC.placements])
    heads = [i for i, p in enumerate(dt.placements) if p == Shard(2)]
    for i, p in enumerate(dt.placements):
        want = Shard(0) if i in heads else Replicate()
        if (i not in heads and p != xBC.placements[i]) or any(x.placements[i] != want for x in hp):
            raise ValueError(f"SSD layout on mesh dim {i}: dt {p}, xBC {xBC.placements[i]}, "
                             f"heads' params {[x.placements[i] for x in hp]}")
    if len(heads) > 1:
        raise ValueError(f"the SSD's heads sharded over {len(heads)} mesh dims")
    x_l, dt_l, *hp_l = local_blocks(xBC, dt, *hp)
    Bsz, L, _ = x_l.shape
    Hl = dt_l.shape[-1]
    h0 = mesh.get_local_rank(heads[0]) * Hl if heads else 0
    xs = x_l[..., h0 * P : (h0 + Hl) * P].reshape(Bsz, L, Hl, P)
    y, state = _ssd(xs, x_l[..., d : d + N], x_l[..., d + N :], dt_l, *hp_l, Q)
    state_pl = [Shard(1) if p == Shard(2) else p for p in dt.placements]
    return (from_block(y, xBC, dt.placements, (*dt.shape[:2], d)),
            from_block(state, xBC, state_pl, (dt.shape[0], H, P, N)))


def apply(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, L, d_model)
    cfg: ModelConfig,
    chunk: int = CHUNK,
    *,
    ctx: ShardCtx | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Chunked SSD forward. Returns (out, final_cache)."""
    L = x.shape[1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)

    z, xBC_raw, dt = _project(params, x)
    xBC_raw = constrain(xBC_raw, ctx, ("batch", "seq", "ssm_inner"))
    z = constrain(z, ctx, ("batch", "seq", "ssm_inner"))
    xBC = _conv_per_shard(xBC_raw, params["conv_w"], params["conv_b"])
    y, state = _ssd_per_shard(xBC, dt, params, cfg, Q, ctx)
    y = _gated_norm(y, z, params["norm"], cfg.norm_eps)
    out = einsum("ble,ed->bld", y, params["out_proj"]).to(x.dtype)
    out = constrain(out, ctx, ("batch", "seq", "act_embed"))

    cache = {
        "conv": xBC_raw[:, -(cfg.ssm_conv - 1) :, :].to(cfg.compute_dtype),
        "state": state,
    }
    return out, cache


def decode(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, d_model)
    cache: dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    ctx: ShardCtx | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Single-token recurrent update, state' = state·exp(dt·A) + dt·B⊗x;
    the new ``conv`` and ``state`` are written into ``cache`` in place.
    Returns (output, cache)."""
    Bsz = x.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    f32 = torch.float32

    z, xBC_raw, dt = _project(params, x[:, 0])  # (B, ·)
    no_sharding_rule(xBC_raw, "the Mamba-2 decode step (the rolling conv history and the state update)")

    # causal conv at one position from the rolling history
    hist = cache["conv"]  # (B, K-1, C)
    w, b = params["conv_w"], params["conv_b"]
    full = torch.cat([hist, xBC_raw[:, None, :].to(hist.dtype)], dim=1)  # (B,K,C)
    conv_out = torch.einsum("bkc,ck->bc", full.to(f32), w.to(f32))
    xBC = F.silu(conv_out + b)

    xt = xBC[:, : cfg.d_inner].reshape(Bsz, H, P)
    Bt = xBC[:, cfg.d_inner : cfg.d_inner + N]
    Ct = xBC[:, cfg.d_inner + N :]

    dt = F.softplus(dt.to(f32) + params["dt_bias"])  # (B,H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)  # (B,H)

    state = cache["state"] * dA[:, :, None, None] + (dt[:, :, None, None] * xt.to(f32)[..., None]) * Bt[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", Ct, state)  # (B,H,P)
    y = y + params["D"][None, :, None] * xt.to(f32)
    y = y.reshape(Bsz, cfg.d_inner)
    y = _gated_norm(y, z, params["norm"], cfg.norm_eps)
    out = einsum("be,ed->bd", y, params["out_proj"]).to(x.dtype)[:, None, :]

    cache["conv"].copy_(full[:, 1:, :])
    cache["state"].copy_(state)
    return constrain(out, ctx, ("batch", None, "act_embed")), cache
