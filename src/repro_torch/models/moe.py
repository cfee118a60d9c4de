"""Mixture-of-Experts with GShard-style capacity-based dispatch (port of
``repro.models.moe``).

Dispatch and combine are dense one-hot einsums over groups of tokens, as
in the reference: no gather or scatter, so the forward and its backward are
plain matrix products, deterministic on the card. The JAX package computes
them outside any Pallas kernel, and so does the port.

Routing is the reference's, token for token:

* top-k is taken as k rounds of argmax-and-mask, so that tied
  probabilities go to the lower expert index as ``jax.lax.top_k`` gives
  them (``torch.topk``'s order among equal values is not documented);
* every one-hot is a comparison against an ``arange``: an index outside
  the range (``pos_in_expert`` of -1, or a position at or beyond the
  capacity C, a dropped token) gives a zero row, as ``jax.nn.one_hot``
  does, where ``F.one_hot`` would raise;
* the capacity positions are a cumulative sum over the flattened
  (token, slot) order, token-major, so the same tokens drop once an
  expert's C slots are full (decode's single group of 16 tokens has C = 5).

The reference's two sharding modes (``tp``, ``ep``) are GSPMD layouts. On
a ``ProcessMesh`` the routing and the dispatch run as DTensor ops on the
batch-sharded groups (each data shard routes its own groups; the router's
contraction over the model-sharded embedding is reduced before the
softmax), and the expert FFN runs per shard (``_experts_per_shard``): under
``tp`` each process multiplies its groups by its slice of every expert's
``mlp`` dim and the down projection's partial sums are reduced over
"model"; under ``ep`` (``experts`` on "data") the groups first go to the
shards that hold their experts, an all-to-all over "data" (DTensor's
``Shard(0)`` to ``Shard(1)``), and come back the same way.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ShardCtx, constrain, einsum, from_block, local_blocks
from repro_torch.models.mlp import _act
from repro_torch.sharding.spec import ParamSpec

GROUP_TOKENS = 512  # target tokens per dispatch group


def abstract_params(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.param_dtype
    out = {"router": ParamSpec((d, e), ("embed", None), dtype=torch.float32)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        out["w_gate"] = ParamSpec((e, d, f), ("experts", "embed", "mlp"), dtype=dt)
        out["w_up"] = ParamSpec((e, d, f), ("experts", "embed", "mlp"), dtype=dt)
        out["w_down"] = ParamSpec((e, f, d), ("experts", "mlp", "embed"), dtype=dt)
    else:
        out["w_in"] = ParamSpec((e, d, f), ("experts", "embed", "mlp"), dtype=dt)
        out["w_out"] = ParamSpec((e, f, d), ("experts", "mlp", "embed"), dtype=dt)
    return out


def expert_capacity(tokens_per_group: int, num_experts: int, k: int, factor: float = 1.25) -> int:
    cap = int(factor * k * tokens_per_group / num_experts)
    # C == tokens_per_group guarantees droplessness (a token picks each expert
    # at most once), so never allocate beyond it.
    return max(min(cap, tokens_per_group), 1)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row for an index outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: (values, indices), largest
    first, ties to the lower index. Values are selected, not gathered, so
    the backward is a product with a mask."""
    vals, idxs = [], []
    p = probs
    for _ in range(k):
        i = torch.argmax(p, dim=-1)  # the first maximal index
        hit = i[..., None] == torch.arange(p.shape[-1], device=p.device)
        vals.append(torch.where(hit, probs, 0.0).sum(-1))
        idxs.append(i)
        p = torch.where(hit, float("-inf"), p)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


@dataclass
class Routing:
    """One call's routing: G groups of tg tokens, capacity C per expert."""

    G: int
    tg: int
    C: int
    probs: torch.Tensor          # (G, tg, E) f32
    weights: torch.Tensor        # (G, tg, K) f32, renormalized
    sel: torch.Tensor            # (G, tg, K) expert indices
    onehot: torch.Tensor         # (G, tg, K, E) int32
    pos_in_expert: torch.Tensor  # (G, tg, K, E): slot in the expert's buffer, -1 where not routed
    within_cap: torch.Tensor     # (G, tg, K, E) bool


def route(params: dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
          num_groups: int | None = None) -> Routing:
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_tok
    T = B * S
    # Groups subdivide batch rows (the reference's dispatch-cost knob).
    if num_groups is None:
        per_row = max(1, S // GROUP_TOKENS) if S % GROUP_TOKENS == 0 else 1
        G = B * per_row
    else:
        G = num_groups
    assert T % G == 0, (T, G)
    tg = T // G
    C = expert_capacity(tg, E, K, cfg.moe_capacity_factor)

    xt = x.reshape(G, tg, D)
    # the router matmul in the compute dtype, the softmax in f32
    logits = einsum("gtd,de->gte", xt, params["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)

    weights, sel = _top_k(probs, K)  # (G, tg, K)
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)

    # position of each (token, slot) in its expert's capacity buffer
    onehot = _one_hot(sel, E, torch.int32)  # (G, tg, K, E)
    slot_flat = onehot.reshape(G, tg * K, E)
    pos_in_expert = (torch.cumsum(slot_flat, dim=1) * slot_flat - 1).reshape(G, tg, K, E)
    within_cap = (pos_in_expert >= 0) & (pos_in_expert < C)
    return Routing(G, tg, C, probs, weights, sel, onehot, pos_in_expert, within_cap)


def _experts(params: dict[str, torch.Tensor], ex_in: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The expert FFN, (G, E, C, D) -> (G, E, C, D)."""
    if "w_gate" in params:
        g = einsum("gecd,edf->gecf", ex_in, params["w_gate"])
        u = einsum("gecd,edf->gecf", ex_in, params["w_up"])
        h = _act(cfg.mlp_kind, g) * u
        return einsum("gecf,efd->gecd", h, params["w_down"])
    h = _act("gelu", einsum("gecd,edf->gecf", ex_in, params["w_in"]))
    return einsum("gecf,efd->gecd", h, params["w_out"])


def _experts_sharded(params: dict[str, torch.Tensor]) -> bool:
    """Whether the expert weights are DTensors sharded on the experts dim
    (``moe_mode="ep"`` where the experts divide over "data")."""
    from torch.distributed.tensor import Shard

    return any(p == Shard(0) for p in getattr(params["w_in" if "w_in" in params else "w_up"], "placements", ()))


def _experts_per_shard(params: dict[str, torch.Tensor], ex_in: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``_experts`` on each process's blocks. On every mesh dim the layout
    is one of: the groups sharded and the weights replicated (each shard
    runs its groups: ``Shard(0)``); the experts sharded in both (each shard
    runs its experts: ``Shard(1)``); or the weights' ``mlp`` dim sharded and
    the groups replicated (each shard's down projection is a partial sum:
    ``Partial``). Any other layout raises. Plain tensors go as they are."""
    if not hasattr(ex_in, "device_mesh"):
        return _experts(params, ex_in, cfg)
    from torch.distributed.tensor import Partial, Replicate, Shard

    w = {k: v for k, v in params.items() if k != "router"}

    def logical(k: str, pl) -> str:  # a leaf's placement as the dim it shards
        if not isinstance(pl, Shard):
            return "R" if pl.is_replicate() else str(pl)
        return ("e", "d", "f")[pl.dim] if k in ("w_gate", "w_up", "w_in") else ("e", "f", "d")[pl.dim]

    out = []
    for i, p in enumerate(ex_in.placements):
        dims = {logical(k, x.placements[i]) for k, x in w.items()}
        if p == Shard(1) and dims == {"e"}:
            out.append(Shard(1))
        elif p == Shard(0) and dims == {"R"}:
            out.append(Shard(0))
        elif p == Replicate() and dims in ({"f"}, {"R"}):
            out.append(Partial() if dims == {"f"} else Replicate())
        else:
            raise ValueError(f"expert layout on mesh dim {i}: groups {p}, weights {sorted(dims)}")
    blocks = local_blocks(ex_in, *w.values())
    local = _experts(dict(zip(w, blocks[1:])), blocks[0], cfg)
    return from_block(local, ex_in, out, tuple(ex_in.shape))


def apply(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, d_model)
    cfg: ModelConfig,
    num_groups: int | None = None,
    *,
    ctx: ShardCtx | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). Aux loss = load-balancing (Switch style)."""
    B, S, D = x.shape
    E = cfg.num_experts
    # the router and the dispatch read whole token rows: the model-sharded
    # embedding is gathered once here (smaller than the dispatched copies)
    x = constrain(x, ctx, ("batch", "seq", None))
    r = route(params, x, cfg, num_groups)
    xt = x.reshape(r.G, r.tg, D)
    dt = x.dtype

    # dispatch: (G, tg, E, C) one-hot; combine: the same with gate weights
    pos_oh = _one_hot(r.pos_in_expert, r.C, dt) * r.within_cap[..., None].to(dt)
    onehot = r.onehot.to(dt)
    dispatch = einsum("gtke,gtkec->gtec", onehot, pos_oh)
    combine = einsum("gtke,gtkec->gtec", r.weights.to(dt)[..., None] * onehot, pos_oh)

    ex_in = einsum("gtec,gtd->gecd", dispatch, xt)  # (G, E, C, D)
    # the group dim stays batch-sharded (a replicated constraint here would
    # compute every expert on every data shard)
    ex_in = constrain(ex_in, ctx, ("moe_group", "experts", None, None))
    if _experts_sharded(params):  # every group's tokens to the shards that hold their experts
        ex_in = constrain(ex_in, ctx, (None, "experts", None, None))
    ex_out = _experts_per_shard(params, ex_in, cfg)
    ex_out = constrain(ex_out, ctx, ("moe_group", "experts", None, None))

    out = einsum("gtec,gecd->gtd", combine, ex_out).reshape(B, S, D)
    out = constrain(out, ctx, ("batch", "seq", "act_embed"))

    # Switch-transformer load-balance loss: E * sum(frac_tokens * frac_probs)
    frac_tokens = r.onehot[..., 0, :].to(torch.float32).mean(dim=(0, 1))
    frac_probs = r.probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return out.to(dt), aux
