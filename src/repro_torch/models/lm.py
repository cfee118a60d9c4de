"""The full model for all ten architectures (decoder LM, MoE, Mamba-2 (SSM),
hybrid, encoder-only, VLM backbone): parameter declarations, forward pass,
train loss, prefill and the single-token decode step.

Parameters keep the reference's layout, per-slot leaves stacked along a
leading "layers" dim (``params["layers"]["slot0"][leaf][i]`` is layer i):
the checkpoint's shard plan, manifests and bytes are keyed on it. The
reference scans over periods with ``lax.scan``; the port loops over them in
Python, each period under ``torch.utils.checkpoint`` when ``cfg.remat`` is
``"full"`` (nothing saved), or ``"dots"`` (the matmul outputs saved, the
rest recomputed: ``jax.checkpoint_policies.checkpoint_dots``).

Inputs by family: token ids (decoders); precomputed frame embeddings of
width ``frontend_stub_dim`` through ``in_proj`` (the encoder, which attends
bidirectionally and has no decode step); token ids plus a vision stub of
``vision_tokens`` patch embeddings, projected once per forward by
``vision_proj`` into the keys and values of the "cross" slots (the VLM).

The decode cache is the reference's, stacked over the periods: per
attention slot k and v of shape ``(num_periods, batch, max_seq, kv_heads,
head_dim)``, per Mamba slot ``conv`` (the last ``ssm_conv - 1`` raw xBC
rows) and ``state`` (the SSD state, f32). ``decode_step`` writes each
layer's new entries into it in place and returns the same tree. The MoE
slots' load-balance losses are summed over the stack; ``loss_fn`` adds
their mean over the layers times ``aux_weight``. A cross slot's cache holds
the ``vision_tokens`` keys and values from prefill; decode only reads it.

Every entry point takes the reference's ``ctx`` (``models/common.py``):
with ``ctx=None`` nothing changes; on a ``ProcessMesh`` the params and
inputs are DTensors, the activations are constrained at the reference's
call sites, the ``fsdp`` preset gathers each period's weights over the data
axes inside the loop (``_per_layer_gather``), and a plain tensor made inside
(a mask, an iota) counts as replicated (DTensor's implicit replication).
"""

from __future__ import annotations

import contextlib
import math
import threading
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, moe
from repro_torch.models.common import ShardCtx, constrain, einsum, embed_spec, rmsnorm, rmsnorm_spec, softcap
from repro_torch.sharding.spec import ParamSpec, stack_tree, tree_count
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten

LOSS_CHUNK = 512  # sequence-chunked cross-entropy (bounds logits memory)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig) -> dict[str, Any]:
    """The one declaration of the params (the train-state layout derives
    from it too)."""
    p: dict[str, Any] = {
        "embed": embed_spec(cfg.padded_vocab, cfg.d_model, cfg.param_dtype),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }
    if cfg.is_encoder and cfg.frontend_stub_dim:
        p["in_proj"] = ParamSpec((cfg.frontend_stub_dim, cfg.d_model), (None, "embed"), dtype=cfg.param_dtype)
    if cfg.vision_tokens:
        p["vision_proj"] = ParamSpec((cfg.frontend_stub_dim, cfg.d_model), (None, "embed"), dtype=cfg.param_dtype)
    if not cfg.tie_embeddings:
        p["head"] = ParamSpec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"), dtype=cfg.param_dtype)
    layers = {}
    for j in range(cfg.period):
        layers[f"slot{j}"] = stack_tree(blocks.block_specs(cfg, j), cfg.num_periods)
    p["layers"] = layers
    return p


def param_count(cfg: ModelConfig) -> int:
    return tree_count(abstract_params(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: the top-k experts only)."""
    total = param_count(cfg)
    if not cfg.has_moe:
        return total
    moe_slots = [j for j in range(cfg.period) if blocks.slot_is_moe(cfg, j)]
    specs = moe.abstract_params(cfg)
    per_slot = tree_count(specs) - tree_count({"router": specs["router"]})
    inactive_frac = 1.0 - cfg.experts_per_tok / cfg.num_experts
    inactive = int(len(moe_slots) * cfg.num_periods * per_slot * inactive_frac)
    return total - inactive


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

_MESH_SCOPE = threading.local()


@contextlib.contextmanager
def on_mesh(ctx: ShardCtx | None):
    """The scope of a step on a mesh: DTensor's implicit replication of the
    plain tensors made inside (each process makes the same one); nothing
    without a mesh. Nested scopes keep the outermost one's (DTensor's own
    context would switch it off at the first inner exit)."""
    depth = getattr(_MESH_SCOPE, "depth", 0)
    if ctx is None or depth:
        _MESH_SCOPE.depth = depth + (ctx is not None)
        try:
            yield
        finally:
            _MESH_SCOPE.depth = depth
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _MESH_SCOPE.depth = 1
    try:
        with implicit_replication():
            yield
    finally:
        _MESH_SCOPE.depth = 0


def _embed_tokens(params: dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
                  ctx: ShardCtx | None = None) -> torch.Tensor:
    table = params["embed"]
    if ctx is not None and ctx.rules.get("embed") is not None:
        # FSDP: the lookup reads the table gathered over the data axes (its
        # vocab-parallel lookup takes a table sharded on the vocab alone)
        table = constrain(table, ShardCtx(ctx.mesh, ctx.rules.override(embed=None)), ("vocab", "embed"))
    h = F.embedding(tokens, table).to(cfg.compute_dtype)
    if cfg.scale_embed:
        h = h * math.sqrt(cfg.d_model)
    return constrain(h, ctx, ("batch", "seq", "act_embed"))


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``checkpoint_dots``: keep the matmul outputs, recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return partial(checkpoint, fn, use_reentrant=False,
                       context_fn=partial(create_selective_checkpoint_contexts, _save_dots))
    return partial(checkpoint, fn, use_reentrant=False)


def _per_layer_gather(cfg: ModelConfig, ctx: ShardCtx | None):
    """FSDP: a function that constrains one period's weight slices to the
    gathered (data-replicated) view inside the loop over the periods, so each
    period's gather happens in its own iteration (and again in its
    recomputation under remat). The identity for the TP presets and
    without a mesh."""
    if ctx is None or cfg.sharding_preset != "fsdp" or not cfg.fsdp_gather_per_layer:
        return lambda lp: lp
    gctx = ShardCtx(ctx.mesh, ctx.rules.override(embed=None))
    dims = {f"slot{j}": blocks.block_specs(cfg, j) for j in range(cfg.period)}

    def gather(layer_params):
        paths, leaves = tree_flatten(layer_params)
        _, specs = tree_flatten(dims)
        return tree_unflatten(paths, [constrain(x, gctx, s.dims) for x, s in zip(leaves, specs)])

    return gather


def forward(
    params: dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor | None = None,    # (B, S) integers
    *,
    frames: torch.Tensor | None = None,    # (B, S, stub) encoder inputs
    vision: torch.Tensor | None = None,    # (B, V, stub) VLM patch embeddings
    collect_cache: bool = False,
    ctx: ShardCtx | None = None,
) -> tuple[torch.Tensor, Any, torch.Tensor]:
    """-> (final hidden (B, S, D), cache, moe_aux). With ``collect_cache``
    the cache holds each slot's entries stacked over the periods (k/v:
    (num_periods, B, S, KV, D), a cross slot's S the vision tokens; Mamba:
    conv and state); else it is None."""
    if cfg.is_encoder and cfg.frontend_stub_dim:
        if frames is None:
            raise ValueError(f"{cfg.name} takes frame embeddings (frames=)")
        h = einsum("bse,ed->bsd", frames.to(cfg.compute_dtype), params["in_proj"])
        h = constrain(h, ctx, ("batch", "seq", "act_embed"))
    else:
        if tokens is None:
            raise ValueError(f"{cfg.name} takes token ids (tokens=)")
        h = _embed_tokens(params, tokens, cfg, ctx)

    vision_kv = None
    if cfg.vision_tokens:
        if vision is None:
            raise ValueError(f"{cfg.name} requires vision embeddings (vision=)")
        vision_kv = einsum("bve,ed->bvd", vision.to(cfg.compute_dtype), params["vision_proj"])
        vision_kv = constrain(vision_kv, ctx, ("batch", "vision", "act_embed"))
    gather = _per_layer_gather(cfg, ctx)

    def period_body(h, aux, layer_params):
        layer_params = gather(layer_params)
        caches = {}
        for j in range(cfg.period):
            h, cache_j, aux_j = blocks.apply_block(layer_params[f"slot{j}"], h, cfg, j, vision_kv=vision_kv,
                                                   ctx=ctx)
            aux = aux + aux_j
            if collect_cache:
                caches[f"slot{j}"] = cache_j
        return h, aux, caches

    body = _remat(period_body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    per_layer = []  # each period's {slot: cache entry} when collecting
    for i in range(cfg.num_periods):
        sliced = tree_map(lambda x: x[i], params["layers"])
        h, aux, c = body(h, aux, sliced)
        if collect_cache:
            per_layer.append(tree_flatten(c))

    cache = None
    if collect_cache:
        paths = per_layer[0][0]
        cache = tree_unflatten(paths, [torch.stack(xs) for xs in zip(*(leaves for _, leaves in per_layer))])
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return h, cache, aux


def _head_weight(params: dict[str, Any], cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T  # (D, V)
    return params["head"]


def logits_fn(params: dict[str, Any], h: torch.Tensor, cfg: ModelConfig,
              ctx: ShardCtx | None = None) -> torch.Tensor:
    w = _head_weight(params, cfg)
    logits = einsum("...d,dv->...v", h, w).to(torch.float32)
    logits = softcap(logits, cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad_mask, -1e30, logits)
    dims = ("batch", "seq", "vocab") if h.ndim == 3 else ("batch", "vocab")
    return constrain(logits, ctx, dims)


# ---------------------------------------------------------------------------
# Loss (sequence-chunked cross-entropy)
# ---------------------------------------------------------------------------

def _ce_chunk(params, h_c, labels_c, mask_c, cfg, ctx=None):
    logits = logits_fn(params, h_c, cfg, ctx)  # (B, Sc, V_pad) f32
    if ctx is None:
        lse = torch.logsumexp(logits, dim=-1)
    else:
        # over a vocab-sharded dim: per-shard max and sum of exponentials,
        # each reduced over the shards (``jax.nn.logsumexp``'s form); DTensor's
        # own logsumexp gathers the logits
        m = logits.detach().amax(dim=-1, keepdim=True)
        sumexp = constrain(torch.exp(logits - m).sum(dim=-1, keepdim=True), ctx, ("batch", "seq", None))
        lse = (m + torch.log(sumexp)).squeeze(-1)
    # The label logit as the reference takes it: a select against an iota,
    # summed (a gather's backward would scatter).
    iota = constrain(torch.arange(logits.shape[-1], device=logits.device), ctx, ("vocab",))
    label_logit = torch.where(iota == labels_c[..., None], logits, 0.0).sum(dim=-1)
    # per token, batch-sharded: a reduction over the vocab shards left to
    # itself may shard the batch over "model" too, and its gradient would
    # then be redistributed at the logits' size (the sum above likewise)
    label_logit = constrain(label_logit, ctx, ("batch", "seq"))
    nll = (lse - label_logit) * mask_c
    return nll.sum(), mask_c.sum()


def loss_fn(
    params: dict[str, Any],
    batch: dict[str, torch.Tensor],
    cfg: ModelConfig,
    aux_weight: float = 0.01,
    *,
    ctx: ShardCtx | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean next-token (or, with the batch's ``mask``, masked-prediction)
    cross-entropy (+ the MoE aux loss, 0 for dense)."""
    with on_mesh(ctx):
        return _loss(params, batch, cfg, aux_weight, ctx)


def _loss(params, batch, cfg, aux_weight, ctx):
    h, _, aux = forward(params, cfg, batch.get("tokens"), frames=batch.get("frames"), vision=batch.get("vision"),
                        ctx=ctx)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    mask = mask.to(torch.float32)

    S = h.shape[1]
    chunk = min(LOSS_CHUNK, S)
    n = S // chunk if S % chunk == 0 else 1
    if n == 1:
        chunk = S
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = torch.zeros((), dtype=torch.float32, device=h.device)
    ce = partial(_ce_chunk, cfg=cfg, ctx=ctx)
    if cfg.remat != "none":
        ce = partial(checkpoint, ce, use_reentrant=False)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        t, d = ce(params, h[:, sl], labels[:, sl], mask[:, sl])
        total, denom = total + t, denom + d
    loss = total / torch.clamp_min(denom, 1.0)
    moe_aux = aux / max(cfg.num_layers, 1)
    full = loss + aux_weight * moe_aux
    return full, {"ce_loss": loss, "moe_aux": moe_aux, "tokens": denom}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def prefill(
    params: dict[str, Any],
    cfg: ModelConfig,
    *,
    tokens: torch.Tensor | None = None,
    frames: torch.Tensor | None = None,
    vision: torch.Tensor | None = None,
    ctx: ShardCtx | None = None,
) -> tuple[torch.Tensor, Any]:
    """Returns (last-position logits (B, V), cache of length S). Encoder:
    (every position's logits (B, S, V), None)."""
    with on_mesh(ctx):
        h, cache, _ = forward(params, cfg, tokens, frames=frames, vision=vision, collect_cache=not cfg.is_encoder,
                              ctx=ctx)
        if cfg.is_encoder:
            return logits_fn(params, h, cfg, ctx), None
        return logits_fn(params, h[:, -1, :], cfg, ctx), cache


def decode_step(
    params: dict[str, Any],
    cache: Any,
    token: torch.Tensor,    # (B,) integers: the token at position `pos`
    pos: torch.Tensor,      # 0-d integer tensor
    cfg: ModelConfig,
    *,
    ctx: ShardCtx | None = None,
) -> tuple[torch.Tensor, Any]:
    """One decode step: returns (logits (B, V) for position pos, cache), the
    cache written in place."""
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name}: encoder-only archs have no decode step")
    with on_mesh(ctx):
        h = _embed_tokens(params, token[:, None], cfg, ctx)  # (B, 1, D)
        gather = _per_layer_gather(cfg, ctx)
        for i in range(cfg.num_periods):
            layer_params = gather(tree_map(lambda x: x[i], params["layers"]))
            for j in range(cfg.period):
                layer_cache = tree_map(lambda x: x[i], cache[f"slot{j}"])  # views of the leaves
                h, _ = blocks.decode_block(layer_params[f"slot{j}"], h, layer_cache, pos, cfg, j, ctx=ctx)
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return logits_fn(params, h[:, 0, :], cfg, ctx), cache


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int) -> dict[str, Any]:
    """ParamSpec tree of the decode cache (stand-ins and allocation)."""
    return {
        f"slot{j}": stack_tree(blocks.block_cache_spec(cfg, j, batch, max_seq), cfg.num_periods)
        for j in range(cfg.period)
    }
