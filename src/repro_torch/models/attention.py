"""Attention: GQA/MQA, sliding window, softcap, cross-attention (the VLM's
"cross" slots, keys and values from the projected vision stub), KV-cache
decode.

Training runs the reference's blockwise (flash-style) formulation in plain
tensor ops: a loop over query chunks, each an online softmax over its
causally reachable KV chunks, with an f32 accumulator. Sliding-window
layers skip KV chunks outside the window. The arithmetic (scores in f32
from the compute dtype's products, ``NEG_INF`` masking, the running max and
its correction) is the reference's, which the tests compare against; the
JAX package has no Pallas kernel here, and the port adds none.

Decode attends a single query over the whole ``max_seq`` KV cache with a
position mask, as the reference does, and writes the new token's k/v into
the cache **in place** at ``pos`` (the reference returns a new cache): the
cache is allocated once per serving session and never rebuilt per token.
A cross slot's cache holds ``vision_tokens`` rows, filled at prefill and
only read by decode.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ShardCtx, apply_rope, constrain, einsum, softcap
from repro_torch.sharding.spec import ParamSpec

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig, cross: bool = False) -> dict[str, ParamSpec]:
    """The same four leaves for self- and cross-attention (``cross`` is the
    reference's signature)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = cfg.param_dtype
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), dtype=dt),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"), dtype=dt),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim"), dtype=dt),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"), dtype=dt),
    }


# ---------------------------------------------------------------------------
# Blockwise attention core
# ---------------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV*n_rep, D). Head h reads kv head h // n_rep.
    An expand and a reshape, so the backward is a plain sum over the copies
    (``repeat_interleave``'s backward scatters)."""
    if n_rep == 1:
        return k
    B, S, KV, D = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, n_rep, D).reshape(B, S, KV * n_rep, D)


def _chunk_attn_scores(q, k, scale, cap):
    # q: (B, Bq, H, D)  k: (B, Bk, H, D) -> scores (B, H, Bq, Bk) f32: the
    # compute dtype's products, summed in f32 (preferred_element_type=f32)
    s = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32), k.to(torch.float32))
    return softcap(s * scale, cap)


def _mask(q_pos, k_pos, causal: bool, window: int | None):
    # (Bq, Bk) boolean validity mask.
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def blockwise_attention(
    q: torch.Tensor,          # (B, Sq, H, D)
    k: torch.Tensor,          # (B, Sk, KV, D)
    v: torch.Tensor,          # (B, Sk, KV, D)
    *,
    causal: bool,
    window: int | None = None,
    attn_cap: float | None = None,
    q_offset: int = 0,
    q_chunk: int = 1024,
    k_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax blockwise attention. Returns (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    k = repeat_kv(k, H // KV)
    v = repeat_kv(v, H // KV)
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    # Pad to chunk multiples.
    sq_pad = (-Sq) % q_chunk
    sk_pad = (-Sk) % k_chunk
    if sq_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, sq_pad))
    if sk_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, sk_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, sk_pad))
    nq, nk = (Sq + sq_pad) // q_chunk, (Sk + sk_pad) // k_chunk

    k_ch = k.reshape(B, nk, k_chunk, H, D)
    v_ch = v.reshape(B, nk, k_chunk, H, D)

    outs = []
    for i in range(nq):
        qi = q[:, i * q_chunk : (i + 1) * q_chunk]
        q_pos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        # Chunk range reachable from this query chunk.
        if causal:
            j_hi = min(nk, (q_offset + (i + 1) * q_chunk + k_chunk - 1) // k_chunk)
        else:
            j_hi = nk
        if window is not None:
            j_lo = max(0, (q_offset + i * q_chunk - window) // k_chunk)
        else:
            j_lo = 0
        j_hi = max(j_hi, j_lo + 1)

        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_chunk, D), dtype=torch.float32, device=dev)
        for j in range(j_lo, j_hi):
            kj, vj = k_ch[:, j], v_ch[:, j]
            k_pos = j * k_chunk + torch.arange(k_chunk, device=dev)
            s = _chunk_attn_scores(qi, kj, scale, attn_cap)  # (B,H,Bq,Bk)
            valid = _mask(q_pos, k_pos, causal, window)
            # Padded KV rows (beyond Sk) are invalid.
            valid &= (k_pos < Sk)[None, :]
            s = torch.where(valid[None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqs,bshd->bhqd", p.to(vj.dtype).to(torch.float32), vj.to(torch.float32))
            acc = acc * corr[..., None] + pv
            m = m_new
        oi = acc / torch.clamp_min(l[..., None], 1e-37)  # (B,H,Bq,D)
        outs.append(oi.transpose(1, 2).to(v.dtype))  # (B,Bq,H,D)

    return torch.cat(outs, dim=1)[:, :Sq]


def _per_shard(fn):
    """``fn(q, k, v, **kw)`` on DTensors as each process's blocks: the
    attention of a batch row and a head reads nothing of another, so where
    q shards batch (dim 0) or heads (dim 2) over an axis, and k and v shard
    the same dims over it (kv heads with heads), each process attends its
    own blocks and the output keeps q's placements; any other placement on
    an axis is gathered first. DTensor's einsum would flatten the batch and
    head dims, both sharded, which its sharding rules refuse. Plain tensors
    go to ``fn`` as they are."""

    def run(q, k, v, **kw):
        if not hasattr(q, "device_mesh"):  # a plain tensor
            return fn(q, k, v, **kw)
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = q.device_mesh
        keep = []
        for pq, pk, pv in zip(q.placements, k.placements, v.placements):
            local = pq == pk == pv and (pq == Replicate() or pq in (Shard(0), Shard(2)))
            keep.append(pq if local else Replicate())
        q, k, v = (x.redistribute(mesh, keep) for x in (q, k, v))
        o = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
        shape = (*q.shape[:3], v.shape[3])
        return DTensor.from_local(o, mesh, keep, run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    return run


# ---------------------------------------------------------------------------
# Full-sequence (train/prefill) layer application
# ---------------------------------------------------------------------------

def apply(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,                 # (B, S, d_model)
    cfg: ModelConfig,
    *,
    kind: str,                       # attn | local | cross
    kv_src: torch.Tensor | None = None,  # cross-attention source (B, S_kv, d_model)
    positions: torch.Tensor | None = None,
    q_offset: int = 0,
    ctx: ShardCtx | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Returns (output, kv) where kv holds this layer's k/v for cache
    building. A cross slot takes q from ``x`` and k/v from ``kv_src``, with
    no RoPE and no causal mask."""
    B, S, _ = x.shape
    if positions is None:
        positions = q_offset + torch.arange(S, device=x.device)

    q = einsum("bsd,dhk->bshk", x, params["wq"]).to(cfg.compute_dtype)
    src = x if kv_src is None else kv_src
    k = einsum("bsd,dhk->bshk", src, params["wk"]).to(cfg.compute_dtype)
    v = einsum("bsd,dhk->bshk", src, params["wv"]).to(cfg.compute_dtype)

    if kind != "cross":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, ctx, ("batch", "seq", "heads", None))
    k = constrain(k, ctx, ("batch", "seq", "kv_heads", None))
    v = constrain(v, ctx, ("batch", "seq", "kv_heads", None))
    window = cfg.sliding_window if kind == "local" else None

    o = _per_shard(blockwise_attention)(
        q, k, v,
        causal=kind != "cross" and not cfg.is_encoder,
        window=window,
        attn_cap=cfg.attn_softcap,
        q_offset=q_offset,
        q_chunk=cfg.attn_chunk,
        k_chunk=cfg.attn_chunk,
    )
    out = einsum("bshk,hkd->bsd", o, params["wo"]).to(x.dtype)
    return constrain(out, ctx, ("batch", "seq", "act_embed")), {"k": k, "v": v}


# ---------------------------------------------------------------------------
# Decode step (single token, KV cache)
# ---------------------------------------------------------------------------

def decode_cache_spec(cfg: ModelConfig, batch: int, max_seq: int, kind: str) -> dict[str, ParamSpec]:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    seq = cfg.vision_tokens if kind == "cross" else max_seq
    dims = ("batch", "kv_seq", "kv_heads", None)
    return {
        "k": ParamSpec((batch, seq, kv, hd), dims, dtype=cfg.compute_dtype, init="zeros"),
        "v": ParamSpec((batch, seq, kv, hd), dims, dtype=cfg.compute_dtype, init="zeros"),
    }


def decode(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,                   # (B, 1, d_model)
    cache: dict[str, torch.Tensor],    # k/v: (B, S_max, KV, D), written in place
    pos: torch.Tensor,                 # 0-d integer tensor: index of the new token
    cfg: ModelConfig,
    *,
    kind: str,
    ctx: ShardCtx | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One token through the layer. The new k/v land in ``cache`` at ``pos``
    (``index_copy_``: no host sync on ``pos``); a cross slot reads its
    static cache, filled at prefill, and writes nothing. Returns (output,
    cache)."""
    B = x.shape[0]
    q = einsum("bsd,dhk->bshk", x, params["wq"]).to(cfg.compute_dtype)
    k, v = cache["k"], cache["v"]
    if kind == "cross":
        valid = torch.ones((k.shape[1],), dtype=torch.bool, device=k.device)
    else:
        at = pos.reshape(1, 1)
        q = apply_rope(q, at, cfg.rope_theta)
        knew = einsum("bsd,dhk->bshk", x, params["wk"]).to(cfg.compute_dtype)
        vnew = einsum("bsd,dhk->bshk", x, params["wv"]).to(cfg.compute_dtype)
        knew = apply_rope(knew, at, cfg.rope_theta)
        k.index_copy_(1, pos.reshape(1).to(torch.int64), knew)
        v.index_copy_(1, pos.reshape(1).to(torch.int64), vnew)
        idx = torch.arange(k.shape[1], device=k.device)
        valid = idx <= pos
        if kind == "local":
            valid &= idx > pos - cfg.sliding_window

    KV, D = k.shape[2], k.shape[3]
    H = q.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, D)
    # the compute dtype's products summed in f32 (preferred_element_type=f32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32), k.to(torch.float32))
    s = softcap(s / math.sqrt(D), cfg.attn_softcap)
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    o = o.reshape(B, 1, H, D).to(cfg.compute_dtype)
    out = einsum("bshk,hkd->bsd", o, params["wo"]).to(x.dtype)
    return constrain(out, ctx, ("batch", None, "act_embed")), cache
