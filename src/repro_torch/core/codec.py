"""The pluggable redundancy-codec layer (port of ``repro.core.codec``).

Every redundancy scheme is a ``RedundancyCodec``: a pure object that knows
how to partition the rank space into **groups** (``group_size``), turn a
group's serialized shards into **redundancy blobs** (``encode``), decide
**where** each blob's stripes live (``placement``), rebuild missing shards
from survivors + blobs (``decode``), and state its **tolerance**.
``CheckpointEngine`` dispatches distribution and recovery through this
interface only.

This slice ports ``copy``, the paper's full-copy schemes: each rank is its
own group of one, and the "blobs" are R whole copies placed on the scheme's
shifted partners (Algorithm 1's pairwise N/2 shift, ``neighbor``, R evenly
spaced copies). Buffers are ``torch.uint8`` CPU tensors. The striped host
codecs ``xor``, ``rs`` and ``lrc`` wait for ROADMAP A4: looking them up
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import distribution as dist


class CodecDecodeError(RuntimeError):
    """Decode is impossible with the surviving shards + blobs (the engine
    wraps this into distribution.DataLostError with placement context)."""


class RedundancyCodec:
    """Interface contract (``repro.core.codec.RedundancyCodec``):

    encode(bufs, n_out)   k group-local byte buffers -> n_out redundancy
                          blobs, each ``placement()``-striped by the engine.
    placement(groups, gi, n_ranks)
                          one holder-rank tuple per blob; a blob is split
                          into len(holders) stripes, stripe j on holders[j].
    decode(present, blobs, missing)
                          group-local index -> rebuilt buffer for every
                          index in ``missing``; raises CodecDecodeError if
                          the surviving set is insufficient.
    tolerance()           max len(missing) per group guaranteed decodable
                          when the blob holders are intact.
    rebuilder(groups, gi, origin, alive)
                          the rank whose host ends up holding ``origin``'s
                          rebuilt shard (elastic residency).

    The arena-aware ``encode_into``/``decode_into``, ``encode_matrix`` and
    ``blobs_needed`` come with the striped codecs and the pipelined path that
    use them (ROADMAP A4, A5).
    """

    name: str = "?"
    #: blobs are striped across holder groups (False: whole copies on ranks)
    striped: bool = True
    #: the engine may int8-compress the group's buffers before encode
    compressible: bool = False

    def group_size(self, n_ranks: int) -> int:
        raise NotImplementedError

    def tolerance(self) -> int:
        raise NotImplementedError

    def encode(self, bufs: list[torch.Tensor], n_out: int) -> list[torch.Tensor]:
        raise NotImplementedError

    def placement(
        self, groups: list[dist.ParityGroup], gi: int, n_ranks: int
    ) -> list[tuple[int, ...]]:
        raise NotImplementedError

    def decode(
        self,
        present: dict[int, torch.Tensor],
        blobs: dict[int, torch.Tensor],
        missing: list[int],
    ) -> dict[int, torch.Tensor]:
        raise NotImplementedError

    def rebuilder(
        self, groups: list[dist.ParityGroup], gi: int, origin: int, alive: set[int]
    ) -> int | None:
        """Default: lowest surviving group member, else lowest surviving
        stripe holder (singleton groups: the blob IS the snapshot)."""
        for m in groups[gi].members:
            if m != origin and m in alive:
                return m
        for holders in self.placement(groups, gi, max(g.members[-1] for g in groups) + 1):
            for h in holders:
                if h in alive:
                    return h
        return None


# ---------------------------------------------------------------------------
# copy codec — the paper's full-copy distribution schemes as a codec
# ---------------------------------------------------------------------------

class CopyCodec(RedundancyCodec):
    name = "copy"
    striped = False
    compressible = True

    def __init__(self, scheme: str = "pairwise", n_copies: int = 1) -> None:
        self.scheme = scheme
        self.n_copies = n_copies

    def group_size(self, n_ranks: int) -> int:
        return 1

    def tolerance(self) -> int:
        # Any single group (= rank) may die outright; its copies elsewhere
        # rebuild it. Deeper guarantees depend on which holders survive.
        return 1

    def holders(self, n_ranks: int, origin: int) -> list[int]:
        """Ranks receiving ``origin``'s full copy under the active scheme."""
        if self.n_copies == 1:
            h = dist.get_scheme(self.scheme)(n_ranks, origin)[0]
            return [h] if h != origin else []
        return [
            (origin + s) % n_ranks
            for s in dist.multi_copy_shifts(n_ranks, self.n_copies)
            if s % n_ranks != 0
        ]

    def placement(self, groups, gi, n_ranks):
        # Group gi is the singleton {gi}; one whole-copy "stripe" per holder.
        return [(h,) for h in self.holders(n_ranks, gi)]

    def encode(self, bufs, n_out):
        assert len(bufs) == 1
        return [bufs[0]] * n_out  # references: R copies of the same bytes

    def decode(self, present, blobs, missing):
        if missing and not blobs:
            raise CodecDecodeError("origin and every holder of its copies failed")
        return {i: blobs[min(blobs)] for i in missing}

    def rebuilder(self, groups, gi, origin, alive):
        for holders in self.placement(groups, gi, max(g.members[-1] for g in groups) + 1):
            if holders[0] in alive:
                return holders[0]  # first alive holder, scheme order
        return None


# ---------------------------------------------------------------------------
# registry (user-extensible, mirrors distribution.register_scheme)
# ---------------------------------------------------------------------------

CodecFactory = Callable[..., RedundancyCodec]
_CODECS: dict[str, CodecFactory] = {}


def register_codec(name: str, factory: CodecFactory) -> None:
    """Register a codec factory: ``factory(cfg)`` with an EngineConfig-like
    object (duck-typed: scheme, n_copies, parity_group, rs_parity)."""
    _CODECS[name] = factory


def get_codec(name: str) -> CodecFactory:
    if name not in _CODECS:
        raise KeyError(f"unknown redundancy codec {name!r}; have {sorted(_CODECS)}")
    return _CODECS[name]


def make_codec(cfg) -> RedundancyCodec:
    """Resolve an EngineConfig to a codec instance. ``cfg.codec`` names it
    explicitly; empty keeps the legacy inference (parity_group>0 -> xor,
    else the full-copy scheme)."""
    name = getattr(cfg, "codec", "") or ("xor" if cfg.parity_group else "copy")
    return get_codec(name)(cfg)


def _striped_waits(name: str) -> CodecFactory:
    def factory(cfg) -> RedundancyCodec:
        raise NotImplementedError(
            f"the host engine's {name!r} codec is not ported yet (ROADMAP A4: striped "
            f"codecs on the host); the device tier runs xor and rs on the card"
        )
    return factory


register_codec("copy", lambda cfg: CopyCodec(cfg.scheme, cfg.n_copies))
for _name in ("xor", "rs", "lrc"):
    register_codec(_name, _striped_waits(_name))
