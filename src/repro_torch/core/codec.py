"""The pluggable redundancy-codec layer (port of ``repro.core.codec``).

Every redundancy scheme is a ``RedundancyCodec``: a pure object that knows
how to partition the rank space into **groups** (``group_size``), turn a
group's serialized shards into **redundancy blobs** (``encode``), decide
**where** each blob's stripes live (``placement``), rebuild missing shards
from survivors + blobs (``decode``), and state its **tolerance**.
``CheckpointEngine`` dispatches distribution and recovery through this
interface only.

Provided codecs:

  * ``copy`` — the paper's full-copy schemes: each rank is its own group of
    one, and the "blobs" are R whole copies placed on the scheme's shifted
    partners (Algorithm 1's pairwise N/2 shift, ``neighbor``, R evenly
    spaced copies).
  * ``xor``  — Plank-style single parity: one XOR blob per group, striped
    across the next group. Tolerates 1 loss per group.
  * ``rs``   — Reed-Solomon over GF(2^8) (``core/gf256.py``): m Cauchy
    parity blobs per group of k, blob b striped across neighbor group
    gi+1+b. Tolerates any m concurrent losses per group while the holder
    groups are intact.
  * ``lrc``  — Azure-style local reconstruction code: l local XOR parities
    over subgroups of ceil(k/l) members plus g global Cauchy parities.
    Tolerance g, but a single loss reads only its local subgroup.

Buffers are ``torch.uint8`` CPU tensors (the engine's arenas). The striped
codecs' encode and chunked decode are GF(2^8) matrix products through
``gf256.gf_matrix_addmul_into``, on the card when the active backend is
``torch``. Group-local shard indices are used throughout ``encode`` and
``decode``; the engine maps them to ranks through the group list.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import distribution as dist
from repro_torch.core import gf256
from repro_torch.core import parity as parity_mod


class CodecDecodeError(RuntimeError):
    """Decode is impossible with the surviving shards + blobs (the engine
    wraps this into distribution.DataLostError with placement context)."""


class RedundancyCodec:
    """Interface contract (``repro.core.codec.RedundancyCodec``):

    encode(bufs, n_out)   k group-local byte buffers -> n_out redundancy
                          blobs, each ``placement()``-striped by the engine.
                          Buffers may be ragged; blobs are padded to the
                          4-aligned max (zero padding must be free).
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

    decode_into(present, blobs, missing, lease)
                          the pipelined restore's form of ``decode``: the
                          rebuilt buffers (``lease(i, nbytes)``-backed) and
                          a chunk function (lo, hi) that rebuilds that byte
                          range (the default decodes eagerly and returns a
                          no-op chunk function).
    encode_into, encode_matrix, blobs_needed, decode_chunked
                          the arena-aware encode, its GF(2^8) generator
                          (licensing chunked encodes), the blobs a decode
                          reads, and whether ``decode_into`` defers its byte
                          passes to the chunk function.
    """

    name: str = "?"
    #: blobs are striped across holder groups (False: whole copies on ranks)
    striped: bool = True
    #: the engine may int8-compress the group's buffers before encode; for
    #: striped codecs it then stores each member's compressed exchange set in
    #: ``own_exch`` (parity of compressed bytes decodes only against them)
    compressible: bool = False

    def group_size(self, n_ranks: int) -> int:
        raise NotImplementedError

    def n_blobs(self, group_size: int) -> int:
        raise NotImplementedError

    def tolerance(self) -> int:
        raise NotImplementedError

    def encode(self, bufs: list[torch.Tensor], n_out: int) -> list[torch.Tensor]:
        raise NotImplementedError

    def encode_into(
        self, bufs: list[torch.Tensor], n_out: int, lease: Callable[[int, int], torch.Tensor]
    ) -> list[torch.Tensor]:
        """Arena-aware encode: ``lease(b, nbytes)`` hands back a reusable
        uint8 accumulator for blob ``b``. Default: the allocating
        ``encode``, so user codecs keep working unchanged."""
        return self.encode(bufs, n_out)

    def encode_matrix(self, k: int) -> np.ndarray | None:
        """The (n_out, k) GF(2^8) generator behind ``encode`` for a group of
        ``k`` members, or None when the encode is not a pure GF matrix
        product. A matrix licenses the engine's chunked encode
        (``blob[lo:hi] = G · bufs[:, lo:hi]``), bit-identical to ``encode``."""
        return None

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

    def decode_into(
        self,
        present: dict[int, torch.Tensor],
        blobs: dict[int, torch.Tensor],
        missing: list[int],
        lease: Callable[[int, int], torch.Tensor],
    ) -> tuple[dict[int, torch.Tensor], Callable[[int, int], None]]:
        """Default: the eager ``decode`` with a no-op chunk function."""
        return self.decode(present, blobs, missing), (lambda lo, hi: None)

    def decode_chunked(self) -> bool:
        """True when ``decode_into`` defers its byte passes to the returned
        chunk function (the engine streams blob TRANSFERs ahead of each
        chunk's DECODE); False when it reads the blob bytes at call time,
        in which case the engine materializes every blob first. Must mirror
        the ``decode_into`` dispatch: the built-in codecs share
        ``_decode_overridden`` between the two."""
        return False

    def _decode_overridden(self, base: type) -> bool:
        """True when a subclass replaced ``base``'s ``decode``: it is then
        honored by the eager allocating path."""
        return type(self).decode is not base.decode

    def blobs_needed(
        self, present_idx: list[int], blob_idx: list[int], missing: list[int]
    ) -> set[int] | None:
        """Blob indices the decode will actually read, or None for all of
        them. Group codecs narrow this through their row selection."""
        return None

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

    def memory_overhead(self, group_size: int, n_ranks: int) -> float:
        """Redundancy bytes stored per data byte (eq. 2-style accounting)."""
        return self.n_blobs(group_size) / max(group_size, 1)


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

    def n_blobs(self, group_size: int) -> int:
        return self.n_copies

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

    def memory_overhead(self, group_size, n_ranks):
        # the copies actually stored: multi_copy_shifts dedupes small worlds
        return float(len(self.holders(n_ranks, 0)))

    def encode(self, bufs, n_out):
        assert len(bufs) == 1
        return [bufs[0]] * n_out  # references: R copies of the same bytes

    def decode(self, present, blobs, missing):
        if missing and not blobs:
            raise CodecDecodeError("origin and every holder of its copies failed")
        return {i: blobs[min(blobs)] for i in missing}

    def decode_chunked(self):
        # adoption reads no blob bytes at call time
        return not self._decode_overridden(CopyCodec)

    def decode_into(self, present, blobs, missing, lease):
        # adoption by reference: no arena, nothing to chunk
        if self._decode_overridden(CopyCodec):
            return super().decode_into(present, blobs, missing, lease)
        return self.decode(present, blobs, missing), (lambda lo, hi: None)

    def rebuilder(self, groups, gi, origin, alive):
        for holders in self.placement(groups, gi, max(g.members[-1] for g in groups) + 1):
            if holders[0] in alive:
                return holders[0]  # first alive holder, scheme order
        return None


# ---------------------------------------------------------------------------
# group erasure codecs — XOR (m=1), Reed-Solomon (any m), LRC
# ---------------------------------------------------------------------------

class GroupCodecBase(RedundancyCodec):
    """Shared plumbing for group-structured erasure codecs: groups of
    ``group`` ranks, blob b striped across neighbor group gi+1+b (wrapping,
    skipping gi itself unless it is the only group in the world). They
    compress too: the engine then stores the compressed exchange set in
    ``own_exch``, so survivors present the exact bytes parity encoded."""

    compressible = True

    def __init__(self, group: int) -> None:
        assert group >= 1, group
        self.group = group

    def group_size(self, n_ranks: int) -> int:
        return self.group

    def _generator(self) -> np.ndarray:
        """The (m, group) GF(2^8) encode generator (XOR: the all-ones row)."""
        raise NotImplementedError

    def _decode_rows(self, blob_idx: list[int], missing: list[int], present_idx: list[int]) -> list[int]:
        """Which surviving blob rows the decode solves through. Default: the
        first ``len(missing)`` (any e rows of an MDS generator invert). LRC
        overrides it with read-cost-ordered selection; the decode, the
        engine's blob-TRANSFER skip (``blobs_needed``) and the device
        restore's row precompute all use it."""
        return blob_idx[: len(missing)]

    def blobs_needed(self, present_idx, blob_idx, missing):
        """Blob indices the decode will read; the engine skips the TRANSFER
        of the others. None (all) when no row set solves the losses, so the
        decode raises the real error."""
        if not missing:
            return set()
        try:
            return set(self._decode_rows(sorted(blob_idx), missing, present_idx))
        except CodecDecodeError:
            return None

    def _matrix_decode_into(self, present, blobs, missing, lease):
        """Chunked decode through the precomputed erasure decode matrix
        (``gf256.erasure_decode_matrix``): the e×e elimination runs once on
        the coefficients, then every byte range is one matrix product over
        [survivors ‖ chosen blobs] through the GF backend, into the leased
        outputs; bit-identical to ``decode`` (the GF solution is unique).
        Survivors with an all-zero column are never read (LRC's local
        repairs read their subgroup only)."""
        e = len(missing)
        if e == 0:
            return {}, (lambda lo, hi: None)
        k = self.group
        coef = self._generator()
        rows = self._decode_rows(sorted(blobs), missing, sorted(present))
        n = max(b.numel() for b in blobs.values())
        present_idx = sorted(present)
        D = gf256.erasure_decode_matrix(k, coef, present_idx, rows, missing)
        src_idx = [s for s in present_idx if any(int(D[t, s]) for t in range(e))]
        srcs = [present[s].reshape(-1) for s in src_idx] + [blobs[j].reshape(-1) for j in rows]
        mat = tuple(
            tuple(int(D[t, s]) for s in src_idx) + tuple(int(D[t, k + j]) for j in rows)
            for t in range(e)
        )
        # repair-read accounting (padded-size units: every source one scan)
        self.last_decode_reads = len(srcs)
        self.last_decode_read_bytes = len(srcs) * n
        out = {i: lease(i, n) for i in missing}
        dsts = [out[i] for i in missing]

        def decode_chunk(lo: int, hi: int) -> None:
            hi = min(hi, n)
            if lo < hi:
                gf256.gf_matrix_addmul_into(dsts, srcs, mat, lo, hi)

        return out, decode_chunk

    def placement(self, groups, gi, n_ranks):
        return [
            groups[dist.blob_holder_group(len(groups), gi, b)].members
            for b in range(self.n_blobs(len(groups[gi].members)))
        ]


class XorCodec(GroupCodecBase):
    name = "xor"

    def n_blobs(self, group_size: int) -> int:
        return 1

    def tolerance(self) -> int:
        return 1

    def encode(self, bufs, n_out):
        assert n_out == 1
        return [parity_mod.encode_parity(bufs)]

    def encode_into(self, bufs, n_out, lease):
        if type(self).encode is not XorCodec.encode:
            return self.encode(bufs, n_out)  # a subclass's encode: allocating path
        assert n_out == 1
        out = lease(0, parity_mod.parity_nbytes(bufs))
        return [parity_mod.encode_parity(bufs, out=out)]

    def encode_matrix(self, k):
        if type(self).encode is not XorCodec.encode:
            return None  # custom encode: no provable generator
        return np.ones((1, k), np.uint8)

    def decode(self, present, blobs, missing):
        if len(missing) > 1:
            raise CodecDecodeError(f"{len(missing)} losses in one group; XOR tolerates 1")
        if not missing:
            return {}
        if 0 not in blobs:
            raise CodecDecodeError("XOR parity blob lost")
        rebuilt = parity_mod.reconstruct([b.reshape(-1) for b in present.values()], blobs[0])
        return {missing[0]: rebuilt}

    def _generator(self):
        return np.ones((1, self.group), np.uint8)

    def decode_chunked(self):
        return not self._decode_overridden(XorCodec)

    def decode_into(self, present, blobs, missing, lease):
        if self._decode_overridden(XorCodec):
            return super().decode_into(present, blobs, missing, lease)
        if len(missing) > 1:
            raise CodecDecodeError(f"{len(missing)} losses in one group; XOR tolerates 1")
        if missing and 0 not in blobs:
            raise CodecDecodeError("XOR parity blob lost")
        return self._matrix_decode_into(present, blobs, missing, lease)


class RSCodec(GroupCodecBase):
    name = "rs"

    def __init__(self, group: int, m: int = 2) -> None:
        super().__init__(group)
        assert m >= 1 and group + m <= 255, (group, m)
        self.m = m
        self.coef = gf256.cauchy_matrix(m, group)  # sliced for ragged groups

    def n_blobs(self, group_size: int) -> int:
        return self.m

    def tolerance(self) -> int:
        return self.m

    def encode(self, bufs, n_out):
        assert n_out == self.m
        return gf256.rs_encode(bufs, self.m, self.coef)

    def encode_into(self, bufs, n_out, lease):
        if type(self).encode is not RSCodec.encode:
            return self.encode(bufs, n_out)  # a subclass's encode: allocating path
        assert n_out == self.m
        n = gf256.padded_len(bufs)
        return gf256.rs_encode(bufs, self.m, self.coef, out=[lease(b, n) for b in range(self.m)])

    def encode_matrix(self, k):
        if type(self).encode is not RSCodec.encode:
            return None  # custom encode: no provable generator
        return self.coef[:, :k]

    def decode(self, present, blobs, missing):
        if len(missing) > self.m:
            raise CodecDecodeError(f"{len(missing)} losses in one group; rs(m={self.m}) tolerates {self.m}")
        try:
            return gf256.rs_decode(present, blobs, missing, self.group, self.coef)
        except ValueError as e:
            raise CodecDecodeError(str(e)) from e

    def _generator(self):
        return self.coef

    def decode_chunked(self):
        return not self._decode_overridden(RSCodec)

    def decode_into(self, present, blobs, missing, lease):
        if self._decode_overridden(RSCodec):
            return super().decode_into(present, blobs, missing, lease)
        if len(missing) > self.m:
            raise CodecDecodeError(f"{len(missing)} losses in one group; rs(m={self.m}) tolerates {self.m}")
        if missing and len(blobs) < len(missing):
            raise CodecDecodeError(
                f"need {len(missing)} parity blobs to rebuild {len(missing)} shards, only {len(blobs)} survive")
        return self._matrix_decode_into(present, blobs, missing, lease)


def lrc_generator(group: int, local: int, global_parity: int) -> np.ndarray:
    """The Azure-LRC generator shared by :class:`LRCCodec` and the device
    tier's encode and restore: ``local`` 0/1 indicator rows over contiguous
    subgroups of ``ceil(group/local)`` columns, over ``global_parity``
    Cauchy rows spanning all columns."""
    local = min(local, group)
    k_local = -(-group // local)
    gen = np.zeros((local + global_parity, group), np.uint8)
    for j in range(local):
        gen[j, j * k_local : min((j + 1) * k_local, group)] = 1
    gen[local:] = gf256.cauchy_matrix(global_parity, group)
    return gen


class LRCCodec(GroupCodecBase):
    """Azure-style local reconstruction code: rows 0..l-1 are local XOR
    parities over subgroups of k_local = ceil(k/l) columns, rows l..l+g-1
    global Cauchy parities over all k. Guaranteed tolerance g; a single loss
    solves through one local parity and reads k_local sources, not k.
    Spread losses beyond g still decode when an invertible row set
    survives."""

    name = "lrc"

    def __init__(self, group: int, local: int = 2, global_parity: int = 2) -> None:
        super().__init__(group)
        assert local >= 1 and global_parity >= 1, (local, global_parity)
        assert group + global_parity <= 255, (group, global_parity)
        self.local = min(local, group)  # l > k would mint empty subgroups
        self.global_parity = global_parity
        self.k_local = -(-group // self.local)
        self.coef = lrc_generator(group, self.local, global_parity)

    def n_blobs(self, group_size: int) -> int:
        return self.local + self.global_parity

    def tolerance(self) -> int:
        return self.global_parity

    def memory_overhead(self, group_size, n_ranks):
        # a short group's local rows past its members are all zero
        k = max(min(group_size, self.group), 1)
        l_eff = -(-k // self.k_local)
        return (l_eff + self.global_parity) / k

    def encode(self, bufs, n_out):
        assert n_out == self.n_blobs(len(bufs))
        return gf256.rs_encode(bufs, n_out, self.coef)

    def encode_into(self, bufs, n_out, lease):
        if type(self).encode is not LRCCodec.encode:
            return self.encode(bufs, n_out)  # a subclass's encode: allocating path
        assert n_out == self.n_blobs(len(bufs))
        n = gf256.padded_len(bufs)
        return gf256.rs_encode(bufs, n_out, self.coef, out=[lease(b, n) for b in range(n_out)])

    def _generator(self):
        return self.coef

    def encode_matrix(self, k):
        if type(self).encode is not LRCCodec.encode:
            return None  # custom encode: no provable generator
        return self.coef[:, :k]

    def _row_support(self, j: int) -> set[int]:
        return {int(s) for s in np.nonzero(self.coef[j])[0]}

    def _decode_rows(self, blob_idx, missing, present_idx):
        """Cheapest invertible row combination: candidate row sets of size e
        ordered by how many surviving sources the union of their supports
        reads; the first whose e×e submatrix inverts wins."""
        from itertools import combinations

        e = len(missing)
        pset = set(present_idx)
        scored = sorted(
            ((len(set().union(*(self._row_support(j) for j in rows)) & pset), rows)
             for rows in combinations(sorted(blob_idx), e)),
            key=lambda cr: (cr[0], cr[1]),
        )
        for _cost, rows in scored:
            try:
                gf256.gf_matrix_inverse(self.coef[np.ix_(list(rows), list(missing))])
            except ValueError:
                continue
            return list(rows)
        raise CodecDecodeError(
            f"lrc(k={self.group},l={self.local},g={self.global_parity}): no invertible row set "
            f"among surviving blobs {sorted(blob_idx)} for losses {sorted(missing)}")

    def decode(self, present, blobs, missing):
        if not missing:
            return {}
        if len(blobs) < len(missing):
            raise CodecDecodeError(
                f"need {len(missing)} redundancy blobs to rebuild {len(missing)} shards, only {len(blobs)} survive")
        out, chunk = self._matrix_decode_into(present, blobs, missing,
                                              lambda i, n: torch.zeros(n, dtype=torch.uint8))
        chunk(0, max(b.numel() for b in blobs.values()))
        return out

    def decode_chunked(self):
        return not self._decode_overridden(LRCCodec)

    def decode_into(self, present, blobs, missing, lease):
        if self._decode_overridden(LRCCodec):
            return super().decode_into(present, blobs, missing, lease)
        if missing and len(blobs) < len(missing):
            raise CodecDecodeError(
                f"need {len(missing)} redundancy blobs to rebuild {len(missing)} shards, only {len(blobs)} survive")
        return self._matrix_decode_into(present, blobs, missing, lease)


# ---------------------------------------------------------------------------
# registry (user-extensible, mirrors distribution.register_scheme)
# ---------------------------------------------------------------------------

CodecFactory = Callable[..., RedundancyCodec]
_CODECS: dict[str, CodecFactory] = {}


def register_codec(name: str, factory: CodecFactory) -> None:
    """Register a codec factory: ``factory(cfg)`` with an EngineConfig-like
    object (duck-typed: scheme, n_copies, parity_group, rs_parity,
    lrc_locals)."""
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


def _require_group(cfg, name: str) -> int:
    # an explicit group codec needs its group size k: a guessed one could
    # leave a single-group world with no protection
    if cfg.parity_group < 1:
        raise ValueError(f"codec {name!r} requires parity_group >= 1 (the group size k)")
    return cfg.parity_group


register_codec("copy", lambda cfg: CopyCodec(cfg.scheme, cfg.n_copies))
register_codec("xor", lambda cfg: XorCodec(_require_group(cfg, "xor")))
register_codec("rs", lambda cfg: RSCodec(_require_group(cfg, "rs"), getattr(cfg, "rs_parity", 2)))
register_codec(
    "lrc",
    lambda cfg: LRCCodec(_require_group(cfg, "lrc"), getattr(cfg, "lrc_locals", 2), getattr(cfg, "rs_parity", 2)),
)


# ---------------------------------------------------------------------------
# recovery planning (Algorithm 4 generalized to any codec)
# ---------------------------------------------------------------------------

def codec_recovery_plan(
    n_prev: int,
    failed: set[int],
    codec: RedundancyCodec,
    groups: list[dist.ParityGroup] | None = None,
) -> dict[int, int]:
    """origin_prev_rank -> new dense rank that restores its blocks, for any
    codec. Raises ``distribution.DataLostError`` when the failure set
    exceeds a group's tolerance or destroys the blobs needed to cover its
    losses. ``failed`` is the plan's whole world view (include alive but
    empty stores); ``groups`` overrides the contiguous partition."""
    reassign = dist.shrink_reassignment(n_prev, failed)
    alive = {r for r in range(n_prev) if r not in failed}
    if groups is None:
        groups = dist.parity_groups(n_prev, codec.group_size(n_prev))
    gi_of = dist.rank_group_map(groups)
    plan: dict[int, int] = {}
    for origin in range(n_prev):
        if origin not in failed:
            plan[origin] = reassign[origin]
            continue
        gi = gi_of[origin]
        missing = [m for m in groups[gi].members if m in failed]
        if len(missing) > codec.tolerance():
            raise dist.DataLostError(
                f"group {gi} lost {len(missing)} members; codec {codec.name!r} tolerates {codec.tolerance()}")
        # a blob survives iff every holder of its stripes survives
        blobs_alive = sum(all(h not in failed for h in holders) for holders in codec.placement(groups, gi, n_prev))
        if blobs_alive < len(missing):
            raise dist.DataLostError(
                f"group {gi}: {len(missing)} losses but only {blobs_alive} intact redundancy blobs "
                f"(codec {codec.name!r})")
        host = codec.rebuilder(groups, gi, origin, alive)
        if host is None:
            raise dist.DataLostError(f"no surviving rank can rebuild rank {origin}")
        plan[origin] = reassign[host]
    return plan
