"""Differential-checkpointing drill on the PyTorch port: delta commits, a
mid-flush kill, a lost chunk object and a cold restart resolved through the
content-addressed chunk store (``examples/delta_drill.py`` step for step,
on ``repro_torch``).

  1. **Delta commits**: an 8-rank engine with ``delta=True`` runs four
     commits of ~5% contiguous churn; the dirty map reports a small dirty
     fraction, the rs codec patches its parity in place
     (``delta_encodes > 0``) and the transfer skips the clean chunks.
  2. **Dedup flushes**: the disk rung runs with ``dedup=True``, so a flush
     writes only the chunks the store lacks (reuse > 0, stored/logical < 1).
  3. **Mid-flush kill**: a flush dying while it streams delta rank files
     leaves only invisible wreckage; a generation torn after its commit (a
     chunk object lost) falls back to the previous one, byte for byte.
  4. **Cold 8 -> 6 restart**: every store wiped, a fresh 6-rank engine
     restores the 8-rank state through chunk references across
     generations, byte for byte.

    PYTHONPATH=src python examples/delta_drill_torch.py               # on the card
    PYTHONPATH=src python examples/delta_drill_torch.py --device cpu  # on the CPU
"""

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.core import storage
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.sharding.mesh import resolve_device

N, K, M = 8, 4, 2
DIM = 1 << 16          # floats per rank (256 KiB)
CHUNK = 1 << 14


class ShardedVec:
    """One float32 vector per rank, on ``device``."""

    def __init__(self, n, device, dim=DIM, seed=0):
        self.n = n
        self.data = [
            torch.from_numpy(np.random.default_rng(seed + r).standard_normal(dim).astype(np.float32)).to(device)
            for r in range(n)
        ]

    def snapshot_shards(self, n):
        return [{"v": self.data[r]} for r in range(n)]

    def restore_shards(self, shards):
        for origin, payload in shards.items():
            self.data[origin] = payload["v"].to(self.data[origin].device)


def churn(vec, rng, frac=0.05):
    """A contiguous ~frac run per rank: the low-churn training step."""
    for d in vec.data:
        m = max(1, int(d.numel() * frac))
        start = int(rng.integers(0, d.numel() - m + 1))
        d[start : start + m] += torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(d.device)


def mk_engine(tier_dir, device, n=N):
    return CheckpointEngine(
        n,
        EngineConfig(codec="rs", parity_group=K, rs_parity=M, delta=True, delta_chunk_bytes=CHUNK,
                     tiers=(storage.disk(tier_dir, every=1, dedup=True, chunk_bytes=CHUNK),)),
        device=device,
    )


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args().device)
    tmp = tempfile.mkdtemp(prefix="delta-drill-")
    tier_dir = os.path.join(tmp, "tier")
    try:
        rng = np.random.default_rng(7)
        eng = mk_engine(tier_dir, device)
        vec = ShardedVec(N, device)
        eng.register("domain", vec)

        # -- 1+2: delta commits through the dedup rung -------------------- #
        states = {}
        for step in range(1, 5):
            churn(vec, rng)
            assert eng.checkpoint({"step": step}), f"commit {step} failed"
            eng._join_flush()
            states[step] = [d.clone() for d in vec.data]
        stats = eng.stats
        print(f"4 commits: dirty_fraction={stats.last_dirty_fraction:.3f} "
              f"delta_encodes={stats.delta_encodes} full_encodes={stats.full_encodes} "
              f"patched_ranges={stats.last_delta_ranges} "
              f"transfer_skipped={stats.last_transfer_bytes_skipped}B")
        print(f"last flush: chunks_written={stats.last_flush_chunks_written} "
              f"chunks_reused={stats.last_flush_chunks_reused} dedup_ratio={stats.last_dedup_ratio:.3f}")
        assert stats.delta_encodes > 0, "the striped codec never took the delta path"
        assert 0.0 < stats.last_dirty_fraction < 0.5, "the dirty map missed the low churn"
        assert stats.last_transfer_bytes_skipped > 0, "the transfer skip is inactive"
        assert stats.last_flush_chunks_reused > 0, "the dedup flush reused nothing"
        assert stats.last_dedup_ratio < 1.0

        # -- 3a: a flush killed mid-delta-write ---------------------------- #
        tier = eng.persistent_tiers[0]
        gens_before = tier.generations()
        real_write = storage.write_rank_delta_file
        calls = {"n": 0}

        def dying_write(path, payload, store, **kw):
            calls["n"] += 1
            if calls["n"] > 3:
                raise OSError("simulated kill mid-delta-flush")
            return real_write(path, payload, store, **kw)

        storage.write_rank_delta_file = dying_write
        try:
            died = False
            try:
                tier.flush(storage.capture_snapshot(eng))
            except OSError:
                died = True
        finally:
            storage.write_rank_delta_file = real_write
        assert died, "the dying flush did not die"
        assert tier.generations() == gens_before, "the mid-flush kill tore a generation"
        print(f"mid-flush kill: generations intact {tier.generations()}")

        # -- 3b: a torn committed generation falls back, never corrupts ---- #
        g_prev, g_new = tier.generations()[-2], tier.generations()[-1]
        only_new = tier._chunk_refs(g_new) - tier._chunk_refs(g_prev)
        assert only_new, "the churned generation shares every chunk"
        victim = sorted(only_new)[0]
        os.unlink(os.path.join(tier.path, "chunks", victim[:2], victim + ".chunk"))
        for r in range(N):
            eng.stores[r].wipe()
        churn(vec, rng, frac=1.0)             # scramble the live state
        meta = eng.restore()
        assert meta["step"] == g_prev, f"torn gen {g_new} should fall back to {g_prev}, got step {meta['step']}"
        assert same(vec.data, states[g_prev]), "the fallen-back restore differs"
        print(f"torn gen {g_new}: fell back to gen {g_prev}, byte for byte")
        eng.close()

        # -- 4: cold 8 -> 6 restart through the chunk store ---------------- #
        eng2 = mk_engine(tier_dir, device, n=6)
        vec2 = ShardedVec(N, device, seed=99)   # the old world's shard map, wrong data
        eng2.register("domain", vec2)
        meta = eng2.restore_elastic(6)
        want = meta["step"]
        assert eng2.stats.tier_escalations == 1
        assert same(vec2.data, states[want]), "the cold N->M restore differs"
        print(f"cold 8->6 restart: step {want} resolved through the chunk store, byte for byte")
        eng2.close()
        print("delta drill PASSED")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
