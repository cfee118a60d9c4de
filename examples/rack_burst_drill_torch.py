"""Rack-burst drill on the PyTorch port: surviving the loss of an ENTIRE
failure domain (``examples/rack_burst_drill.py`` step for step, on
``repro_torch``).

  1. **Topology + placement**: a 12-rank world on 6 two-host racks; the
     domain-aware packer guarantees no parity group holds two members of
     one rack, so the burst costs every group at most ONE shard (the
     contiguous layout would put both victims in one group, beyond a
     single-parity budget).
  2. **Correlated injection**: ``FailureInjector.schedule_domain_burst``
     dooms every rank of one rack at the same step; ``VirtualCluster.kill``
     stamps each failure event with its domain label, and
     ``fit_failure_stats`` clusters them into ONE single-domain burst.
  3. **LRC recovery**: the whole-rack burst is recovered bit-identically
     through the in-memory codec tier, with no disk escalation; the
     contiguous xor layout loses data to the same burst; and a
     single-failure repair shows LRC's locality (it reads only the local
     subgroup, not the whole stripe).

    PYTHONPATH=src python examples/rack_burst_drill_torch.py               # on the card
    PYTHONPATH=src python examples/rack_burst_drill_torch.py --device cpu  # on the CPU
"""

import argparse

import numpy as np
import torch

from repro_torch.core import gf256
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.core.codec import LRCCodec, RSCodec
from repro_torch.core.distribution import DataLostError, placement_conflicts
from repro_torch.core.topology import ClusterTopology
from repro_torch.obs.journal import fit_failure_stats
from repro_torch.runtime.cluster import VirtualCluster
from repro_torch.runtime.failures import FailureInjector
from repro_torch.sharding.mesh import resolve_device

N, K, M = 12, 4, 2
DIM = 4096


class ShardedVec:
    """One float32 vector per rank, on ``device``."""

    def __init__(self, n, device, dim=DIM):
        self.n = n
        self.data = [torch.arange(dim, dtype=torch.float32, device=device) + 1000 * r for r in range(n)]

    def snapshot_shards(self, n):
        return [{"v": self.data[r]} for r in range(n)]

    def restore_shards(self, shards):
        for origin, payload in shards.items():
            self.data[origin] = payload["v"].to(self.data[origin].device)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args().device)

    topo = ClusterTopology.regular(N, hosts_per_rack=2)  # 6 racks of 2
    print(f"cluster: {topo!r} on {device}")

    # -- placement: one rack never maps twice into one group ------------- #
    cfg = EngineConfig(codec="lrc", parity_group=K, rs_parity=M, lrc_locals=2, topology=topo)
    eng = CheckpointEngine(N, cfg, device=device)
    vec = ShardedVec(N, device)
    eng.register("state", vec)
    groups = eng._groups()
    assert placement_conflicts(groups, topo) == []
    print(f"groups (domain-aware): {[g.members for g in groups]}")

    rack = topo.domains("rack")[1]
    damage = [sum(1 for r in rack.ranks if r in g.members) for g in groups]
    naive = [sum(1 for r in rack.ranks if r // K == gi) for gi in range(len(groups))]
    print(f"burst {rack.label} = ranks {rack.ranks}: per-group damage "
          f"{damage} (contiguous layout would be {naive})")
    assert max(damage) <= 1 < max(naive)

    # -- correlated injection with domain-labelled journal events -------- #
    cluster = VirtualCluster(N, topology=topo)
    cluster.attach_engine(eng)
    inj = FailureInjector(N)
    doomed = inj.schedule_domain_burst(3, topo, rack.index)
    assert tuple(doomed) == rack.ranks

    assert eng.checkpoint({"step": 3})
    orig = [d.clone() for d in vec.data]
    for d in vec.data:
        d.mul_(0.0)
    for r in inj.kills_at_step(3):
        cluster.kill(r, cause="rack burst")
    evs = eng.journal.events("failure")
    assert {e["domain"] for e in evs} == {rack.label}
    evs[-1]["ts"] = evs[-2]["ts"]  # same arrival instant (one stabilize window)
    stats = fit_failure_stats(eng.journal.events())
    print(f"journal: {stats['failures']} failures, "
          f"{stats['domain_bursts']} single-domain burst(s), "
          f"by_domain={stats['by_domain']}")
    assert stats["domain_bursts"] == 1

    # -- recovery: codec tier only, bit-identical ------------------------ #
    eng.restore()
    for r in range(N):
        assert torch.equal(vec.data[r], orig[r]), r
    assert eng.stats.reconstructed_restores >= len(rack.ranks)
    assert eng.stats.tier_escalations == 0  # never touched a disk rung
    (rec,) = eng.journal.events("recovery")
    assert rec["domains"] == rack.label
    print(f"restored bit-identically: {eng.stats.reconstructed_restores} "
          f"shards rebuilt, {eng.stats.tier_escalations} disk escalations, "
          f"recovery record domains={rec['domains']!r}")

    # the same burst under the contiguous layout at a single-parity budget
    eng_naive = CheckpointEngine(N, EngineConfig(parity_group=K), device=device)
    eng_naive.register("state", ShardedVec(N, device))
    assert eng_naive.checkpoint({"step": 3})
    for r in rack.ranks:
        eng_naive.stores[r].wipe()
    try:
        eng_naive.restore()
        raise AssertionError("contiguous xor survived a rack burst")
    except DataLostError as e:
        print(f"contiguous xor layout, same burst: LOST ({e})")

    # -- LRC repair locality --------------------------------------------- #
    k, l = 6, 2
    bufs = [torch.from_numpy(np.frombuffer(np.random.default_rng(s).bytes(1 << 16), np.uint8).copy())
            for s in range(k)]
    readings = {}
    with gf256.compute_device(device):
        for name, codec in (("lrc", LRCCodec(k, l, M)), ("rs", RSCodec(k, M))):
            blobs = dict(enumerate(codec.encode(list(bufs), codec.n_blobs(k))))
            present = {i: bufs[i] for i in range(k) if i != 2}
            # decode_into is the engine's chunked path: it carries the
            # repair-read accounting
            out, chunk = codec.decode_into(present, blobs, [2], lambda i, n: torch.zeros(n, dtype=torch.uint8))
            chunk(0, max(b.numel() for b in blobs.values()))
            assert torch.equal(out[2][: bufs[2].numel()], bufs[2])
            readings[name] = codec.last_decode_reads
    print(f"single-failure repair reads: lrc={readings['lrc']} sources vs "
          f"rs={readings['rs']} (local subgroup vs whole stripe)")
    assert readings["lrc"] < readings["rs"]
    print("rack-burst drill PASSED")


if __name__ == "__main__":
    main()
