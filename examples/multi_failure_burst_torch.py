"""Surviving a correlated 2-failure burst with the Reed-Solomon codec, on the
PyTorch port (``examples/multi_failure_burst.py`` line for line, on
``repro_torch``).

Real clusters lose correlated host sets (a rack power domain, a shared
switch) — and a single-parity scheme like XOR cannot survive two concurrent
losses in one group (the exascale gap of Agullo et al., arXiv:2010.13342).
This demo runs the same burst against both codecs:

  1. Engine level: an 8-rank world checkpoints under xor(k=4) and
     rs(k=4, m=2); ranks 1 AND 2 (same parity group) die. XOR raises
     DataLostError; RS rebuilds both shards bit-identically, at half a
     shard of extra memory per rank (m/g = 2/4 vs 1/4).

  2. End to end: a training run where an MTBF-style burst kills two ranks of
     one group mid-flight (FailureInjector.schedule_group_burst); with
     codec="rs" the run recovers and finishes bitwise-identical to a
     fault-free run.

    PYTHONPATH=src python examples/multi_failure_burst_torch.py               # on the card
    PYTHONPATH=src python examples/multi_failure_burst_torch.py --device cpu  # on the CPU
"""

from __future__ import annotations

import argparse
import os
from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.core.distribution import DataLostError
from repro_torch.models import build_model
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.sharding.mesh import resolve_device
from repro_torch.utils.pytree import tree_flatten

STEPS = 20
BURST = dict(step=12, group_index=0, group_size=4, count=2)


class ShardedVec:
    def __init__(self, n: int, dim: int = 4096, device: Any = "cpu") -> None:
        self.n = n
        self.data = [torch.arange(dim, dtype=torch.float32, device=device) + 1000 * r for r in range(n)]

    def snapshot_shards(self, n: int) -> list[dict[str, torch.Tensor]]:
        return [{"v": self.data[r].clone()} for r in range(n)]

    def restore_shards(self, shards: dict[int, Any]) -> None:
        for origin, payload in shards.items():
            self.data[origin] = payload["v"].to(self.data[origin].device, copy=True)


def burst(cfg_name: str, cfg: EngineConfig, device: Any = None) -> dict[str, Any]:
    """Ranks 1 and 2 of group 0 lost at once after one checkpoint. Returns
    the memory report, the ``DataLostError`` (or None) and, on a rebuild,
    whether every shard came back bit for bit and how many were rebuilt."""
    dev = resolve_device(device)
    eng = CheckpointEngine(8, cfg, device=dev)
    vec = ShardedVec(8, device=dev)
    eng.register("state", vec)
    assert eng.checkpoint({"step": 7})
    orig = [d.clone() for d in vec.data]
    rep = eng.memory_report()
    print(
        f"  [{cfg_name}] codec={rep['codec']} tolerance={rep['tolerance']} "
        f"redundancy={rep['redundancy_bytes'][rep['codec']] / 2**10:.0f} KiB "
        f"(overhead {rep['redundancy_overhead']:.2f} bytes/byte)"
    )
    out = {"report": rep, "lost": None, "ok": None, "rebuilt": None}
    for d in vec.data:
        d *= 0.0
    eng.stores[1].wipe()
    eng.stores[2].wipe()  # correlated burst: both in parity group {0..3}
    try:
        eng.restore()
    except DataLostError as e:
        print(f"  [{cfg_name}] LOST after 2-failure burst: {e}")
        out["lost"] = e
        return out
    finally:
        eng.close()
    ok = all(torch.equal(vec.data[r], orig[r]) for r in range(8))
    print(
        f"  [{cfg_name}] recovered bit-identically: {ok} "
        f"({eng.stats.reconstructed_restores} shards rebuilt)"
    )
    assert ok
    out.update(ok=ok, rebuilt=eng.stats.reconstructed_restores)
    return out


def train_through_burst(device: Any = None) -> tuple[Trainer, Trainer, list[int]]:
    """The reduced llama3.2-1b trained STEPS steps on 8 hosts, fault-free and
    through the group burst on rs 4+2 with 4 spares: (fault-free trainer,
    faulty trainer, the doomed ranks)."""
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg)
    base = dict(batch=4, seq=32, total_steps=STEPS, checkpoint_period=5, n_virtual_hosts=8)

    ref = Trainer(model, TrainerConfig(**base), device=device)
    ref.run(STEPS)
    ref.engine.close()

    injector = FailureInjector(8)
    doomed = injector.schedule_group_burst(**BURST)
    print(f"burst kills ranks {doomed} (group 0) at step {BURST['step']}")
    faulty = Trainer(
        model,
        TrainerConfig(
            **base,
            n_spares=4,
            engine=EngineConfig(codec="rs", parity_group=4, rs_parity=2),
        ),
        injector=injector,
        device=device,
    )
    faulty.run(STEPS)
    faulty.engine.close()
    return ref, faulty, doomed


def same_state(a: Any, b: Any) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[1], tree_flatten(b)[1]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = ap.parse_args().device
    if resolve_device(device).type == "cuda":
        # bitwise replay: deterministic kernels, cuBLAS's workspace fixed
        # before its first call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)

    print("=== engine-level burst: xor vs rs ===")
    burst("xor  k=4     ", EngineConfig(parity_group=4), device)
    burst("rs   k=4 m=2 ", EngineConfig(codec="rs", parity_group=4, rs_parity=2), device)

    print("\n=== end-to-end: training through a mid-run group burst (rs, spares) ===")
    ref, faulty, _ = train_through_burst(device)
    same = same_state(ref.state, faulty.state)
    s = faulty.engine.stats
    print(f"recoveries: {faulty.n_recoveries}; restore breakdown: "
          f"{s.zero_comm_restores} zero-comm, {s.reconstructed_restores} RS-rebuilt")
    print(f"final state bitwise-identical to fault-free run: {same}")
    assert same and faulty.n_recoveries >= 1
    print("OK")


if __name__ == "__main__":
    main()
