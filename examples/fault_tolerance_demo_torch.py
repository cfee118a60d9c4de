"""The paper's §7.5 experiment (Fig. 8) as a runnable demo on the PyTorch
port (``examples/fault_tolerance_demo.py`` act for act, on ``repro_torch``):
a training run of the reduced mixtral-8x7b (MoE: the scheme is
architecture-agnostic) where hosts are killed mid-flight, one of them
DURING checkpoint creation, and the run recovers every time, ending
bitwise-identical to a fault-free run.

    PYTHONPATH=src python examples/fault_tolerance_demo_torch.py               # on the card
    PYTHONPATH=src python examples/fault_tolerance_demo_torch.py --device cpu  # on the CPU

``--cold-restart`` exercises the storage-tier ladder instead, on the reduced
llama3.2-1b: the trainer runs with a background disk rung, the whole "job"
dies mid-run (every in-memory snapshot with it), and a FRESH trainer on a
*different* world size restarts from the newest disk generation via the
elastic N-to-M path, finishing bitwise-identical to the fault-free run.
On the card both acts run under ``torch.use_deterministic_algorithms(True)``.
"""

import argparse
import os
import shutil
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.checkpoint import EngineConfig
from repro_torch.models import build_model
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.sharding.mesh import resolve_device
from repro_torch.utils.pytree import tree_flatten


def _bitwise(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[1], tree_flatten(b)[1]))


def cold_restart_demo(device) -> None:
    steps, kill_at = 30, 18
    model = build_model(get_config("llama3.2-1b").reduced())
    base = dict(batch=4, seq=32, total_steps=steps, checkpoint_period=5)

    print("=== reference run (no faults, 8 hosts) ===")
    ref = Trainer(model, TrainerConfig(n_virtual_hosts=8, **base), device=device)
    ref.run(steps)
    ref.engine.close()

    tier_dir = tempfile.mkdtemp(prefix="tier-demo-")
    try:
        print(f"\n=== job A: 8 hosts, disk tier at {tier_dir}, killed at step {kill_at} ===")
        a = Trainer(model, TrainerConfig(n_virtual_hosts=8, tier_dir=tier_dir, disk_flush_every=1, **base),
                    device=device)
        a.run(kill_at)          # the whole job "dies" here: every in-memory
        a.engine.close()        # snapshot is gone, only the disk tier survives
        flushed = a.engine.persistent_tiers[0].generations()
        print(f"job A dead at step {kill_at}; disk generations on disk: {flushed}")
        del a

        print("\n=== job B: FRESH trainer on 6 hosts, cold restart from the disk tier (8->6) ===")
        b = Trainer(model, TrainerConfig(n_virtual_hosts=6, tier_dir=tier_dir, disk_flush_every=1, **base),
                    device=device)
        meta = b.cold_restart()
        print(f"resumed from flushed step {meta.get('step')} (escalations: {b.engine.stats.tier_escalations})")
        b.run(steps)
        b.engine.close()
        same = _bitwise(ref.state, b.state)
        print(f"final state bitwise-identical to fault-free run: {same}")
        assert same
        print("OK")
    finally:
        shutil.rmtree(tier_dir, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--cold-restart", action="store_true",
                    help="kill the job mid-run and restart a fresh trainer from the disk tier (elastic 8->6)")
    args = ap.parse_args()
    if resolve_device(args.device).type == "cuda":
        # bitwise replay: deterministic kernels, cuBLAS's workspace fixed
        # before its first call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    if args.cold_restart:
        cold_restart_demo(args.device)
        return

    steps = 40
    model = build_model(get_config("mixtral-8x7b").reduced())  # MoE: the scheme is arch-agnostic
    base = dict(batch=4, seq=48, total_steps=steps, checkpoint_period=6, n_virtual_hosts=8)

    print("=== reference run (no faults) ===")
    t0 = time.perf_counter()
    ref = Trainer(model, TrainerConfig(**base), device=args.device)
    ref.run(steps)
    ref.engine.close()
    t_ref = time.perf_counter() - t0
    print(f"completed in {t_ref:.1f}s")

    # Ranks 1 and 6 are NOT pair-wise partners (1<->5, 6<->2), so both blocks
    # stay recoverable. Killing a rank AND its partner at once (e.g. 1&5) is
    # unrecoverable under R=1: the engine raises DataLostError, as the
    # paper's Algorithm 4 specifies.
    print("\n=== faulty run: kill ranks 1&6 at step 14, rank 3 at step 29, and rank 0 "
          "DURING the 4th checkpoint ===")
    injector = FailureInjector(8, schedule={14: [1, 6], 29: [3]}, checkpoint_schedule={3: [0]})
    t0 = time.perf_counter()
    faulty = Trainer(model, TrainerConfig(**base, n_spares=8, engine=EngineConfig(validate=True)),
                     injector=injector, device=args.device)
    faulty.run(steps)
    faulty.engine.close()
    t_faulty = time.perf_counter() - t0

    same = _bitwise(ref.state, faulty.state)
    s = faulty.engine.stats
    print(f"completed in {t_faulty:.1f}s ({t_faulty / t_ref:.2f}x the clean run)")
    print(f"recoveries: {faulty.n_recoveries}  aborted checkpoints: {s.aborted}")
    print(f"restore breakdown: {s.zero_comm_restores} zero-comm, {s.adopted_restores} adopted")
    print(f"final state bitwise-identical to fault-free run: {same}")
    assert same
    print("OK")


if __name__ == "__main__":
    main()
