"""Quickstart on the PyTorch port: train a small LM with diskless pair-wise
checkpointing and survive an injected host failure (``examples/quickstart.py``
line for line, on ``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py               # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # on the CPU
"""

import argparse
import sys

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = ap.parse_args().device

    # 1. Pick the architecture and shrink it so it trains in seconds.
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg)
    print(f"model: {cfg.name}  params={model.n_params:,}")

    # 2. A trainer with 4 virtual failure-domain hosts, 2 spares, and in-memory
    #    pair-wise checkpoints every 5 steps (use checkpoint_period=None for the
    #    Daly-optimal adaptive interval).
    tcfg = TrainerConfig(
        batch=8,
        seq=64,
        total_steps=60,
        checkpoint_period=5,
        lr=3e-3,
        warmup_steps=5,
        n_virtual_hosts=4,
        n_spares=2,
    )

    # 3. Kill host 2 at step 17 — mid-run, between checkpoints.
    injector = FailureInjector(4, schedule={17: [2]})

    trainer = Trainer(model, tcfg, injector=injector, device=device)
    history = trainer.run(60)

    print(f"finished at step {int(trainer.state['step'])} on {trainer.device}")
    print(f"recoveries: {trainer.n_recoveries}")
    print(f"checkpoints: {trainer.engine.stats.created} "
          f"(last took {trainer.engine.stats.last_create_s * 1e3:.1f} ms)")
    first = sum(h["loss"] for h in history[:5]) / 5
    last = sum(h["loss"] for h in history[-5:]) / 5
    print(f"loss: {first:.4f} -> {last:.4f}")
    if not last < first - 0.5:
        sys.exit("FAIL: the loss should fall by 0.5 on the synthetic bigram stream")
    print("OK — survived the failure and kept training.")


if __name__ == "__main__":
    main()
