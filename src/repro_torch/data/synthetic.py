"""Deterministic synthetic data pipeline.

Batch contents derive purely from ``(seed, step)``, so the pipeline's state
is two integers, a checkpoint entity of its own: after a recovery the
pipeline replays exactly the batches from the restored step, which is what
makes the replayed trajectory bitwise identical.

The token stream follows a fixed random bigram permutation (x[t] =
perm[x[t-1]] with 5% noise resets), so the model can reduce its loss on it
quickly. The draws are the reference's, key for key, on the port's
threefry (``utils/threefry.py``): the same ``(seed, step)`` gives the same
int32 tokens as ``repro.data.synthetic``, byte for byte. Batches are made on
the host and moved to the pipeline's device.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.mesh import resolve_device
from repro_torch.utils import threefry

NOISE_P = 0.05


def make_batch(cfg: ModelConfig, seed: int, step: int, batch: int, seq: int) -> dict[str, torch.Tensor]:
    """One global batch (int32 CPU tensors) from (seed, step)."""
    if cfg.is_encoder or cfg.vision_tokens:
        raise NotImplementedError(f"{cfg.name}: encoder and VLM batches wait for ROADMAP A10")
    k1, k2, _ = threefry.split(threefry.fold_in(threefry.PRNGKey(seed), step), 3)
    v = cfg.vocab_size
    # the permutation depends only on the seed: the mapping is stationary
    perm = threefry.permutation(threefry.PRNGKey(seed ^ 0x5EED), v)
    x0 = threefry.randint(k1, (batch,), 0, v)
    noise_mask = threefry.bernoulli(k2, NOISE_P, (batch, seq))
    noise_tok = threefry.randint(threefry.fold_in(k2, 1), (batch, seq), 0, v)
    toks = torch.empty((batch, seq), dtype=torch.int32)
    prev = x0
    for t in range(seq):
        prev = torch.where(noise_mask[:, t], noise_tok[:, t], perm[prev.long()])
        toks[:, t] = prev
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}


class SyntheticDataPipeline:
    """Stateful iterator with Snapshottable (snapshot/restore) semantics;
    batches land on ``device`` (``cuda`` unless the caller asks for another)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0, device: Any = None) -> None:
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = 0
        self.device = resolve_device(device)

    def next(self) -> dict[str, torch.Tensor]:
        b = self.peek(self.step)
        self.step += 1
        return b

    def peek(self, step: int) -> dict[str, torch.Tensor]:
        b = make_batch(self.cfg, self.seed, step, self.batch, self.seq)
        return {k: x.to(self.device) for k, x in b.items()}

    # --- Snapshottable protocol -------------------------------------------
    def snapshot(self) -> dict[str, torch.Tensor]:
        return {"seed": torch.tensor(self.seed, dtype=torch.int64),
                "step": torch.tensor(self.step, dtype=torch.int64)}

    def restore(self, snap: Any) -> None:
        self.seed = int(snap["seed"])
        self.step = int(snap["step"])
