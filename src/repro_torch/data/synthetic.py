"""Deterministic synthetic data pipeline.

Batch contents derive purely from ``(seed, step)``, so the pipeline's state
is two integers, a checkpoint entity of its own: after a recovery the
pipeline replays exactly the batches from the restored step, which is what
makes the replayed trajectory bitwise identical.

The token stream follows a fixed random bigram permutation (x[t] =
perm[x[t-1]] with 5% noise resets), so the model can reduce its loss on it
quickly. The encoder's batch is frame embeddings, random labels and a
HuBERT-style masked-prediction mask (8% of the positions); the VLM's adds a
vision stub of patch embeddings to the token stream. The draws are the
reference's, key for key, on the port's threefry (``utils/threefry.py``):
the same ``(seed, step)`` gives the same int32 tokens and labels and the
same mask as ``repro.data.synthetic``, byte for byte, and normals within
``threefry.normal``'s few ulp. Batches are made on the host and moved to
the pipeline's device.

On a process mesh (``mesh=``, with the model's ``rules``) every process
draws the same global batch from ``(seed, step)`` and keeps its block of
each input as ``dims_to_pspec`` lays it out (``BATCH_DIMS``: the batch dim
over the data axes), a DTensor.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.axes import dims_to_pspec
from repro_torch.sharding.mesh import distribute, resolve_device
from repro_torch.utils import threefry

NOISE_P = 0.05

# logical dims of the batch inputs
BATCH_DIMS = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "mask": ("batch", "seq"),
    "frames": ("batch", "seq", None),
    "vision": ("batch", "vision", None),
}


def make_batch(cfg: ModelConfig, seed: int, step: int, batch: int, seq: int) -> dict[str, torch.Tensor]:
    """One global batch (CPU tensors) from (seed, step)."""
    k1, k2, k3 = threefry.split(threefry.fold_in(threefry.PRNGKey(seed), step), 3)
    if cfg.is_encoder:
        return {"frames": threefry.normal(k1, (batch, seq, cfg.frontend_stub_dim)),
                "labels": threefry.randint(k2, (batch, seq), 0, cfg.vocab_size),
                "mask": threefry.bernoulli(k3, 0.08, (batch, seq))}
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
    out = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    if cfg.vision_tokens:
        out["vision"] = threefry.normal(k3, (batch, cfg.vision_tokens, cfg.frontend_stub_dim))
    return out


class SyntheticDataPipeline:
    """Stateful iterator with Snapshottable (snapshot/restore) semantics;
    batches land on ``device`` (``cuda`` unless the caller asks for another),
    or, on a process mesh, as each process's blocks on its device."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0, device: Any = None, *,
                 mesh: Any = None, rules: Any = None) -> None:
        if mesh is not None and rules is None:
            raise ValueError("a pipeline on a mesh needs the model's sharding rules (rules=)")
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = 0
        self.mesh = mesh
        self.rules = rules
        self.device = resolve_device(device if mesh is None else mesh.device)

    def next(self) -> dict[str, torch.Tensor]:
        b = self.peek(self.step)
        self.step += 1
        return b

    def peek(self, step: int) -> dict[str, torch.Tensor]:
        b = make_batch(self.cfg, self.seed, step, self.batch, self.seq)
        if self.mesh is not None:
            return {k: distribute(x, dims_to_pspec(BATCH_DIMS[k], tuple(x.shape), self.rules, self.mesh), self.mesh)
                    for k, x in b.items()}
        return {k: x.to(self.device) for k, x in b.items()}

    # --- Snapshottable protocol -------------------------------------------
    def snapshot(self) -> dict[str, torch.Tensor]:
        return {"seed": torch.tensor(self.seed, dtype=torch.int64),
                "step": torch.tensor(self.step, dtype=torch.int64)}

    def restore(self, snap: Any) -> None:
        self.seed = int(snap["seed"])
        self.step = int(snap["step"])
