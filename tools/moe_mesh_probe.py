#!/usr/bin/env python3
"""How far a sharded and an unsharded step of phase 7c's mixtral layer part,
in bf16 and in f32 compute, on the card.

    python3 tools/moe_mesh_probe.py [--device cpu] [--layers 1]

Four processes share the card on the (2, 2) ("data", "model") mesh over the
staged gloo backend, as in ``chip_smoke.py``'s phase 7c, with deterministic
algorithms. For each compute dtype (the params stay bf16):

* the loss's gradients at the first step on the mesh, gathered to rank 0,
  against rank 0's on one process from the same seed and batch: per leaf
  the relative L2 difference, the share of elements whose signs differ and
  the ratio <mesh, one> / <one, one> (1 unless a gradient is off by a
  factor);
* phase 7c's (b), ``chip_smoke.mesh_moe_steps``: two train steps on the
  mesh and the same two on one process, their losses and relative gaps.

The last line of stdout is one JSON object: the card, its power limit and
each dtype's results. ``--device cpu`` runs it on the CPU at a small width
(a rehearsal; its numbers say nothing of the card).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DTYPES = ("bfloat16", "float32")


def grads_rank(rank: int, world: int, init_method: str, device: str, cfg) -> dict | None:
    """The first step's gradients on the mesh against one process's, on
    rank 0 (None elsewhere)."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.synthetic import SyntheticDataPipeline
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import ShardCtx
    from repro_torch.models.lm import on_mesh
    from repro_torch.sharding.axes import tree_pspecs
    from repro_torch.sharding.mesh import distribute
    from repro_torch.utils import threefry
    from repro_torch.utils.pytree import tree_flatten, tree_unflatten

    import chip_smoke

    mesh = init_process_mesh((2, 2), ("data", "model"), "gloo", rank=rank, world_size=world, init_method=init_method,
                             device=None if device == "cuda" else "cpu")
    torch.use_deterministic_algorithms(True)
    model = build_model(cfg)
    b, s = chip_smoke.MESH7C_MOE_BATCH, chip_smoke.MESH7C_MOE_SEQ

    def grads(params, batch, ctx):
        paths, live = tree_flatten(params)
        with on_mesh(ctx):
            leaves = [p.detach().requires_grad_() for p in live]
            loss, _ = model.loss(tree_unflatten(paths, leaves), batch, ctx=ctx)
            out = torch.autograd.grad(loss, leaves, materialize_grads=True)
            return ["/".join(p) for p in paths], [g.full_tensor() if ctx else g for g in out]

    paths, leaves = tree_flatten(model.init(threefry.PRNGKey(chip_smoke.SEED), mesh.device))
    specs = tree_flatten(tree_pspecs(model.abstract_params, model.rules, mesh))[1]
    placed = tree_unflatten(paths, [distribute(x, p, mesh) for x, p in zip(leaves, specs)])
    del leaves
    batch = SyntheticDataPipeline(cfg, b, s, chip_smoke.SEED, mesh=mesh, rules=model.rules).next()
    names, on_mesh_grads = grads(placed, batch, ShardCtx(mesh, model.rules))
    del placed
    out = None
    if rank == 0:
        one = grads(model.init(threefry.PRNGKey(chip_smoke.SEED), mesh.device),
                    SyntheticDataPipeline(cfg, b, s, chip_smoke.SEED, device=mesh.device).next(), None)[1]
        out = {}
        for name, a, w in zip(names, on_mesh_grads, one):
            a, w = a.float(), w.float()
            out[name] = dict(rel_l2=float((a - w).norm() / w.norm()),
                             signs_apart=float((a.sign() != w.sign()).float().mean()),
                             ratio=float((a * w).sum() / (w * w).sum()))
    dist.barrier()
    return out


def steps_rank(rank: int, world: int, init_method: str, device: str, cfg, compute: str) -> dict | None:
    """Phase 7c's (b) in ``compute``: the losses on the mesh and on one
    process (rank 0's result; None elsewhere)."""
    import torch

    import chip_smoke
    from repro_torch.launch.mesh import init_process_mesh

    mesh = init_process_mesh((2, 2), ("data", "model"), "gloo", rank=rank, world_size=world, init_method=init_method,
                             device=None if device == "cuda" else "cpu")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    out = chip_smoke.mesh_moe_steps(mesh, cfg, device == "cuda", compute)
    return dict(mesh=out["loss"], one=out["one"]["loss"]) if rank == 0 else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--layers", type=int, default=1)
    args = ap.parse_args()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.launch.mesh import spawn

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card: pass --device cpu", file=sys.stderr)
        return 1
    _, moe = chip_smoke.zoo_configs()
    moe = replace(moe, num_layers=args.layers)
    if args.device == "cpu":
        moe = replace(moe, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=1000)
    out = {}
    for compute in DTYPES:
        cfg = replace(moe, compute_dtype=getattr(torch, compute))
        g = spawn(grads_rank, 4, args=(args.device, cfg), timeout=900)[0]
        st = spawn(steps_rank, 4, args=(args.device, moe, compute), timeout=900)[0]
        st["rel"] = [abs(a - b) / abs(b) for a, b in zip(st["mesh"], st["one"])]
        out[compute] = dict(grads=g, steps=st)
        for name, r in g.items():
            print(f"{compute} {name}: " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()))
        print(f"{compute} losses: mesh {st['mesh']}, one process {st['one']}, relative {st['rel']}", flush=True)
    card = "CPU" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
