"""End-to-end fault-tolerant training from the command line (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b --reduced \\
        --device cpu --steps 12 --period 4 --kill-at 6:2 --out history.json

Without ``--device`` it trains on the card (``cuda``) and raises where there
is none. ``--arch`` takes every registered config: the decoders on the
token stream, hubert-xlarge on masked prediction over frame embeddings,
llama-3.2-vision-90b on the token stream with a vision stub per batch.
``--kill-at STEP:HOST[,STEP:HOST]`` kills hosts at given steps, as
``launch/serve.py``'s ``--kill-at`` does at decode ticks (a kill before the
first checkpoint has nothing to restore: at the default MTBF the
Daly-optimal period is longer than a short run, so give ``--period``);
``--inject-mtbf`` draws failures at random instead. ``--out`` writes the loss history, the
timers, the recovery count and a SHA-256 of the final train state (every
leaf's bytes in path order), so two runs compare by their JSON. On the card
it runs under ``torch.use_deterministic_algorithms(True)`` (with cuBLAS's
workspace fixed before its first call), which a bitwise replay after a
rollback needs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
from typing import Any

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.checkpoint import EngineConfig
from repro_torch.launch.serve import parse_kills
from repro_torch.models import build_model
from repro_torch.obs.trace import tracer
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.sharding.mesh import resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.pytree import tree_flatten

log = get_logger("launch.train")


def state_sha256(state: Any) -> str:
    """SHA-256 over every leaf's bytes, leaves in path order."""
    h = hashlib.sha256()
    paths, leaves = tree_flatten(state)
    for p, x in zip(paths, leaves):
        h.update("/".join(p).encode())
        x = x.detach().to("cpu").contiguous()
        h.update(x.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config (CPU)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--hosts", type=int, default=4, help="virtual failure-domain ranks")
    ap.add_argument("--spares", type=int, default=2)
    ap.add_argument("--policy", choices=["spare", "shrink", "elastic"], default="spare")
    ap.add_argument("--mtbf", type=float, default=3600.0, help="per-host MTBF (s)")
    ap.add_argument("--inject-mtbf", type=float, default=None,
                    help="simulate failures with this per-host MTBF (s)")
    ap.add_argument("--kill-at", default=None,
                    help="comma list of step:host kill events, e.g. 6:2,11:0")
    ap.add_argument("--period", type=int, default=None,
                    help="checkpoint period in steps (default: Daly-optimal)")
    ap.add_argument("--scheme", default="pairwise")
    ap.add_argument("--parity-group", type=int, default=0,
                    help="erasure group size k (selects the xor codec unless --codec)")
    ap.add_argument("--codec", default="",
                    help="redundancy codec: copy | xor | rs | lrc (default: inferred)")
    ap.add_argument("--rs-parity", type=int, default=2,
                    help="m parity blobs per group for --codec rs")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--delta", action="store_true",
                    help="differential checkpointing: diff each snapshot against the committed "
                         "generation on a chunk grid, skip clean-chunk copies on the transfer path, "
                         "and patch striped parity incrementally instead of re-encoding in full")
    ap.add_argument("--delta-chunk-bytes", type=int, default=1 << 20,
                    help="dirty-map chunk granularity for --delta")
    ap.add_argument("--tier-dedup", action="store_true",
                    help="content-addressed delta flushes on --tier-dir: generations reference "
                         "unchanged chunks in the tier's chunk store instead of re-writing full rank files")
    ap.add_argument("--checkpoint-mode", choices=["sync", "async"], default="sync",
                    help="async overlaps the checkpoint's drain with the next train step")
    ap.add_argument("--async-workers", type=int, default=1,
                    help="background drain workers (0 drains at the next step boundary instead)")
    ap.add_argument("--restore-mode", choices=["pipelined", "sync"], default="pipelined",
                    help="pipelined drains the chunked transfer/decode/verify recovery pipeline; "
                         "sync keeps the serial per-origin decode")
    ap.add_argument("--tier-dir", default=None,
                    help="persistent disk rung of the storage-tier ladder: committed checkpoints "
                         "flush here in the background; recovery escalates to it when failures "
                         "exceed the codec's tolerance or on a cold restart")
    ap.add_argument("--disk-flush-every", type=int, default=0,
                    help="flush the disk tier every k-th committed checkpoint "
                         "(0 = adaptive per-level Daly schedule)")
    ap.add_argument("--tier-mtbf", type=float, default=30 * 24 * 3600.0,
                    help="MTBF (s) of the failures the diskless tier cannot survive "
                         "(whole-job loss, beyond-tolerance bursts): drives the adaptive flush cadence")
    ap.add_argument("--cold-restart", action="store_true",
                    help="resume from the newest --tier-dir generation instead of initializing fresh "
                         "(elastic N-to-M when the stored world size differs from --hosts)")
    ap.add_argument("--out", default=None, help="write the history JSON here")
    ap.add_argument("--trace-out", default=None,
                    help="record checkpoint/restore spans and write a Chrome-trace JSON here")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the engine's Prometheus registry on http://127.0.0.1:PORT/metrics "
                         "(0 = pick a free port)")
    args = ap.parse_args(argv)
    if args.cold_restart and not args.tier_dir:
        ap.error("--cold-restart requires --tier-dir")
    if args.kill_at and args.inject_mtbf:
        ap.error("--kill-at and --inject-mtbf are exclusive")

    if resolve_device(args.device).type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    if args.trace_out:
        tracer().enable()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    log.info("arch %s: %s params (%s active)", cfg.name, f"{model.n_params:,}", f"{model.n_active_params:,}")

    injector = None
    if args.inject_mtbf:
        injector = FailureInjector(args.hosts, mtbf_rank_s=args.inject_mtbf, step_time_s=1.0, seed=17)
    elif args.kill_at:
        injector = FailureInjector(args.hosts, schedule=parse_kills(args.kill_at))

    tcfg = TrainerConfig(
        batch=args.batch,
        seq=args.seq,
        lr=args.lr,
        total_steps=args.steps,
        n_virtual_hosts=args.hosts,
        n_spares=args.spares,
        recovery_policy=args.policy,
        mtbf_individual_s=args.mtbf,
        checkpoint_period=args.period,
        checkpoint_mode=args.checkpoint_mode,
        tier_dir=args.tier_dir,
        disk_flush_every=args.disk_flush_every,
        tier_mtbf_s=args.tier_mtbf,
        tier_dedup=args.tier_dedup,
        engine=EngineConfig(
            scheme=args.scheme,
            parity_group=args.parity_group,
            codec=args.codec,
            rs_parity=args.rs_parity,
            compress=args.compress,
            delta=args.delta,
            delta_chunk_bytes=args.delta_chunk_bytes,
            async_workers=args.async_workers,
            restore_mode=args.restore_mode,
        ),
    )
    trainer = Trainer(model, tcfg, injector=injector, device=args.device)
    metrics_server = None
    if args.metrics_port is not None:
        from repro_torch.runtime.server import start_metrics_server

        metrics_server = start_metrics_server(lambda: trainer.engine.registry, args.metrics_port)
    try:
        if args.cold_restart:
            meta = trainer.cold_restart()
            log.info("cold restart: resuming from step %s", meta.get("step"))
        history = trainer.run(args.steps)
    finally:
        trainer.engine.close()
        if metrics_server is not None:
            metrics_server.stop()

    log.info(
        "done: %d steps, %d recoveries, %d checkpoints (%.3fs each), Daly period %d steps, "
        "predicted overhead %.2f%%",
        int(trainer.state["step"]), trainer.n_recoveries, trainer.engine.stats.created,
        trainer.engine.stats.last_create_s, trainer.scheduler.period_steps,
        100 * trainer.scheduler.expected_overhead,
    )
    if history:
        log.info("loss: first=%.4f last=%.4f", history[0]["loss"], history[-1]["loss"])
    out = {"history": history, "timers": trainer.timers.report(), "n_recoveries": trainer.n_recoveries,
           "state_sha256": state_sha256(trainer.state)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    if args.trace_out:
        tracer().write(args.trace_out)
        log.info("trace written to %s (%d events)", args.trace_out, len(tracer().events()))
    return out


if __name__ == "__main__":
    main()
