"""Fault-tolerant batched serving from the command line (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
        --batch 4 --prompt-len 8 --gen 32 --kill-at 10:2

Without ``--device`` it serves on the card (``cuda``) and raises where there
is none. ``--arch`` takes every registered config and defaults to
``llama3.2-1b``; the nine decoding configs serve (dense, MoE, Mamba-2, the
hybrid and the VLM, whose vision stub is drawn from ``PRNGKey(0)`` as the
reference's CLI draws it). hubert-xlarge is encoder-only and exits with the
reference's message.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.core.checkpoint import EngineConfig
from repro_torch.models import build_model
from repro_torch.obs.trace import tracer
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.utils import threefry
from repro_torch.utils.logging import get_logger

log = get_logger("launch.serve")


def parse_kills(spec: str | None) -> dict[int, list[int]]:
    schedule: dict[int, list[int]] = {}
    for ev in (spec or "").split(","):
        if not ev:
            continue
        t, r = ev.split(":")
        schedule.setdefault(int(t), []).append(int(r))
    return schedule


def main(argv: list[str] | None = None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--ckpt-every", type=int, default=8, help="tokens between session checkpoints")
    ap.add_argument("--kill-at", default=None, help="comma list of tick:rank kill events, e.g. 10:2,17:0")
    ap.add_argument("--silent-kill-at", default=None,
                    help="comma list of tick:rank SILENT kills (the rank stops heartbeating without a "
                         "fault at the barrier; only the heartbeat timeout detects it)")
    ap.add_argument("--replica-team", action="store_true",
                    help="run a hot-replica shadow team lazy-synced one generation behind; failures "
                         "promote it instead of blocking on a codec rebuild")
    ap.add_argument("--heartbeat-miss", type=int, default=3,
                    help="beats a rank may miss (x straggler grace) before the heartbeat monitor "
                         "declares it dead")
    ap.add_argument("--codec", default="", help="redundancy codec: copy | xor | rs | lrc (default: inferred)")
    ap.add_argument("--parity-group", type=int, default=0, help="erasure group size k for the striped codecs")
    ap.add_argument("--rs-parity", type=int, default=2, help="m parity blobs per group for --codec rs")
    ap.add_argument("--checkpoint-mode", choices=["sync", "async"], default="sync",
                    help="async overlaps the session-checkpoint drain with the next decode steps")
    ap.add_argument("--trace-out", default=None,
                    help="record checkpoint/restore spans and write a Chrome-trace JSON here")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the engine's Prometheus registry on http://127.0.0.1:PORT/metrics "
                         "(0 = free port)")
    args = ap.parse_args(argv)

    if args.trace_out:
        tracer().enable()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only (no decode step)")
    model = build_model(cfg)

    injector = None
    if args.kill_at or args.silent_kill_at:
        injector = FailureInjector(args.hosts, schedule=parse_kills(args.kill_at),
                                   silent_schedule=parse_kills(args.silent_kill_at))
    scfg = ServerConfig(
        batch=args.batch,
        max_seq=args.prompt_len + args.gen + 2,
        checkpoint_every_tokens=args.ckpt_every,
        n_virtual_hosts=args.hosts,
        checkpoint_mode=args.checkpoint_mode,
        replica_team=args.replica_team,
        heartbeat_miss_threshold=args.heartbeat_miss,
        engine=EngineConfig(codec=args.codec, parity_group=args.parity_group, rs_parity=args.rs_parity),
    )
    server = Server(model, scfg, injector=injector, device=args.device)
    if args.metrics_port is not None:
        server.start_metrics_server(args.metrics_port)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    extra = {}
    if cfg.vision_tokens:
        extra["vision"] = threefry.normal(threefry.PRNGKey(0), (args.batch, cfg.vision_tokens,
                                                                cfg.frontend_stub_dim), device=server.device)
    try:
        out = server.prefill_and_decode(prompts, args.gen, **extra)
    finally:
        server.close()
    log.info("generated %d tokens x %d sessions; %d recoveries (%d via replica promotion)",
             args.gen, args.batch, server.n_recoveries, server.promotions)
    for b in range(min(args.batch, 2)):
        log.info("session %d: %s", b, out[b, : args.prompt_len + args.gen].tolist())
    if args.trace_out:
        tracer().write(args.trace_out)
        log.info("trace written to %s (%d events)", args.trace_out, len(tracer().events()))
    return out


if __name__ == "__main__":
    main()
