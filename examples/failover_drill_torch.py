"""Hot-replica failover drill on the PyTorch port (``examples/failover_drill.py``
step for step, on ``repro_torch`` with llama3.2-1b): kill the ENTIRE primary
team mid-serving and require that

  * zero requests fail: every session's token stream finishes bitwise
    identical to a fault-free run,
  * the shadow team is promoted (not a cold codec rebuild), and
  * the promotion stall (the blocking ``replica_promote_restore`` span on the
    promoted team) stays below one checkpoint interval.

Artifacts: ``--trace-out`` (Chrome-trace JSON of the whole drill, with the
kill and promotion markers) and ``--journal-out`` (the engine's event
journal as JSON lines).

    PYTHONPATH=src python examples/failover_drill_torch.py                       # on the card
    PYTHONPATH=src python examples/failover_drill_torch.py --device cpu --reduced
"""

import argparse
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import gf256
from repro_torch.core.checkpoint import EngineConfig
from repro_torch.models import build_model
from repro_torch.obs.trace import load_trace, tracer
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.sharding.mesh import resolve_device
from repro_torch.utils import threefry


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true", help="the reduced llama3.2-1b (for the CPU)")
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--ckpt-every", type=int, default=6)
    ap.add_argument("--kill-tick", type=int, default=13)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--journal-out", default=None)
    args = ap.parse_args()

    device = resolve_device(args.device)
    # the GF(2^8) backend probe runs once per process, at the first striped
    # encode or restore; a serving job pays it at start-up, not at failover
    gf256.active_backend_name()
    cfg = get_config("llama3.2-1b")
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(threefry.PRNGKey(0), device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 8), dtype=np.int32)
    scfg = dict(
        batch=4,
        max_seq=8 + args.gen + 8,
        checkpoint_every_tokens=args.ckpt_every,
        n_virtual_hosts=args.hosts,
        engine=EngineConfig(codec="rs", parity_group=2, rs_parity=2),
    )

    print("=== reference run (no faults) ===")
    ref_server = Server(model, ServerConfig(**scfg), params=params, device=device)
    ref = ref_server.prefill_and_decode(prompts, args.gen)
    ref_server.close()

    print(f"=== drill: every primary rank dies at tick {args.kill_tick}, shadow team promotes ===")
    if args.trace_out:
        tracer().enable()
    injector = FailureInjector(args.hosts, schedule={args.kill_tick: list(range(args.hosts))})
    server = Server(model, ServerConfig(replica_team=True, **scfg), params=params, injector=injector, device=device)
    out = server.prefill_and_decode(prompts, args.gen)
    server.close()

    # zero failed requests: bitwise-identical token streams
    assert np.array_equal(ref, out), "request output diverged after failover"
    assert server.promotions >= 1, "primary loss did not promote the shadow"
    assert server.engine.journal.events("replica_promote"), "no promote event"
    print(f"all {prompts.shape[0]} sessions bit-identical to the reference; "
          f"{server.promotions} promotion(s), {server.n_recoveries} recovery(ies); "
          f"{server.replica.bytes_synced} bytes synced to the shadow")

    if args.journal_out:
        with open(args.journal_out, "w") as f:
            for ev in server.engine.journal.events():
                f.write(json.dumps(ev, sort_keys=True, default=str) + "\n")
        print(f"journal written to {args.journal_out} ({len(server.engine.journal)} events)")

    if args.trace_out:
        tracer().write(args.trace_out)
        spans = load_trace(args.trace_out)
        # the promotion stall must undercut one checkpoint interval (the mean
        # commit-to-commit spacing observed in this run)
        commits = sorted(s["t0"] for s in spans if s["name"] == "commit")
        assert len(commits) >= 2, "need two commits to measure the interval"
        interval = (commits[-1] - commits[0]) / (len(commits) - 1)
        stall = sum(s["dur"] for s in spans if s["name"] == "replica_promote_restore")
        print(f"promotion stall {stall * 1e3:.1f} ms vs checkpoint interval {interval * 1e3:.1f} ms")
        assert stall < interval, f"promotion stall {stall:.3f}s exceeds one checkpoint interval {interval:.3f}s"
        print(f"trace written to {args.trace_out} ({len(tracer().events())} events)")

    print("failover drill PASSED")


if __name__ == "__main__":
    main()
