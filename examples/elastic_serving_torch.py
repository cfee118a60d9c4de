"""Fault-tolerant batched serving on the PyTorch port
(``examples/elastic_serving.py`` step for step, on ``repro_torch`` with
llama3.2-1b, the port's one config): sessions (KV caches + generated tokens)
are checkpointed in host memory; killed hosts roll the sessions back a few
tokens instead of dropping requests, and greedy decoding makes the final
generations identical to the fault-free run.

Two recovery modes:
  * spare substitution: the world size stays constant;
  * elastic N-to-M shrink, no spares: the session checkpoint is
    repartitioned onto the survivors (4 -> 3 -> 2 hosts) and serving
    continues at degraded capacity, still bit-identical.

    PYTHONPATH=src python examples/elastic_serving_torch.py                       # on the card
    PYTHONPATH=src python examples/elastic_serving_torch.py --device cpu --reduced
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.sharding.mesh import resolve_device
from repro_torch.utils import threefry

GEN = 40


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true", help="the reduced llama3.2-1b (for the CPU)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config("llama3.2-1b")
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(threefry.PRNGKey(7), device)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 12), dtype=np.int32)

    def serve(injector=None, **kw) -> tuple[Server, np.ndarray]:
        s = Server(model, ServerConfig(batch=4, max_seq=64, checkpoint_every_tokens=8, **kw),
                   params=params, injector=injector, device=device)
        out = s.prefill_and_decode(prompts, GEN)
        s.close()
        return s, out

    print("=== clean serving run ===")
    _, ref = serve()

    print("=== faulty serving run: hosts die at decode ticks 11 and 26 ===")
    faulty, out = serve(FailureInjector(4, schedule={11: [2], 26: [0]}))
    print(f"recoveries: {faulty.n_recoveries}")
    same = np.array_equal(ref, out)
    print(f"generations identical to fault-free run: {same}")
    for b in range(2):
        print(f"  session {b}: ...{out[b, 12:12 + 12].tolist()}")
    assert same

    print("=== elastic shrink run: no spares, the world shrinks 4 -> 3 -> 2 ===")
    elastic, out2 = serve(FailureInjector(4, schedule={11: [2], 26: [0]}), n_spares=0, recovery_policy="elastic")
    print(f"recoveries: {elastic.n_recoveries}, final world size: {elastic.cluster.n_ranks}")
    rep = elastic.engine.last_elastic_report
    print(f"last repartition: {rep.n_old} -> {rep.n_new} ranks, {rep.bytes_moved} B moved "
          f"(lower bound {rep.bytes_lower_bound}, ratio {rep.movement_ratio:.2f})")
    same2 = np.array_equal(ref, out2)
    print(f"generations identical to fault-free run: {same2}")
    assert same2
    assert elastic.cluster.n_ranks == 2
    print("OK")


if __name__ == "__main__":
    main()
