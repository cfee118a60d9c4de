"""The paper's own application domain on the PyTorch port
(``examples/phase_field_stencil.py`` line for line, on ``repro_torch``): an
explicit phase-field stencil code (2-D Allen–Cahn solidification with a
moving window), block-partitioned across virtual hosts, checkpointed with
the SAME engine that protects LM training — the scheme's "black box"
extensibility (§5.1.1: "fault tolerance is not limited to certain
algorithms").

    PYTHONPATH=src python examples/phase_field_stencil_torch.py                    # on the card
    PYTHONPATH=src python examples/phase_field_stencil_torch.py --device cpu       # on the CPU
    PYTHONPATH=src python examples/phase_field_stencil_torch.py --rows 4096 --cols 4096

The field lives on its device; the engine's capture copies each host's row
block straight from it into the host arenas, and a restore writes the blocks
back in place. Everything runs under :func:`main`, so the pieces
(``step_field``, ``shift_window``, ``PhaseFieldEntity``, ``run``) import
without side effects.
"""

from __future__ import annotations

import argparse
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.core.interval import optimal_interval, overhead, system_mtbf
from repro_torch.sharding.mesh import resolve_device
from repro_torch.utils import threefry

H, W = 128, 128          # voxel cells
N_HOSTS = 8              # block rows are distributed over these hosts
DT, EPS2, MOBILITY = 0.1, 0.5, 1.0
STEPS, CKPT_EVERY = 300, 50
WINDOW_SHIFT_EVERY = 100  # the paper's moving-window technique
WINDOW_ROWS = 8           # rows the window moves by


def step_field(phi: torch.Tensor) -> torch.Tensor:
    """Explicit Euler Allen-Cahn step, 5-point Laplacian, periodic BCs (the
    reference's expression, in its order, as eager ops on ``phi``'s device)."""
    lap = (
        torch.roll(phi, 1, 0) + torch.roll(phi, -1, 0)
        + torch.roll(phi, 1, 1) + torch.roll(phi, -1, 1)
        - 4.0 * phi
    )
    dwell = phi * (1.0 - phi) * (1.0 - 2.0 * phi)  # double-well derivative
    return phi + DT * MOBILITY * (EPS2 * lap + dwell)


def shift_window(phi: torch.Tensor) -> torch.Tensor:
    """Moving window: drop the solidified bottom rows, feed fresh melt on top
    (paper Fig. 2); the window offset is part of the checkpointed state."""
    fresh = torch.zeros((WINDOW_ROWS, phi.shape[1]), dtype=phi.dtype, device=phi.device)
    return torch.cat([phi[WINDOW_ROWS:], fresh], dim=0)


class PhaseFieldEntity:
    """Block data: each host owns rows/N_HOSTS rows (waLBerla blocks); the
    moving-window offset rides along like the paper's cell coordinates."""

    def __init__(self, shape: tuple[int, int] = (H, W), device: Any = None,
                 phi: torch.Tensor | None = None) -> None:
        if phi is None:
            key = threefry.PRNGKey(0)
            phi = 0.5 + 0.05 * threefry.normal(key, shape, device=resolve_device(device))
        self.phi = phi
        self.window_offset = 0
        self.step = 0

    @classmethod
    def from_numpy(cls, phi: np.ndarray, offset: int = 0, step: int = 0, device: Any = None) -> PhaseFieldEntity:
        """The state carried across: a float32 field (e.g. the reference's)
        with its window offset and step, on ``device``."""
        field = torch.from_numpy(np.array(phi, dtype=np.float32)).to(resolve_device(device))
        sim = cls(phi=field)
        sim.window_offset, sim.step = int(offset), int(step)
        return sim

    def snapshot_shards(self, n: int) -> list[dict[str, torch.Tensor]]:
        """Row-block views of the live field (the capture copies them)."""
        rows = self.phi.chunk(n, 0)
        return [
            {"rows": rows[r],
             "offset": torch.tensor(self.window_offset, dtype=torch.int64),
             "step": torch.tensor(self.step, dtype=torch.int64)}
            for r in range(n)
        ]

    def restore_shards(self, shards: dict[int, Any]) -> None:
        """Each origin's block written back in place."""
        blocks = self.phi.chunk(len(shards), 0)
        for r in range(len(shards)):
            blocks[r].copy_(shards[r]["rows"])
        self.window_offset = int(shards[0]["offset"])
        self.step = int(shards[0]["step"])


def run(
    kill_at: dict[int, Any] | None = None,
    *,
    cfg: EngineConfig | None = None,
    steps: int = STEPS,
    shape: tuple[int, int] = (H, W),
    device: Any = None,
    sim: PhaseFieldEntity | None = None,
    observe: Callable[[str, PhaseFieldEntity, CheckpointEngine], None] | None = None,
) -> tuple[torch.Tensor, int, int]:
    """The reference's run: ``kill_at`` maps a step to the host (or hosts,
    a burst) that dies there. ``cfg`` is the engine's (the reference's
    default ``EngineConfig()``), ``steps`` where the run stops, ``sim`` a
    prepared entity (a fresh field of ``shape`` on ``device`` otherwise);
    ``observe(event, sim, engine)`` is called after every "step",
    "checkpoint" and "restore". Returns the final field (on its device),
    the step and the number of recoveries."""
    sim = sim if sim is not None else PhaseFieldEntity(shape, device)
    engine = CheckpointEngine(N_HOSTS, cfg or EngineConfig(), device=sim.phi.device)
    engine.register("domain", sim)
    recoveries = 0
    kill_at = dict(kill_at or {})
    observe = observe or (lambda event, sim, engine: None)

    try:
        while sim.step < steps:
            if sim.step in kill_at and kill_at[sim.step] is not None:
                dead = kill_at.pop(sim.step)
                ranks = [dead] if isinstance(dead, int) else list(dead)
                for rank in ranks:
                    engine.stores[rank].wipe()       # host dies; its snapshots vanish
                sim.phi.fill_(float("nan"))          # its blocks are gone too
                # ULFM path: revoke -> shrink/substitute -> restore last checkpoint
                for rank in ranks:
                    engine.stores[rank].revive(rank)  # spare takes the coordinate
                engine.restore()
                recoveries += 1
                observe("restore", sim, engine)
                continue

            sim.phi = step_field(sim.phi)
            sim.step += 1
            if sim.step % WINDOW_SHIFT_EVERY == 0:
                sim.phi = shift_window(sim.phi)
                sim.window_offset += WINDOW_ROWS
            observe("step", sim, engine)
            if sim.step % CKPT_EVERY == 0:
                assert engine.checkpoint({"step": sim.step})
                observe("checkpoint", sim, engine)
    finally:
        engine.close()

    return sim.phi, sim.step, recoveries


def interval_lines() -> tuple[float, float]:
    """The paper's interval theory applied to this app on a hypothetical
    cluster: (Daly interval s, overhead) at 2^15 ranks of a 10-year node
    MTBF and a 5 s checkpoint."""
    mu = system_mtbf(87_600 * 3600.0, 2**15)  # 10-year node MTBF, 2^15 ranks
    c = 5.0
    return optimal_interval(mu, c), overhead(c, mu)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--rows", type=int, default=H, help="field rows (a multiple of 8 hosts x 8 window rows)")
    ap.add_argument("--cols", type=int, default=W, help="field columns")
    args = ap.parse_args()
    if resolve_device(args.device).type == "cuda":
        torch.use_deterministic_algorithms(True)
    shape = (args.rows, args.cols)

    print("=== clean run ===")
    ref, _, _ = run(shape=shape, device=args.device)
    print(f"field range [{float(ref.min()):.3f}, {float(ref.max()):.3f}], mean {float(ref.mean()):.3f}")

    print("=== faulty run: kill host 3 at step 120, host 6 at step 260 ===")
    out, final_step, recoveries = run(kill_at={120: 3, 260: 6}, shape=shape, device=args.device)
    print(f"recoveries: {recoveries}, final step {final_step}")
    identical = torch.equal(ref, out)
    print(f"final field bitwise-identical to clean run: {identical}")
    assert identical

    t_opt, ov = interval_lines()
    print(f"Daly interval at 2^15 ranks: {t_opt:.0f}s, "
          f"overhead {100 * ov:.1f}% (paper Fig. 6 regime)")
    print("OK")


if __name__ == "__main__":
    main()
