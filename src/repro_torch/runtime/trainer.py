"""The fault-tolerant training loop — paper Algorithm 3, end to end.

    while current step < number of steps:
        try:
            barrier (faults surface here, deterministically)
            single step
            checkpoint if due (Algorithm 2, at the Daly interval)
        catch ProcessFaultException:
            stabilize parallel environment (revoke -> shrink / spares)
            recover last checkpoint (Algorithm 4; zero-comm for survivors)

Because the data pipeline's state is part of the checkpoint, the replayed
trajectory after a rollback is bitwise identical to a fault-free run, as
long as every operation of the step is deterministic (on the card:
``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before cuBLAS is first used).

The state is a nested dict of tensors on the trainer's device (``cuda``
unless the caller passes ``device="cpu"``). Nothing replaces its tensors:
the optimizer writes them in place, and so do restores
(``ShardedStateEntity.restore_shards``). Gradients are taken through
``requires_grad`` aliases of the live params, so the state tensors never
require grad themselves.

Checkpoints run the reference's default engine (``EngineConfig()``: the
background drain and the pipelined restore). Under ``checkpoint_mode="sync"``
a due checkpoint captures and drains before the next step; under
``"async"`` (alias ``async_checkpoint``) it captures at the step boundary,
drains behind the next step on the engine's worker, and commits at the
following barrier.

Any engine codec runs (``TrainerConfig.engine``: ``copy``, or the striped
``xor``, ``rs`` and ``lrc``). ``tier_dir`` adds a disk rung to the engine's
storage-tier ladder, flushed in the background every ``disk_flush_every``
commits (0: the per-level Daly cadence of ``MultiLevelScheduler``); a
whole-system loss restarts every rank and the engine escalates to the
newest generation on disk, and ``cold_restart`` resumes a fresh job from
it, repartitioned N-to-M when the job's world size differs.

``Trainer(..., mesh=ProcessMesh)`` is the reference's ``Trainer(mesh=)``:
one process per mesh coordinate (``launch/mesh.py``), each constructing the
Trainer alike and calling ``run``. The state is DTensors laid out by the
reference's ``_state_pspecs`` (params by ``tree_pspecs``, the AdamW state by
``tree_zero1_pspecs``, ``step`` replicated); the loss runs under
``ShardCtx(mesh, model.rules)`` and the gradients go to the master's
placements before AdamW (``launch/steps.py::train_step``). The engine stays
the reference's, one ``CheckpointEngine`` over ``n_virtual_hosts`` virtual
failure-domain hosts: the mesh's processes never die, the virtual hosts
do. It runs in mesh rank 0 alone, on the global state (``global_state``),
which rank 0 gathers before each checkpoint and scatters after each
restore (``runtime/state.py``). Rank 0 runs Algorithm 3 and, before each
thing the other processes take part in, broadcasts one small control
record over the group (a step with the data pipeline's ``(seed, step)``,
the kills, the committed checkpoints and the recoveries so far; a gather;
a scatter; the end of ``run``); they follow it, so no process decides on
its own clock (the Daly scheduler's measured step times) and none waits in
a collective the others skip. Every recovery policy runs on a mesh: rank
0's engine restores (and, under "shrink" and "elastic", resizes) as on one
card, and each recovery's scatter record names the policy and the engine's
new rank count. ``regrow``, ``restore_elastic`` and ``cold_restart`` are
called on every process alike, as ``run`` is: rank 0 runs the engine and
tells, the others take part in the gather or the scatter it names.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import torch

from repro_torch.core import storage as storage_mod
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.core.interval import CheckpointScheduler, MultiLevelScheduler, system_mtbf
from repro_torch.data.synthetic import SyntheticDataPipeline
from repro_torch.launch.steps import train_state_layout, train_step
from repro_torch.models.common import ShardCtx
from repro_torch.models.model import Model
from repro_torch.obs.trace import tracer
from repro_torch.optim.adamw import AdamWConfig, abstract_opt_state, init_opt_state
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.cluster import VirtualCluster
from repro_torch.runtime.failures import FailureInjector, ProcessFaultException
from repro_torch.runtime.state import (PROD_MESH, ShardPlan, ShardedStateEntity, gather_state, place_state,
                                       scatter_state)
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.sharding.axes import tree_pspecs, tree_zero1_pspecs
from repro_torch.sharding.mesh import make_mesh, resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils import threefry
from repro_torch.utils.timing import TimerRegistry

log = get_logger("runtime.trainer")
_TR = tracer()


@dataclass
class TrainerConfig:
    batch: int = 8
    seq: int = 64
    lr: float = 1e-3
    warmup_steps: int = 10
    total_steps: int = 1000
    seed: int = 0
    # fault tolerance
    n_virtual_hosts: int = 4          # failure-domain ranks in the simulation
    n_spares: int = 0
    recovery_policy: str = "spare"    # spare | shrink | elastic (N-to-M repartition)
    mtbf_individual_s: float = 3600.0
    checkpoint_period: int | None = None  # None -> Daly-optimal (adaptive)
    engine: EngineConfig = field(default_factory=EngineConfig)
    moment_dtype: Any = torch.float32
    # The storage-tier ladder: ``tier_dir`` adds a persistent disk rung to
    # EngineConfig.tiers, flushed in the background every
    # ``disk_flush_every`` commits; 0 derives the cadence from the
    # per-level Daly schedule at ``tier_mtbf_s`` (the MTBF of the failures
    # the diskless tier cannot survive). ``tier_dedup`` writes
    # content-addressed delta generations.
    tier_dir: str | None = None
    disk_flush_every: int = 0
    tier_mtbf_s: float = 30 * 24 * 3600.0
    tier_dedup: bool = False
    # deprecated aliases of (tier_dir, disk_flush_every)
    disk_path: str | None = None
    disk_every: int = 8
    # "sync" blocks the step loop for the whole create; "async" captures at
    # the step boundary and drains behind the next step, committing at the
    # following barrier
    checkpoint_mode: str = "sync"     # sync | async
    async_checkpoint: bool = False    # deprecated alias of checkpoint_mode="async"


class Trainer:
    def __init__(
        self,
        model: Model,
        tcfg: TrainerConfig,
        injector: FailureInjector | None = None,
        device: Any = None,
        *,
        mesh: Any = None,
    ) -> None:
        if tcfg.checkpoint_mode not in ("sync", "async"):
            raise ValueError(f"checkpoint_mode {tcfg.checkpoint_mode!r}")
        self.model = model
        self.cfg = model.cfg
        self.tcfg = tcfg
        self.mesh = mesh
        if mesh is not None and device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.timers = TimerRegistry()

        # -- data pipeline (its (seed, step) state is a checkpoint entity) ---
        self.data = SyntheticDataPipeline(self.cfg, tcfg.batch, tcfg.seq, tcfg.seed, device=self.device,
                                          mesh=mesh, rules=None if mesh is None else model.rules)

        # -- live state -------------------------------------------------------
        params = model.init(threefry.PRNGKey(tcfg.seed), self.device)
        self.state: dict[str, Any] = {
            "params": params,
            "opt": init_opt_state(params, tcfg.moment_dtype),
            "step": torch.zeros((), dtype=torch.int32, device=self.device),
        }
        # on a mesh: each process's blocks; rank 0 keeps the global tensors,
        # which the engine reads at a checkpoint and restores into
        self.global_state: dict[str, Any] | None = None
        self._ctx = None
        if mesh is not None:
            self._ctx = ShardCtx(mesh, model.rules)
            self.pspecs = self.state_pspecs(mesh)
            self.global_state = self.state if mesh.rank == 0 else None
            self.state = place_state(self.state, mesh, self.pspecs)
        del params

        # -- sharding plan against the PRODUCTION mesh ------------------------
        layout = train_state_layout(replace(self.cfg, optimizer_dtype=tcfg.moment_dtype),
                                    make_mesh(*PROD_MESH, device=self.device))
        self.plan = ShardPlan.from_pspecs(layout.sds, layout.pspecs)

        self._train_step = self._build_train_step()
        self.history: list[dict[str, float]] = []
        self.n_recoveries = 0
        self._in_step = False
        if mesh is not None and mesh.rank != 0:  # a follower: rank 0 runs the engine
            self.engine = self.cluster = self.scheduler = self.mlsched = self.injector = self.straggler = None
            return

        # -- cluster + engine + scheduler -------------------------------------
        self._engine_cfg = self._resolve_engine_cfg(tcfg)
        self.cluster = VirtualCluster(tcfg.n_virtual_hosts, tcfg.n_spares)
        self.engine = CheckpointEngine(tcfg.n_virtual_hosts, self._engine_cfg, device=self.device)
        self.cluster.attach_engine(self.engine)
        self.timers.attach_metrics(self.engine.registry)
        self.engine.register("train_state", ShardedStateEntity(
            (lambda: self.state) if mesh is None else (lambda: self.global_state), self.plan))
        self.engine.register("data_pipeline", self.data)
        self.engine.register("timers", self.timers)

        mtbf = system_mtbf(tcfg.mtbf_individual_s, tcfg.n_virtual_hosts)
        self.scheduler = CheckpointScheduler(mtbf_s=mtbf, step_time_s=0.1)
        # the per-level Daly schedule of the tier ladder: on when a disk rung
        # exists and no flush cadence was fixed
        self.mlsched: MultiLevelScheduler | None = None
        if self.engine.persistent_tiers and self._auto_flush_every:
            self.mlsched = MultiLevelScheduler(base=self.scheduler, level_mtbf_s=[tcfg.tier_mtbf_s])
        self.injector = injector or FailureInjector(tcfg.n_virtual_hosts)
        self.straggler = StragglerDetector(tcfg.n_virtual_hosts)

        self._last_ckpt_step = -(10**9)
        self._pending_ckpt_step = -(10**9)  # step of an overlapped checkpoint not yet committed
        self._seen_flushes = 0

    def _resolve_engine_cfg(self, tcfg: TrainerConfig) -> EngineConfig:
        """Fold the trainer's tier settings into the engine config:
        ``tier_dir`` (or the deprecated ``disk_path``) appends a disk rung
        unless the caller configured a ladder. A fixed cadence
        (``disk_flush_every`` > 0, or the legacy ``disk_every``) sets
        ``every``; otherwise the MultiLevelScheduler retunes it after every
        checkpoint."""
        tier_dir = tcfg.tier_dir or tcfg.disk_path
        self._auto_flush_every = False
        if tcfg.engine.tiers or tier_dir is None:
            return tcfg.engine
        every = tcfg.disk_flush_every
        if every <= 0 and tcfg.disk_path:
            every = tcfg.disk_every  # the legacy alias keeps its cadence
        if every <= 0:
            self._auto_flush_every = True
            every = 4  # until the first retune
        return replace(tcfg.engine, tiers=(storage_mod.disk(tier_dir, every=every, dedup=tcfg.tier_dedup),))

    def _retune_tier_schedule(self) -> None:
        """Tier upkeep right after a commit: kick the staged background
        flush (the worker wakes behind the next step, never on the blocked
        capture and finalize path) and fold the last measured flush into the
        per-level Daly cadence."""
        self.engine.kick_tier_flush()
        if self.mlsched is None:
            return
        stats = self.engine.stats
        if stats.tier_flushes > self._seen_flushes and stats.last_flush_s > 0:
            self._seen_flushes = stats.tier_flushes
            self.mlsched.record_flush_duration(1, stats.last_flush_s)
        for tier in self.engine.persistent_tiers:
            tier.every = self.mlsched.flush_every(1)

    def state_pspecs(self, mesh: Any) -> dict[str, Any]:
        """The reference's ``_state_pspecs``: params by ``tree_pspecs``, the
        AdamW state by ``tree_zero1_pspecs``, ``step`` replicated."""
        rules = self.model.rules
        p_specs = self.model.abstract_params
        opt_specs = abstract_opt_state(p_specs, self.tcfg.moment_dtype)
        return {
            "params": tree_pspecs(p_specs, rules, mesh),
            "opt": {k: tree_zero1_pspecs(opt_specs[k], rules, mesh) for k in ("master", "m", "v")},
            "step": (),
        }

    # ------------------------------------------------------------------ #
    def _build_train_step(self):
        model, tcfg, ctx = self.model, self.tcfg, self._ctx
        hp = AdamWConfig(lr=tcfg.lr)
        sched = warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)

        def step_fn(state, batch):
            # grads through aliases of the live params (same storage); the
            # update then writes the live tensors in place
            loss, metrics, stats = train_step(model, state, batch, hp, sched, ctx)
            return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}, **stats}

        return step_fn

    # -- the process mesh: rank 0's records, gathers and scatters ----------
    def _step_count(self) -> int:
        step = self.state["step"]
        return int(step.to_local() if self.mesh is not None else step)

    def _scalar(self, x: torch.Tensor) -> float:
        """A step's scalar as a float (on a mesh a collective: every process
        reads it in the same order)."""
        return float(x.full_tensor() if self.mesh is not None else x)

    def _tell(self, op: str, **fields: Any) -> None:
        """Rank 0: broadcast one control record over the mesh's group."""
        import torch.distributed as dist

        rec = {"op": op, "created": self.engine.stats.created, "recoveries": self.n_recoveries, **fields}
        dist.broadcast_object_list([rec], src=0, group=self.mesh.group)

    def _hear(self) -> dict:
        """A follower: the next record from rank 0."""
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.mesh.group)
        return box[0]

    def _gather(self) -> None:
        """Every block of the live state into rank 0's ``global_state``."""
        if self.mesh is None:
            return
        if self.mesh.rank == 0:
            self._tell("gather")
        gather_state(self.state, self.mesh, self.pspecs, self.global_state)

    def _scatter(self, policy: str | None = None) -> None:
        """Rank 0's restored ``global_state`` into every process's blocks,
        and the data pipeline's ``(seed, step)`` with it; the record names
        the recovery's ``policy`` and the engine's rank count."""
        if self.mesh is None:
            return
        if self.mesh.rank == 0:
            self._tell("scatter", data=[self.data.seed, self.data.step], policy=policy, n_ranks=self.engine.n_ranks)
        scatter_state(self.state, self.mesh, self.pspecs, self.global_state)

    def _state_step(self) -> int:
        """The step of the state the engine reads: on a mesh rank 0's
        ``global_state``, which a restore writes before the scatter."""
        return self._step_count() if self.mesh is None else int(self.global_state["step"])

    def _one_step(self, step: int) -> float:
        """One train step (timed, synchronised); returns its loss and
        appends it to the history."""
        self._in_step = True
        with self.timers("train_step"), _TR.span("train_step", step=step):
            batch = self.data.next()
            metrics = self._train_step(self.state, batch)
            self._sync()
        step_s = self.timers("train_step").last
        loss = self._scalar(metrics["loss"])
        self._in_step = False
        self.history.append({"step": step, "loss": loss, "step_s": step_s})
        if self.cfg.has_moe:  # the MoE load-balance loss, mean over the layers
            self.history[-1]["moe_aux"] = self._scalar(metrics["moe_aux"])
        return loss

    def _lead(self, fn, share: bool = True):
        """``fn()`` on every process of a mesh (without one, ``fn()``): rank
        0 runs it and ends with an "end" record, the others follow its
        records until then. With ``share`` the record carries ``fn``'s
        result and every process returns it; else (``run``) each returns
        its own history."""
        if self.mesh is None:
            return fn()
        if self.mesh.rank != 0:
            return self._follow()
        try:
            out = fn()
        except BaseException as exc:
            if not self._in_step:  # inside a step every process raised alike
                self._tell("end", error=f"{type(exc).__name__}: {exc}")
            raise
        self._tell("end", **({"result": out} if share else {}))
        return out

    def _follow(self) -> Any:
        """A follower's side of ``_lead``: rank 0's records, until the end."""
        while True:
            rec = self._hear()
            self.n_recoveries = rec["recoveries"]
            if rec["op"] == "step":
                self.data.seed, self.data.step = rec["data"]
                self._one_step(rec["step"])
            elif rec["op"] == "gather":
                self._gather()
            elif rec["op"] == "scatter":
                self._scatter()
                self.data.seed, self.data.step = rec["data"]
            elif rec["op"] == "end":
                if rec.get("error"):
                    raise RuntimeError(f"mesh rank 0 stopped the run: {rec['error']}")
                return rec["result"] if "result" in rec else self.history
            else:
                raise ValueError(f"unknown control record {rec}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    # Algorithm 3
    # ------------------------------------------------------------------ #
    def run(self, num_steps: int) -> list[dict[str, float]]:
        return self._lead(lambda: self._run(num_steps), share=False)

    def _run(self, num_steps: int) -> list[dict[str, float]]:
        ckpt_count = 0
        while self._step_count() < num_steps:
            try:
                self.cluster.barrier("step")

                # Commit an overlapped checkpoint from the previous step (its
                # drain ran behind that step).
                pending = self.engine.finalize_async()
                if pending is not None:
                    self.engine._fault_hook = lambda phase: None
                if pending is True:
                    self._last_ckpt_step = self._pending_ckpt_step
                    self.scheduler.record_checkpoint_duration(self.timers("checkpoint").mean)
                    self._retune_tier_schedule()
                elif pending is False:
                    raise ProcessFaultException(sorted(self.cluster.failed), "checkpoint")

                # Fault injection models hosts dying *during* the step; the
                # fault surfaces at the next barrier (step granularity).
                step = self._step_count()
                kills = self.injector.kills_at_step(step)
                for r in kills:
                    self.cluster.kill(r)
                self.cluster.barrier("step")

                if self.mesh is not None:
                    self._tell("step", step=step, data=[self.data.seed, self.data.step], kills=list(kills))
                loss = self._one_step(step)
                step_s = self.history[-1]["step_s"]
                self.scheduler.record_step_time(self.timers("train_step").mean)
                log.debug(
                    "step", extra={"fields": {
                        "component": "trainer", "step": step, "loss": loss,
                        "generation": self.engine.stats.created,
                        "alive": len(self.cluster.alive()), "step_s": step_s,
                    }},
                )

                if self._checkpoint_due(self._step_count()):
                    self._gather()
                    kills = self.injector.kills_at_checkpoint(ckpt_count)
                    hook_fired = {"done": False}

                    def hook(phase: str) -> None:
                        if phase == "after_create" and kills and not hook_fired["done"]:
                            hook_fired["done"] = True
                            for r in kills:
                                self.cluster.kill(r)

                    self.engine._fault_hook = hook
                    ckpt_count += 1
                    if self.tcfg.checkpoint_mode == "async" or self.tcfg.async_checkpoint:
                        # capture now; the drain overlaps the next step
                        with self.timers("checkpoint"):
                            created = self.engine.checkpoint_async({"step": self._step_count()})
                        self._pending_ckpt_step = self._step_count()
                        if not created:
                            raise ProcessFaultException(sorted(self.cluster.failed), "checkpoint")
                        continue
                    with self.timers("checkpoint"):
                        ok = self.engine.checkpoint({"step": self._step_count()})
                    self.engine._fault_hook = lambda phase: None
                    if not ok:
                        raise ProcessFaultException(sorted(self.cluster.failed), "checkpoint")
                    self._last_ckpt_step = self._step_count()
                    self.scheduler.record_checkpoint_duration(self.timers("checkpoint").mean)
                    # a due disk rung flushes in the background, after the
                    # pointer swap; here only the kick and the cadence retune
                    self._retune_tier_schedule()

            except ProcessFaultException as e:
                log.warning("fault caught in main loop: %s", e)
                self.recover()
        return self.history

    # ------------------------------------------------------------------ #
    def _checkpoint_due(self, step: int) -> bool:
        if self.tcfg.checkpoint_period is not None:
            return step > 0 and step % self.tcfg.checkpoint_period == 0
        return self.scheduler.due(step, max(self._last_ckpt_step, 0))

    def recover(self) -> None:
        """Stabilize the parallel environment, then roll back (Algorithm 3).

        Recovery escalates down the storage-tier ladder: the engine first
        rebuilds from the surviving hosts through the codec; a whole-system
        loss (below) or a burst beyond the codec's tolerance (inside
        ``engine.restore``) loads the newest valid generation on disk and
        recovers against it. Failures within tolerance never touch disk."""
        if not self.engine.has_valid_checkpoint:
            if self.engine.has_tier_data():
                # full restart: every in-memory snapshot died with its host;
                # all ranks rejoin and the engine escalates itself
                log.warning("no in-memory checkpoint; escalating to the tier ladder")
                self.cluster.restart_all()
                meta = self.engine.restore()
                self.n_recoveries += 1
                self._scatter("tiers")
                log.info("recovered from the tier ladder to step %s", meta.get("step"))
                return
            raise RuntimeError(
                "fault before the first checkpoint and no persistent tier configured"
            )
        report = self.cluster.stabilize(self.tcfg.recovery_policy)  # revoke+shrink
        if report.policy == "elastic":
            meta = self._elastic_recover(report.n_ranks_after)
        elif report.policy == "shrink":
            meta = self._shrink_engine(report)
        else:
            meta = self.engine.restore()  # Algorithm 4 under the hood
        # Restored entities include the data pipeline + timers + train state;
        # the loop continues from the checkpointed step.
        self.n_recoveries += 1
        self._scatter(report.policy)
        log.info(
            "recovered to step %s (policy=%s, codec=%s, load_factor=%.2f, restore %.3fs)",
            meta.get("step"), report.policy, self.engine.codec.name,
            report.load_factor, self.engine.stats.last_restore_s,
        )

    def _shrink_engine(self, report) -> dict[str, Any]:
        """Elastic shrink: restore from the OLD world's surviving stores, then
        rebuild the engine over the dense-renumbered survivor set. The live
        state is global in this simulation, so 'survivors inherit the failed
        ranks' blocks' happens inside restore_shards (the re-sharding to
        new_n ranks occurs at the next checkpoint)."""
        old = self.engine
        failed = set(report.failed)
        old._alive_fn = lambda: {r for r in range(old.n_ranks) if r not in failed}
        meta = old.restore()  # Algorithm 4 against the old rank space
        self._swap_engine(report.n_ranks_after)
        return meta

    def _elastic_recover(self, n_new: int) -> dict[str, Any]:
        """N-to-M recovery: repartition the checkpoint onto the ``n_new``-rank
        world (engine.restore_elastic), realign the cluster, and immediately
        re-checkpoint so the new world is protected before the next step.

        restore_elastic consumes the old checkpoint, so a failed re-protect
        (a rank dying during the exchange) must not be ignored: the restored
        state is still live in memory, so we shrink onto whoever survived and
        re-protect again until a checkpoint commits."""
        meta = self.engine.restore_elastic(n_new)
        self.cluster.resize(n_new)
        while not self.engine.checkpoint({"step": self._state_step()}):
            survivors = len(self.cluster.alive())
            if survivors < 1:
                raise RuntimeError("all ranks died while re-protecting the elastic world")
            log.warning("re-protect checkpoint failed; shrinking to %d survivors", survivors)
            self._swap_engine(survivors)
            self.cluster.resize(survivors)  # clears the revoked flag too
        self._last_ckpt_step = self._state_step()
        return meta

    def restore_elastic(self, n_new: int) -> dict[str, Any]:
        """Elastic transition to ``n_new`` ranks from the last checkpoint —
        shrink (fewer hosts, no spares needed) or grow (scale-up). The merged
        global state is bit-identical; only the shard topology changes."""
        def elastic() -> dict[str, Any]:
            meta = self._elastic_recover(n_new)
            self._scatter("elastic")
            return meta

        return self._lead(elastic)

    def cold_restart(self) -> dict[str, Any]:
        """Restart a fresh job from the persistent tier ladder: nothing in
        memory (the previous process died), the newest valid generation on
        disk rehydrates the stores, and training resumes from its step,
        bitwise, the data pipeline's state included. When the stored world
        size N differs from this job's ``n_virtual_hosts`` M, the checkpoint
        is repartitioned N to M through ``restore_elastic``. On a mesh the
        loaded state is scattered to every process."""
        return self._lead(self._cold_restart)

    def _cold_restart(self) -> dict[str, Any]:
        eng = self.engine
        if not eng.has_tier_data():
            raise RuntimeError("cold restart requested but no tier holds data")
        eng.escalate_from_tiers()  # the engine resizes to the stored N
        n_stored = eng.n_ranks
        self.cluster.resize(n_stored)  # liveness realigned to the loaded world
        if n_stored != self.tcfg.n_virtual_hosts:
            log.info("cold restart: stored world %d -> job world %d (elastic N-to-M)",
                     n_stored, self.tcfg.n_virtual_hosts)
            meta = self._elastic_recover(self.tcfg.n_virtual_hosts)
        else:
            meta = eng.restore()
            self._last_ckpt_step = int(meta.get("step", 0))
        self.n_recoveries += 1
        self._scatter("cold")
        log.info("cold restart complete: resuming from step %s", meta.get("step"))
        return meta

    def _swap_engine(self, n_new: int) -> None:
        """Rebuild the engine for a new world size; entities carry over and
        re-shard themselves at the next checkpoint."""
        old = self.engine
        old.close()  # its worker pool; a pending snapshot was discarded by the restore
        new_engine = CheckpointEngine(n_new, self._engine_cfg, device=self.device)
        new_engine._entities = dict(old._entities)
        new_engine._replicated = set(old._replicated)
        # the tier ladder's adaptive state crosses the resize: the retuned
        # cadence, and the flush count the retune compares against (the new
        # engine's stats start at zero)
        for old_tier, new_tier in zip(old.persistent_tiers, new_engine.persistent_tiers):
            new_tier.every = old_tier.every
        self._seen_flushes = 0
        self.cluster.n_ranks = n_new
        self.cluster._alive = set(range(n_new))
        self.cluster.attach_engine(new_engine)
        self.engine = new_engine
        # Re-point the timer mirror at the new engine-local registry so
        # `timer_seconds` keeps accumulating after an elastic resize.
        self.timers.attach_metrics(new_engine.registry)

    def regrow(self, n_new: int) -> None:
        """Elastic scale-up (paper §5.2.4): expand the failure-domain world to
        ``n_new`` ranks and immediately checkpoint so the new ranks hold their
        re-balanced shards + backups. On a mesh the live state is gathered
        to rank 0 first."""
        self._lead(lambda: self._regrow(n_new))

    def _regrow(self, n_new: int) -> None:
        if n_new < self.engine.n_ranks:
            raise ValueError(f"regrow to {n_new} < {self.engine.n_ranks} ranks")
        self._gather()
        self._swap_engine(n_new)
        ok = self.engine.checkpoint({"step": self._step_count()})
        if ok:
            self._last_ckpt_step = self._step_count()
        log.info("regrown to %d ranks (checkpoint %s)", n_new, "ok" if ok else "failed")
