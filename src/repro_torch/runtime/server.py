"""Fault-tolerant batched serving loop (port of ``repro.runtime.server``).

The paper's scheme applies to any "sequence of well-defined states"; for
inference that state is the decode session set: the KV cache, the generated
tokens and the position counter. The server checkpoints the sessions every
``checkpoint_every_tokens`` decode steps under the same engine (params are
excluded by default, ``snapshot_params=False``: they are re-read from the
job's initial weights).

Recovery rolls the sessions back to the last snapshot and re-decodes;
greedy decoding makes the regenerated continuation bitwise identical (on the
card: ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before cuBLAS is first used).

The sessions are tensors on the server's device (``cuda`` unless the caller
passes ``device="cpu"``): ``cache`` (the model's decode cache, allocated at
``max_seq`` once per prefill), ``tokens`` (B, max_seq) int32 and ``pos`` an
int32 scalar. Decode writes all three in place, and so does a restore
(``ShardedStateEntity.restore_shards``), so there is no session setter: the
engine's capture copies every leaf out before it returns, and a checkpoint
never holds the bytes of a later token.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.models.model import Model
from repro_torch.obs.trace import tracer
from repro_torch.runtime.cluster import HeartbeatMonitor, VirtualCluster
from repro_torch.runtime.failures import FailureInjector, ProcessFaultException
from repro_torch.runtime.replica import ReplicaTeam
from repro_torch.runtime.state import PROD_MESH, ShardedStateEntity, ShardPlan
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.sharding.axes import rules_for_shape, tree_pspecs
from repro_torch.sharding.mesh import make_mesh, resolve_device
from repro_torch.sharding.spec import TensorSpec, specs_to_shape_dtype
from repro_torch.utils import threefry
from repro_torch.utils.logging import get_logger
from repro_torch.utils.pytree import tree_leaves

log = get_logger("runtime.server")


class MetricsServer:
    """Tiny stdlib scrape endpoint for a :class:`repro_torch.obs.metrics.MetricsRegistry`.

    ``GET /metrics`` renders Prometheus text exposition; ``GET /metrics.json``
    renders the same registry as a JSON snapshot. The registry is resolved
    through ``registry_fn`` at every request: the server swaps its engine
    (and with it the engine-local registry) on elastic shrink and on
    promotion, and the endpoint must follow the live engine.
    """

    def __init__(self, registry_fn: Callable[[], Any], port: int = 0) -> None:
        self._registry_fn = registry_fn

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(handler) -> None:  # noqa: N805 (http.server idiom)
                try:
                    reg = registry_fn()
                    if handler.path.rstrip("/") in ("", "/metrics"):
                        body = reg.render_prometheus().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif handler.path == "/metrics.json":
                        body = json.dumps(reg.snapshot()).encode()
                        ctype = "application/json"
                    else:
                        handler.send_error(404)
                        return
                except Exception as e:  # pragma: no cover (a scrape must not kill serving)
                    handler.send_error(500, str(e))
                    return
                handler.send_response(200)
                handler.send_header("Content-Type", ctype)
                handler.send_header("Content-Length", str(len(body)))
                handler.end_headers()
                handler.wfile.write(body)

            def log_message(handler, fmt, *args) -> None:
                log.debug("metrics scrape: " + fmt, *args)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.daemon_threads = True
        self.port: int = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="metrics-server", daemon=True)
        self._thread.start()
        log.info("metrics endpoint listening on 127.0.0.1:%d", self.port)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/metrics"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def start_metrics_server(registry_fn: Callable[[], Any], port: int = 0) -> MetricsServer:
    """Serve ``registry_fn()`` on ``/metrics`` + ``/metrics.json``; ``port=0``
    picks a free port (read it back from ``.port``)."""
    return MetricsServer(registry_fn, port)


@dataclass
class ServerConfig:
    batch: int = 4
    max_seq: int = 64
    checkpoint_every_tokens: int = 8
    n_virtual_hosts: int = 4
    n_spares: int = 4
    snapshot_params: bool = False
    # "spare": spare substitution (falls back to elastic when the spare pool
    # runs dry). "elastic": N-to-M shrink onto the survivors.
    recovery_policy: str = "spare"
    # "async" captures the sessions at the decode boundary and drains behind
    # the next decode steps, committing at the following boundary
    checkpoint_mode: str = "sync"     # sync | async
    # a shadow cluster + engine lazy-synced one committed generation behind;
    # on a primary failure it is promoted instead of a codec rebuild
    replica_team: bool = False
    # heartbeat liveness: the only path that notices silent deaths; a rank is
    # declared dead after miss_threshold x straggler-grace ticks
    heartbeat: bool = True
    heartbeat_miss_threshold: int = 3
    engine: EngineConfig = field(default_factory=EngineConfig)


class Server:
    def __init__(
        self,
        model: Model,
        scfg: ServerConfig,
        params: Any | None = None,
        injector: FailureInjector | None = None,
        device: Any = None,
    ) -> None:
        if model.cfg.is_encoder:
            raise ValueError("the serving loop decodes; encoder archs export prefill only")
        if scfg.checkpoint_mode not in ("sync", "async"):
            raise ValueError(f"checkpoint_mode {scfg.checkpoint_mode!r}")
        self.model = model
        self.scfg = scfg
        self.device = resolve_device(device)
        self.params = params if params is not None else model.init(threefry.PRNGKey(0), self.device)

        self.sessions: dict[str, Any] = {}  # cache/tokens/pos once prefilled
        self._prompt_len = 0

        # failure-domain plan from the production decode rules
        mesh = make_mesh(*PROD_MESH, device=self.device)
        rules = rules_for_shape(model.rules, "decode", scfg.batch)
        cache_specs = model.abstract_cache(scfg.batch, scfg.max_seq)
        sess_sds = {
            "cache": specs_to_shape_dtype(cache_specs),
            "tokens": TensorSpec((scfg.batch, scfg.max_seq), torch.int32),
            "pos": TensorSpec((), torch.int32),
        }
        sess_pspecs = {"cache": tree_pspecs(cache_specs, rules, mesh), "tokens": (), "pos": ()}
        self.plan = ShardPlan.from_pspecs(sess_sds, sess_pspecs)

        self.cluster = VirtualCluster(scfg.n_virtual_hosts, scfg.n_spares)
        self.engine: CheckpointEngine | None = None
        self._build_engine(scfg.n_virtual_hosts)
        self.injector = injector or FailureInjector(scfg.n_virtual_hosts)
        self.n_recoveries = 0
        self.promotions = 0
        self._metrics_server: MetricsServer | None = None
        self.straggler = StragglerDetector(scfg.n_virtual_hosts)
        self._hb_tick = 0  # monotonic serving tick feeding the heartbeat
        self.heartbeat = self._new_heartbeat() if scfg.heartbeat else None
        # the shadow team's engine comes from the same factory, so promotion
        # restores through the same entity
        self.replica = (
            ReplicaTeam(scfg.n_virtual_hosts, self._new_engine, n_spares=scfg.n_spares)
            if scfg.replica_team else None
        )

    def start_metrics_server(self, port: int = 0) -> MetricsServer:
        """Expose the live engine's registry (it survives engine swaps) on
        ``/metrics`` + ``/metrics.json``; returns the running endpoint."""
        if self._metrics_server is None:
            self._metrics_server = start_metrics_server(lambda: self.engine.registry, port)
        return self._metrics_server

    def stop_metrics_server(self) -> None:
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None

    def _new_engine(self, n_ranks: int) -> CheckpointEngine:
        """Engine factory shared by the primary and the shadow team: both
        register the same live-session entity, so whichever engine restores
        writes the sessions in place."""
        eng = CheckpointEngine(n_ranks, self.scfg.engine, device=self.device)
        eng.register("sessions", ShardedStateEntity(lambda: self.sessions, self.plan))
        return eng

    def _build_engine(self, n_ranks: int) -> None:
        if self.engine is not None:
            self.engine.close()  # join and release the old drain worker
        self.engine = self._new_engine(n_ranks)
        self.cluster.attach_engine(self.engine)

    def _new_heartbeat(self) -> HeartbeatMonitor:
        return HeartbeatMonitor(
            self.cluster.n_ranks,
            miss_threshold=self.scfg.heartbeat_miss_threshold,
            straggler=self.straggler,
            registry=self.engine.registry,
            journal=self.engine.journal,
        )

    def close(self) -> None:
        """Stop the metrics endpoint and release both teams' engines."""
        self.stop_metrics_server()
        self.engine.close()
        if self.replica is not None:
            self.replica.engine.close()

    # ------------------------------------------------------------------ #
    def prefill(self, prompts: Any, **extra_inputs: Any) -> None:
        """prompts: (batch, prompt_len) integers; ``extra_inputs`` the
        model's other inputs (the VLM's ``vision``). Allocates the
        ``max_seq`` sessions on the device and fills them from the prompt's
        cache (a cross slot's ``vision_tokens`` rows whole)."""
        toks = torch.as_tensor(np.asarray(prompts, dtype=np.int32)).to(self.device)
        extra = {k: torch.as_tensor(v).to(self.device) for k, v in extra_inputs.items()}
        B, P = toks.shape
        if B != self.scfg.batch:
            raise ValueError(f"{B} prompts for a batch of {self.scfg.batch}")
        if P >= self.scfg.max_seq:
            raise ValueError(f"prompt length {P} leaves no room in max_seq {self.scfg.max_seq}")
        with torch.no_grad():
            logits, pcache = self.model.prefill(self.params, toks, **extra)
            cache = self.model.init_cache(B, self.scfg.max_seq, self.device)
            for full, part in zip(tree_leaves(cache), tree_leaves(pcache)):
                full[tuple(slice(0, n) for n in part.shape)] = part
            del pcache
            tokens = torch.zeros((B, self.scfg.max_seq), dtype=torch.int32, device=self.device)
            tokens[:, :P] = toks
            tokens[:, P] = torch.argmax(logits, dim=-1).to(torch.int32)
        self.sessions = {"cache": cache, "tokens": tokens,
                         "pos": torch.tensor(P, dtype=torch.int32, device=self.device)}

    def decode(self, n_tokens: int) -> np.ndarray:
        """Greedy-decode n_tokens for every session, fault-tolerantly."""
        produced = 0
        ticks = 0
        while produced < n_tokens:
            try:
                self.cluster.barrier("decode")
                # commit an overlapped checkpoint from the previous decode
                # boundary (its drain ran behind the last steps)
                pending = self.engine.finalize_async()
                if pending is False:
                    raise ProcessFaultException(sorted(self.cluster.failed), "checkpoint")
                if pending and self.replica is not None:
                    self._replica_tick()
                # a staged tier flush starts here, behind the next decode steps
                self.engine.kick_tier_flush()
                for r in self.injector.kills_at_step(ticks):
                    self.cluster.kill(r)
                for r in self.injector.silent_kills_at_step(ticks):
                    self.cluster.kill(r, cause="silent_death", silent=True)
                if self.replica is not None:
                    for r in self.injector.replica_kills_at_step(ticks):
                        self.replica.cluster.kill(r, cause="replica_host_failure")
                ticks += 1
                self._hb_tick += 1
                if self.heartbeat is not None:
                    lost = self.heartbeat.observe(self.cluster.alive(), self._hb_tick)
                    if lost:
                        for r in lost:
                            self.injector.note_detection(r)
                        raise ProcessFaultException(lost, "heartbeat")
                self.cluster.barrier("decode")

                pos = int(self.sessions["pos"])  # the step's one host sync
                self._decode_one(pos)
                produced = pos + 1 - self._prompt_len

                if produced % self.scfg.checkpoint_every_tokens == 0:
                    if self.scfg.checkpoint_mode == "async":
                        # capture now; the drain overlaps the next decodes
                        ok = self.engine.checkpoint_async({"pos": pos + 1})
                    else:
                        ok = self.engine.checkpoint({"pos": pos + 1})
                        if ok and self.replica is not None:
                            self._replica_tick()
                    if not ok:
                        raise ProcessFaultException(sorted(self.cluster.failed), "checkpoint")
            except ProcessFaultException as e:
                log.warning("serving fault: %s", e)
                self.recover()
                produced = self._produced()
        # commit a still-in-flight overlapped checkpoint before handing the
        # tokens back, so the final session state is protected
        final = self.engine.finalize_async()
        if final is False:
            log.warning("final session checkpoint aborted (rank died during the trailing drain); "
                        "sessions re-protect on the next decode")
        elif final and self.replica is not None:
            self._replica_tick()
        # a copy: the sessions stay live (a later decode or restore writes them)
        return self.sessions["tokens"].to("cpu", copy=True).numpy()

    def _decode_one(self, pos: int) -> None:
        """One greedy step at ``pos``: the cache, ``tokens[:, pos + 1]`` and
        ``pos`` written in place."""
        s = self.sessions
        with torch.no_grad():
            logits, _ = self.model.decode_step(self.params, s["cache"], s["tokens"][:, pos], s["pos"])
            s["tokens"][:, pos + 1] = torch.argmax(logits, dim=-1).to(torch.int32)
            s["pos"].fill_(pos + 1)

    def _produced(self) -> int:
        return int(self.sessions["pos"]) - self._prompt_len

    def prefill_and_decode(self, prompts: Any, n_tokens: int, **extra: Any) -> np.ndarray:
        self._prompt_len = int(np.shape(prompts)[1])
        self.prefill(prompts, **extra)
        # first checkpoint right after prefill (the serving baseline state)
        if self.engine.checkpoint({"pos": self._prompt_len}):
            if self.replica is not None:
                self._replica_tick()
        return self.decode(n_tokens)

    def _replica_tick(self) -> None:
        """Lazy-sync step at every commit point: install the generation
        staged at the PREVIOUS commit into the shadow stores, then stage the
        generation that just committed."""
        self.replica.catch_up()
        self.replica.stage(self.engine)

    def recover(self) -> None:
        """Recovery entry: a synced shadow team is promoted (no blocking
        rebuild); only teams without one fall into the restore machinery."""
        if self.replica is not None and self.replica.can_promote:
            self._promote_replica()
        else:
            self._recover_current()
        if self.heartbeat is not None:
            # rebuilt against the (possibly promoted or resized) engine so the
            # liveness gauge lands in the live registry, and the beats re-armed
            self.heartbeat = self._new_heartbeat()
            self.heartbeat.reset(self.cluster.alive(), self._hb_tick)

    def _promote_replica(self) -> None:
        """Failover: swap the shadow team in as the serving cluster + engine,
        roll the sessions back to its synced generation (a zero-comm unpack
        when the shadow is intact; a codec rebuild for members that died
        during catch-up; tier escalation beyond tolerance), then rebuild the
        old team and re-enroll it as the new shadow."""
        t0 = time.perf_counter()
        failed_primary = sorted(self.cluster.failed)
        old_engine = self.engine
        old_engine.discard_pending()  # stop in-flight drains
        self.cluster, self.engine = self.replica.release()
        failed_shadow = sorted(self.cluster.failed)
        gen = self.replica.synced_gen
        tracer().instant("replica_promote", gen=gen, failed_primary=len(failed_primary),
                         failed_shadow=len(failed_shadow))
        with tracer().span("replica_promote_restore", gen=gen):
            self._recover_current()
        stall = time.perf_counter() - t0
        self.promotions += 1
        self.engine.journal.record(
            "replica_promote", gen=gen, duration_s=stall,
            failed_primary=len(failed_primary), failed_shadow=len(failed_shadow),
            zero_comm=not failed_shadow,
        )
        log.info("replica promoted at gen %d in %.3fs (primary lost %d rank(s); shadow lost %d)",
                 gen, stall, len(failed_primary), len(failed_shadow))
        # the old team: rebuilt and re-enrolled as the shadow; it lazy-syncs
        # back to ready at the next commit point
        self.replica.re_enroll(old_engine)

    def _recover_current(self) -> None:
        if not self.engine.has_valid_checkpoint:
            if not self.engine.has_tier_data():
                raise RuntimeError("no valid session checkpoint")
            # whole-job loss: every in-memory session snapshot died with its
            # host; all ranks rejoin and the engine escalates to the
            # persistent tier ladder inside restore
            log.warning("no in-memory session checkpoint; escalating to the tier ladder")
            self.cluster.restart_all()
        # with no failed ranks (a clean promotion) there is nothing to shrink
        # around: stabilize is a no-op and the restore is zero-comm
        elastic = bool(self.cluster.failed) and (
            self.scfg.recovery_policy == "elastic" or self.cluster.spares_left < len(self.cluster.failed)
        )
        if elastic:
            # shrink onto the survivors: repartition the session checkpoint
            # onto M = |alive| ranks and re-protect the new world at once.
            # restore_elastic consumed the old checkpoint, so a failed
            # re-protect shrinks again and retries (the restored sessions are
            # still live in memory)
            m = len(self.cluster.alive())
            meta = self.engine.restore_elastic(m)
            self.cluster.resize(m)
            while not self.engine.checkpoint({"pos": int(meta.get("pos", 0))}):
                m = len(self.cluster.alive())
                if m < 1:
                    raise RuntimeError("all ranks died while re-protecting sessions")
                log.warning("re-protect checkpoint failed; shrinking to %d", m)
                self._build_engine(m)
                self.cluster.resize(m)
            log.info("elastic shrink to %d ranks; sessions rolled back to pos %s", m, meta.get("pos"))
        else:
            self.cluster.stabilize("spare")
            meta = self.engine.restore()
            s = self.engine.stats
            log.info(
                "sessions rolled back to pos %s (codec=%s/t%d, restore=%s %.3fs: %d chunks, %.1f MiB rebuilt)",
                meta.get("pos"), self.engine.codec.name, self.engine.codec.tolerance(),
                self.scfg.engine.restore_mode, s.last_restore_s,
                s.last_restore_chunks, s.last_restore_bytes_rebuilt / 2**20,
            )
        self.n_recoveries += 1
