"""Span tracer — nested, labeled, thread-aware timelines (DESIGN.md §13).

The create pipeline (CAPTURE / ENCODE / TRANSFER / VERIFY / COMMIT / tier
FLUSH) and the restore pipeline (TRANSFER / DECODE / DEQ / VERIFY /
escalation) emit spans through the process-global :func:`tracer`, including
from background drain workers and the flush thread — so one exported trace
shows a whole generation's overlap structure across every thread lane.

Design constraints (the overhead budget):

  * **Disabled is free.** ``tracer().span(...)`` first checks ``enabled``;
    when off it returns the shared ``_NOOP`` singleton without touching the
    event buffer, formatting a string, or taking a lock. The only cost at a
    disabled call site is the attribute check plus building the (small)
    kwargs dict.
  * **Enabled is cheap.** A span is two ``perf_counter`` reads and one
    locked list append at close; no string formatting ever happens on the
    hot path (labels are stored raw and serialized only at export).
  * **Spans always balance.** Spans are context managers, so an exception
    anywhere inside (mid-pipeline kill, abort, escalation) still closes the
    span; per-thread open-depth is tracked so tests can assert balance.

Export is the Chrome trace-event JSON format (``traceEvents`` with ``"X"``
complete events + ``"M"`` thread-name metadata), directly loadable in
Perfetto / ``chrome://tracing``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any


class _NoopSpan:
    """Shared do-nothing span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("tracer", "name", "args", "t0", "tid")

    def __init__(self, tracer: "Tracer", name: str, args: dict[str, Any]) -> None:
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self.tid = threading.get_ident()
        self.tracer._enter(self.tid)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self.tracer._record(self.name, self.t0, t1, self.tid, self.args)
        self.tracer._exit(self.tid)
        return False


class Tracer:
    """Collects complete ("X") trace events; thread-safe; disabled by default."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._events: list[tuple[str, float, float, int, dict]] = []
        self._instants: list[tuple[str, float, int, dict]] = []
        self._depth: dict[int, int] = {}
        self._t0 = time.perf_counter()

    # -- control ----------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._instants.clear()
            self._depth.clear()
            self._t0 = time.perf_counter()

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **args: Any):
        """Context manager covering one phase. ``args`` are raw labels
        (generation, group, chunk, ...) carried into the exported event."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, args)

    def instant(self, name: str, **args: Any) -> None:
        """A zero-duration marker event (failures, commits, kills)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        with self._lock:
            self._instants.append((name, now, threading.get_ident(), args))

    def _record(self, name: str, t0: float, t1: float, tid: int, args: dict) -> None:
        with self._lock:
            self._events.append((name, t0, t1, tid, args))

    def _enter(self, tid: int) -> None:
        with self._lock:
            self._depth[tid] = self._depth.get(tid, 0) + 1

    def _exit(self, tid: int) -> None:
        with self._lock:
            self._depth[tid] = self._depth.get(tid, 0) - 1

    # -- introspection ------------------------------------------------------
    def open_spans(self) -> int:
        """Total currently-open span depth across every thread. Zero whenever
        no span body is executing — the balance invariant the failure tests
        assert (exceptions close spans via the context-manager protocol)."""
        with self._lock:
            return sum(max(0, d) for d in self._depth.values())

    def events(self) -> list[dict[str, Any]]:
        """Raw recorded spans as dicts (seconds; for in-process analysis)."""
        with self._lock:
            return [
                {"name": n, "t0": t0 - self._t0, "dur": t1 - t0, "tid": tid,
                 "args": dict(a)}
                for n, t0, t1, tid, a in self._events
            ]

    # -- export -------------------------------------------------------------
    def to_chrome(self) -> dict[str, Any]:
        """Chrome-trace/Perfetto JSON object: ``"X"`` complete events in
        microseconds plus thread-name metadata, one lane per thread."""
        with self._lock:
            events = list(self._events)
            instants = list(self._instants)
        tids: dict[int, int] = {}
        names: dict[int, str] = {}

        def _tid(ident: int) -> int:
            if ident not in tids:
                tids[ident] = len(tids)
            return tids[ident]

        for th in threading.enumerate():
            names[th.ident] = th.name
        out: list[dict[str, Any]] = []
        for name, t0, t1, ident, args in events:
            out.append({
                "name": name,
                "ph": "X",
                "ts": (t0 - self._t0) * 1e6,
                "dur": max(0.0, (t1 - t0) * 1e6),
                "pid": 0,
                "tid": _tid(ident),
                "args": _jsonable(args),
            })
        for name, ts, ident, args in instants:
            out.append({
                "name": name,
                "ph": "i",
                "s": "g",
                "ts": (ts - self._t0) * 1e6,
                "pid": 0,
                "tid": _tid(ident),
                "args": _jsonable(args),
            })
        for ident, lane in sorted(tids.items(), key=lambda kv: kv[1]):
            out.append({
                "name": "thread_name",
                "ph": "M",
                "pid": 0,
                "tid": lane,
                "args": {"name": names.get(ident, f"thread-{ident}")},
            })
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def _jsonable(args: dict[str, Any]) -> dict[str, Any]:
    out = {}
    for k, v in args.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-global tracer every subsystem records into (one timeline
    across engine, tiers, device programs, trainer and server threads)."""
    return _TRACER


# ---------------------------------------------------------------------------
# Trace analysis — per-generation phase breakdown + overlap efficiency
# ---------------------------------------------------------------------------

#: Create-path phases in pipeline order (DESIGN.md §13 span taxonomy).
CREATE_PHASES = ("capture", "encode", "transfer", "verify", "handshake", "commit")
#: Restore-path phases.
RESTORE_PHASES = ("r_transfer", "decode", "r_verify", "deq", "escalate")
#: Phases whose duration blocks the caller (capture + the finalize join).
BLOCKING_PHASES = ("capture", "finalize_wait", "handshake", "commit")


def load_trace(path_or_obj: Any) -> list[dict[str, Any]]:
    """Normalize a trace (path, chrome dict, or event list) into a list of
    complete-event dicts with seconds-based ``t0``/``dur``."""
    obj = path_or_obj
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    if isinstance(obj, dict):
        obj = obj.get("traceEvents", [])
    out = []
    for ev in obj:
        if ev.get("ph") != "X":
            continue
        if "t0" in ev:
            out.append(ev)
        else:
            out.append({
                "name": ev["name"],
                "t0": ev.get("ts", 0.0) / 1e6,
                "dur": ev.get("dur", 0.0) / 1e6,
                "tid": ev.get("tid", 0),
                "args": ev.get("args", {}),
            })
    return out


def load_instants(path_or_obj: Any) -> list[dict[str, Any]]:
    """Like :func:`load_trace` but for instant markers (``ph == "i"``):
    kill / heartbeat_lost / replica_promote / commit events. Returns dicts
    with seconds-based ``t0`` (``dur`` is always 0)."""
    obj = path_or_obj
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    if isinstance(obj, dict):
        obj = obj.get("traceEvents", [])
    out = []
    for ev in obj:
        if ev.get("ph") not in ("i", "I"):
            continue
        if "t0" in ev:
            out.append(ev)
        else:
            out.append({
                "name": ev["name"],
                "t0": ev.get("ts", 0.0) / 1e6,
                "dur": 0.0,
                "tid": ev.get("tid", 0),
                "args": ev.get("args", {}),
            })
    return out


def generation_breakdown(
    events: list[dict[str, Any]], eng: int | None = None
) -> dict[Any, dict[str, Any]]:
    """Per-generation phase totals + overlap efficiency from create-path
    spans. Returns ``{gen: {"phases": {name: seconds}, "counts": {...},
    "blocked_s", "serialized_s", "overlap_efficiency"}}``.

    The reconstruction mirrors the benchmark's definition: the *blocked* time
    is what the caller waited (CAPTURE + the finalize join), the *serialized*
    time is what a non-overlapped run would have paid (CAPTURE + the summed
    ENCODE/TRANSFER/VERIFY stage work + handshake/commit), and

        overlap_efficiency = 1 - blocked / serialized

    — the fraction of the sync critical path the ENCODE ‖ TRANSFER ‖ VERIFY
    pipeline hid behind the overlap window.
    """
    gens: dict[Any, dict[str, Any]] = {}
    for ev in events:
        args = ev.get("args", {})
        if eng is not None and args.get("eng") != eng:
            continue
        g = args.get("gen")
        if g is None:
            continue
        rec = gens.setdefault(
            g, {"phases": {}, "counts": {}, "blocked_s": 0.0, "serialized_s": 0.0}
        )
        name = ev["name"]
        rec["phases"][name] = rec["phases"].get(name, 0.0) + ev["dur"]
        rec["counts"][name] = rec["counts"].get(name, 0) + 1
    for rec in gens.values():
        p = rec["phases"]
        blocked = sum(p.get(n, 0.0) for n in BLOCKING_PHASES)
        stage_work = sum(p.get(n, 0.0) for n in ("encode", "transfer", "verify"))
        serialized = (
            sum(p.get(n, 0.0) for n in ("capture", "handshake", "commit"))
            + stage_work
        )
        rec["blocked_s"] = blocked
        rec["serialized_s"] = serialized
        rec["overlap_efficiency"] = (
            max(0.0, 1.0 - blocked / serialized) if serialized > 0 else 0.0
        )
    return gens


def trace_overlap_efficiency(
    path_or_obj: Any, eng: int | None = None, sync_eng: int | None = None
) -> float | None:
    """Overlap efficiency reconstructed from a trace, mirroring the
    benchmark's min-of-repeats A/B: the *blocked* time is the minimum
    per-generation blocked window among ``eng``'s generations, the
    *serialized* baseline is the minimum per-generation serialized total —
    taken from ``sync_eng``'s generations when given (the A/B's sync engine,
    whose inline drain makes serialized ≈ its measured wall time), else from
    ``eng``'s own span sums. ``None`` when the trace holds no labeled
    create-path generation with a finalize join."""
    events = load_trace(path_or_obj)
    gens = generation_breakdown(events, eng=eng)
    blocked = [
        rec["blocked_s"]
        for rec in gens.values()
        if rec["phases"].get("finalize_wait") is not None
    ]
    base = generation_breakdown(events, eng=sync_eng) if sync_eng is not None else gens
    serialized = [rec["serialized_s"] for rec in base.values() if rec["serialized_s"] > 0]
    if not blocked or not serialized:
        return None
    return max(0.0, 1.0 - min(blocked) / min(serialized))
