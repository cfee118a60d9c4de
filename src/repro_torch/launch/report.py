"""Render a recorded checkpoint trace as a per-generation phase report (a
copy of the JAX package's ``launch/report.py``, reading this package's
traces and journals).

    PYTHONPATH=src python -m repro_torch.launch.report trace.json

Input is the Chrome-trace JSON written by ``--trace-out`` (``launch.serve``)
or by ``obs.trace.tracer().write``. The report shows, per checkpoint
generation: how long every pipeline phase ran (CAPTURE / ENCODE / TRANSFER /
VERIFY / handshake / commit / flush), how long the caller was actually
blocked, and the reconstructed overlap efficiency

    overlap_efficiency = 1 - blocked / serialized

(DESIGN.md §13) — the same quantity the scaling benchmark derives from its
sync-vs-async A/B, but measured from span structure alone. Restore-path
phases (r_transfer / decode / r_verify / deq / escalate) are listed when the
trace holds a recovery.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.obs.trace import (
    BLOCKING_PHASES,
    CREATE_PHASES,
    RESTORE_PHASES,
    generation_breakdown,
    load_instants,
    load_trace,
)

_EXTRA_PHASES = ("finalize_wait", "flush_wait", "flush", "restore")

#: Instant markers and spans that participate in the failover timeline
#: (DESIGN.md §15): detect -> promote -> rebuild -> re-enroll.
_FAILOVER_INSTANTS = ("kill", "heartbeat_lost", "replica_promote")
_FAILOVER_SPANS = ("replica_sync", "replica_promote_restore", "replica_reenroll")


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:8.3f}s"
    return f"{v * 1e3:7.2f}ms"


def failover_timeline(
    spans: list[dict], instants: list[dict]
) -> list[dict]:
    """Chronological failover narrative extracted from a trace: every kill /
    heartbeat_lost / replica_promote instant plus the replica_sync,
    replica_promote_restore (blocking rebuild) and replica_reenroll spans,
    normalized to ``{"t0", "dur", "event", "detail"}`` rows with ``t0``
    relative to the first event. Empty when the trace holds no failover."""
    rows = []
    for ev in instants:
        if ev["name"] not in _FAILOVER_INSTANTS:
            continue
        a = ev.get("args", {})
        if ev["name"] == "kill":
            detail = f"rank={a.get('rank')} cause={a.get('cause')}"
            if a.get("silent"):
                detail += " silent"
        elif ev["name"] == "heartbeat_lost":
            detail = f"rank={a.get('rank')} missed={a.get('missed')}"
        else:  # replica_promote
            detail = (f"gen={a.get('gen')} failed_primary={a.get('failed_primary')}"
                      f" failed_shadow={a.get('failed_shadow')}")
        rows.append({"t0": ev["t0"], "dur": 0.0, "event": ev["name"],
                     "detail": detail})
    for ev in spans:
        if ev["name"] not in _FAILOVER_SPANS:
            continue
        a = ev.get("args", {})
        detail = f"gen={a.get('gen')}" if a.get("gen") is not None else ""
        rows.append({"t0": ev["t0"], "dur": ev["dur"], "event": ev["name"],
                     "detail": detail})
    if not rows:
        return []
    rows.sort(key=lambda r: r["t0"])
    base = rows[0]["t0"]
    for r in rows:
        r["t0"] -= base
    return rows


def render_failover(rows: list[dict]) -> list[str]:
    lines = ["", "failover timeline (t relative to first fault event):"]
    hdr = f"{'t':>10} {'dur':>10}  event"
    lines.append(hdr)
    lines.append("-" * 48)
    for r in rows:
        dur = _fmt_s(r["dur"]) if r["dur"] > 0 else f"{'-':>10}"
        lines.append(
            f"{_fmt_s(r['t0']):>10} {dur:>10}  {r['event']}  {r['detail']}"
        )
    promotes = [r for r in rows if r["event"] == "replica_promote_restore"]
    if promotes:
        lines.append(
            f"promotion stall (blocking restore on the promoted team): "
            f"{_fmt_s(sum(r['dur'] for r in promotes))}"
        )
    return lines


def policy_timeline(events: list[dict]) -> list[dict]:
    """Adaptive-protection narrative from journal events (DESIGN.md §16):
    every ``policy`` record — codec flips chosen by
    :class:`repro_torch.core.policy.ProtectionPolicy` and heartbeat-threshold
    retunes — normalized to ``{"t0", "target", "detail"}`` rows with ``t0``
    relative to the first journal event."""
    evs = [e for e in events if e.get("kind") == "policy"]
    if not evs:
        return []
    base = min(
        (e["ts"] for e in events if isinstance(e.get("ts"), (int, float))),
        default=0.0,
    )
    rows = []
    for e in evs:
        if e.get("target") == "codec":
            detail = (
                f"entity={e.get('entity')} -> {e.get('codec')} m={e.get('m')} "
                f"({e.get('reason', '')})"
            )
        elif e.get("target") == "heartbeat":
            detail = (
                f"miss_threshold={e.get('miss_threshold')} "
                f"(base={e.get('base')}, mtbf={e.get('mtbf_s'):.3g}s)"
            )
        else:
            detail = " ".join(
                f"{k}={v}" for k, v in e.items() if k not in ("kind", "ts", "target")
            )
        rows.append({
            "t0": (e.get("ts") or base) - base,
            "target": e.get("target", "?"),
            "detail": detail,
        })
    return rows


def render_policy(rows: list[dict]) -> list[str]:
    lines = ["", "adaptive protection decisions (journal 'policy' events):"]
    lines.append(f"{'t':>10}  {'target':<10} decision")
    lines.append("-" * 48)
    for r in rows:
        lines.append(f"{_fmt_s(r['t0']):>10}  {r['target']:<10} {r['detail']}")
    return lines


def load_journal(path: str) -> list[dict]:
    """Parse an ``EventJournal``'s JSON-lines file (torn tails tolerated)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if isinstance(ev, dict) and "kind" in ev:
                events.append(ev)
    return events


def render(path: str, eng: int | None = None,
           journal: str | None = None) -> str:
    """The report text (also returned for tests / programmatic use)."""
    events = load_trace(path)
    gens = generation_breakdown(events, eng=eng)
    lines: list[str] = []
    jrows = policy_timeline(load_journal(journal)) if journal else []
    if not gens:
        lines.append("no labeled checkpoint generations in trace")
        fo = failover_timeline(events, load_instants(path))
        if fo:
            lines.extend(render_failover(fo))
        if jrows:
            lines.extend(render_policy(jrows))
        return "\n".join(lines) + "\n"

    phase_order = [
        p for p in (*CREATE_PHASES, *_EXTRA_PHASES, *RESTORE_PHASES)
        if any(p in rec["phases"] for rec in gens.values())
    ]
    hdr = f"{'gen':>5} " + " ".join(f"{p:>13}" for p in phase_order)
    hdr += f" {'blocked':>10} {'overlap_eff':>11}"
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for g in sorted(gens, key=lambda x: (not isinstance(x, int), x)):
        rec = gens[g]
        row = f"{g!s:>5} "
        row += " ".join(
            f"{_fmt_s(rec['phases'][p]):>13}" if p in rec["phases"] else f"{'-':>13}"
            for p in phase_order
        )
        has_wait = "finalize_wait" in rec["phases"]
        row += f" {_fmt_s(rec['blocked_s']):>10}"
        row += f" {rec['overlap_efficiency']:>10.1%}" if has_wait else f" {'(sync)':>11}"
        lines.append(row)

    waited = [
        rec["overlap_efficiency"] for rec in gens.values()
        if "finalize_wait" in rec["phases"] and rec["serialized_s"] > 0
    ]
    if waited:
        lines.append("")
        lines.append(
            f"async generations: {len(waited)}; overlap efficiency "
            f"best={max(waited):.1%} mean={sum(waited) / len(waited):.1%}"
        )
    lines.append(
        f"blocking phases: {', '.join(BLOCKING_PHASES)}; "
        f"{len(events)} spans total"
    )
    fo = failover_timeline(events, load_instants(path))
    if fo:
        lines.extend(render_failover(fo))
    if jrows:
        lines.extend(render_policy(jrows))
    return "\n".join(lines) + "\n"


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Per-generation phase breakdown of a --trace-out file"
    )
    ap.add_argument("trace", help="Chrome-trace JSON written by --trace-out")
    ap.add_argument("--eng", type=int, default=None,
                    help="filter to one engine's spans (the 'eng' label)")
    ap.add_argument("--journal", default=None,
                    help="an EventJournal's JSON-lines file; adds the "
                         "adaptive-protection decision section")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw per-generation dict as JSON instead")
    args = ap.parse_args()
    if args.json:
        events = load_trace(args.trace)
        gens = generation_breakdown(events, eng=args.eng)
        out = {
            "generations": {str(k): v for k, v in gens.items()},
            "failover": failover_timeline(events, load_instants(args.trace)),
            "policy": (
                policy_timeline(load_journal(args.journal))
                if args.journal else []
            ),
        }
        print(json.dumps(out, indent=2))
    else:
        print(render(args.trace, eng=args.eng, journal=args.journal), end="")


if __name__ == "__main__":
    main()
