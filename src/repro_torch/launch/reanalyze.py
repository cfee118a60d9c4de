"""Re-derive the dry run's cost and collective fields from its saved
artifacts, without tracing or compiling again.

An accounted cell of the port (``launch/dryrun.py``) comes with
``<tag>.ops.json.gz``, its per-op table at the probe depths: its ``cost``
and ``count.n_ops`` are re-derived from that table. A cell the JAX package
compiled comes with ``<tag>.hlo.gz``: its ``collectives`` and
``hlo_estimate`` are re-derived from the HLO text through ``utils/hlo.py``,
as the JAX package's reanalysis does. Any other record is left as it is.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze --dir experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from repro_torch.configs import CONFIGS
from repro_torch.launch.dryrun import ACCOUNTED, cost_of, extrapolate, read_ops
from repro_torch.utils.hlo import analyze_hlo_collectives, estimate_hlo_costs


def _reanalyze_ops(rec: dict, ops_path: str) -> None:
    tables, periods = read_ops(ops_path)
    full = extrapolate(tables, periods)
    rec["cost"] = cost_of(full)
    rec["count"]["n_ops"] = sum(r[0] for r in full.values())


def _reanalyze_hlo(rec: dict, hlo_path: str) -> None:
    with gzip.open(hlo_path, "rt") as f:
        hlo = f.read()
    cfg = CONFIGS.get(rec["arch"])
    trip = cfg.num_periods if (cfg and cfg.scan_layers) else rec.get("while_trip", 1)
    coll = analyze_hlo_collectives(hlo, while_trip=trip)
    hw = estimate_hlo_costs(hlo, while_trip=trip)
    rec["while_trip"] = trip
    rec["collectives"] = {
        "bytes_by_kind": coll.bytes_by_kind,
        "static_bytes_by_kind": coll.static_bytes_by_kind,
        "count_by_kind": coll.count_by_kind,
        "total_bytes": coll.total_bytes,
        "total_static_bytes": coll.total_static_bytes,
        "n_fusions": coll.n_fusions,
        "n_while": coll.n_while,
        "duplicate_ops": coll.duplicate_ops,
    }
    rec["hlo_estimate"] = {
        "flops_weighted": hw.flops_weighted,
        "flops_static": hw.flops_static,
        "traffic_bytes_weighted": hw.traffic_bytes_weighted,
        "traffic_bytes_static": hw.traffic_bytes_static,
        "n_dots": hw.n_dots,
    }


def reanalyze_file(json_path: str) -> bool:
    """Re-derive one record in place; False when it has nothing to re-derive
    (skipped, failed, or without its artifact)."""
    with open(json_path) as f:
        rec = json.load(f)
    stem = json_path[: -len(".json")]
    if rec.get("status") == ACCOUNTED and os.path.exists(stem + ".ops.json.gz"):
        _reanalyze_ops(rec, stem + ".ops.json.gz")
    elif rec.get("status") == "compiled" and os.path.exists(stem + ".hlo.gz"):
        _reanalyze_hlo(rec, stem + ".hlo.gz")
    else:
        return False
    with open(json_path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    return True


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    n = 0
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        if reanalyze_file(path):
            n += 1
    print(f"reanalyzed {n} cells in {args.dir}")


if __name__ == "__main__":
    main()
