"""Dry run: account every (architecture x input shape) cell on the production
meshes (16x16 single-pod, 2x16x16 multi-pod) at full width, allocating
nothing.

The JAX package lowers and compiles each cell with XLA on 512 virtual host
devices and reads XLA's memory and cost analyses and the partitioned HLO.
The port has no compiler, so a cell is the program's own accounting, on
``torch.device("meta")``:

* ``memory``: per-device bytes on the worst rank, from the step bundle's
  ``TensorSpec``s and specs (each leaf's shard shape times its item size):
  ``argument_size_in_bytes`` (and ``argument_bytes_by_input``, per input),
  ``alias_size_in_bytes`` (the donated inputs: the train state, the decode
  cache) and ``output_size_in_bytes`` (the outputs whose sharding the step
  declares); ``output_bytes_undeclared_global`` holds the whole bytes of
  the outputs whose sharding the reference leaves to its compiler.
* ``cost``: ``flops`` (``torch.utils.flop_counter.FlopCounterMode``) and
  ``bytes accessed`` (each aten op's input and output bytes; views and bare
  allocations move none) of one global step, the step run on meta tensors at
  the full global batch (on meta tensors the time of a count does not grow
  with the batch). The depth is counted at 1, 2 and 3 periods (the
  repeated layer pattern) and extrapolated to the config's: every period
  runs the same ops on the same shapes, so each op's count, FLOPs and bytes
  are a polynomial of degree at most 2 in the number of periods (degree 2:
  the backward of each period's slice of the stacked layer weights writes
  and accumulates gradients of the whole stack). ``count`` records the
  batch, the probe periods and the config's. The per-op table of the probes
  is written beside the record as ``<tag>.ops.json.gz``, where the reference
  writes ``<tag>.hlo.gz``.
* ``absent`` names each key of the reference's record that only XLA fills:
  ``collectives`` and ``hlo_estimate`` (GSPMD's partitioned HLO), and
  ``memory.temp_size_in_bytes``, ``memory.generated_code_size_in_bytes``
  and ``memory.total_bytes_per_device`` (its buffer assignment).

The snapshot and restore cells are the device tier's program accounting
(``core/device_tier.py``), with the reference's keys. A cell's status is
``accounted`` (``built`` under ``--fast``, which skips the count),
``skipped`` (with ``applicability``'s reason) or ``failed`` (with the error
and its traceback); the run exits 1 when any cell failed.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --snapshot --restore --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import math
import os
import time
import traceback
from typing import Any

ACCOUNTED = "accounted"

ABSENT_CELL = {
    "collectives": "GSPMD's partitioned HLO: the port compiles nothing",
    "hlo_estimate": "GSPMD's partitioned HLO: the port compiles nothing",
    "memory.temp_size_in_bytes": "XLA's buffer assignment: no counterpart",
    "memory.generated_code_size_in_bytes": "XLA's executable: no counterpart",
    "memory.total_bytes_per_device": "needs the temp bytes",
}
ABSENT_PROGRAM = {
    "memory": "XLA's memory analysis of the compiled program: no counterpart",
    "cost": "XLA's cost analysis of the compiled program: no counterpart",
    "collectives": "GSPMD's partitioned HLO: the port compiles nothing",
}
PROBE_PERIODS = (1, 2, 3)

# the inputs of each step, in argument order
_INPUTS = {"train_step": ("state", "batch"), "prefill_step": ("params", "batch"),
           "serve_step": ("params", "cache", "token", "pos")}


def _mesh(kind: Any):
    """A production mesh by name, or the mesh itself."""
    from repro_torch.launch.mesh import make_production_mesh

    if not isinstance(kind, str):
        return kind
    return make_production_mesh(multi_pod=(kind == "multi"))


def _mesh_name(kind: Any) -> str:
    return kind if isinstance(kind, str) else "x".join(str(s) for s in kind.shape.values())


# ---------------------------------------------------------------------------
# memory: per-device bytes from the specs
# ---------------------------------------------------------------------------

def shard_bytes(sds: Any, spec: tuple, mesh: Any) -> int:
    """Bytes of the worst rank's shard of one leaf (``spec`` None: whole)."""
    from repro_torch.sharding.mesh import axes_of

    n = sds.dtype.itemsize
    for i, d in enumerate(sds.shape):
        e = spec[i] if spec is not None and i < len(spec) else None
        n *= -(-int(d) // math.prod(mesh.shape[a] for a in axes_of(e)))
    return n


def _pairs(tree: Any, specs: Any) -> list[tuple[Any, Any]]:
    """(leaf, spec) pairs of a tree of tuples and dicts; ``specs`` None (or
    None below some node) gives every leaf under it the spec None."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _pairs(tree[k], None if specs is None else specs[k])]
    if isinstance(tree, (tuple, list)):
        return [p for i, t in enumerate(tree) for p in _pairs(t, None if specs is None else specs[i])]
    return [] if tree is None else [(tree, specs)]


def _tree_bytes(tree: Any, specs: Any, mesh: Any) -> int:
    return sum(shard_bytes(x, s, mesh) for x, s in _pairs(tree, specs))


def memory_accounting(bundle: Any, outputs: Any = None) -> dict[str, Any]:
    """Per-device argument, alias and declared output bytes of a step bundle
    (``outputs``: the step's outputs, tensors or ``TensorSpec``s)."""
    mesh = bundle.mesh
    by_input = {name: _tree_bytes(a, s, mesh)
                for name, a, s in zip(_INPUTS[bundle.name], bundle.args_sds, bundle.in_pspecs)}
    names = _INPUTS[bundle.name]
    out = {
        "argument_size_in_bytes": sum(by_input.values()),
        "argument_bytes_by_input": by_input,
        "alias_size_in_bytes": sum(by_input[names[i]] for i in bundle.donate_argnums),
    }
    if outputs is not None:
        pairs = _pairs(outputs, bundle.out_pspecs if bundle.out_pspecs is not None else None)
        out["output_size_in_bytes"] = sum(shard_bytes(x, s, mesh) for x, s in pairs if s is not None)
        out["output_bytes_undeclared_global"] = sum(shard_bytes(x, None, mesh) for x, s in pairs if s is None)
    return out


# ---------------------------------------------------------------------------
# cost: the step on meta tensors under a FLOP counter and a byte counter
# ---------------------------------------------------------------------------

def _op_modes():
    """(flop counter, byte counter) modes, built on first use: importing
    this module enters and builds nothing."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    allocs = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
              torch.ops.aten.new_empty.default, torch.ops.aten.new_empty_strided.default}

    def nbytes(xs) -> int:
        n = 0
        for x in xs:
            if isinstance(x, torch.Tensor):
                n += x.numel() * x.element_size()
            elif isinstance(x, (list, tuple)):
                n += nbytes(x)
        return n

    class ByteCounter(TorchDispatchMode):
        """Each aten op's count and input + output bytes, by op."""

        def __init__(self) -> None:
            super().__init__()
            self.ops: dict[str, list[int]] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            row = self.ops.setdefault(str(func.overloadpacket), [0, 0])
            row[0] += 1
            if not func.is_view and func not in allocs:
                row[1] += nbytes(args) + nbytes(kwargs.values()) + nbytes((out,))
            return out

    return FlopCounterMode(display=False), ByteCounter()


def _meta(tree: Any) -> Any:
    import torch

    from repro_torch.utils.pytree import tree_map

    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), tree)


def count_ops(cfg: Any, shape_name: Any, mesh: Any, periods: int) -> tuple[dict, Any]:
    """One global step of ``cfg`` cut to ``periods`` periods, on meta
    tensors: ``{op: [count, flops, bytes]}`` and the step's outputs
    (``shape_name`` as ``build_step`` takes it)."""
    from repro_torch.launch.steps import build_step

    cut = dataclasses.replace(cfg, num_layers=periods * cfg.period)
    bundle = build_step(cut, shape_name, mesh)
    flops, nbytes = _op_modes()
    with flops, nbytes:
        outputs = bundle.fn(*(_meta(a) for a in bundle.args_sds))
    by_op = {str(op): int(n) for op, n in flops.get_flop_counts().get("Global", {}).items()}
    table = {op: [c, by_op.get(op, 0), b] for op, (c, b) in sorted(nbytes.ops.items())}
    return table, outputs


def extrapolate(tables: dict[int, dict], periods: int) -> dict[str, list[int]]:
    """Each op's [count, flops, bytes] at ``periods`` from the probes at 1,
    2 and 3 periods: the quadratic through them, in integers (Lagrange's
    form; both halved products are of consecutive integers)."""
    t1, t2, t3 = (tables[p] for p in PROBE_PERIODS)
    n = periods
    w1, w2, w3 = (n - 2) * (n - 3) // 2, -(n - 1) * (n - 3), (n - 1) * (n - 2) // 2
    zero = [0, 0, 0]
    out = {}
    for op in sorted(set(t1) | set(t2) | set(t3)):
        row = [w1 * a + w2 * b + w3 * c for a, b, c in zip(t1.get(op, zero), t2.get(op, zero), t3.get(op, zero))]
        if any(row):
            out[op] = row
    return out


def cost_of(table: dict[str, list[int]]) -> dict[str, float]:
    return {"flops": float(sum(r[1] for r in table.values())),
            "bytes accessed": float(sum(r[2] for r in table.values()))}


def count_cell(cfg: Any, shape_name: str, mesh: Any) -> dict[str, Any]:
    """The cell's op tables at the probe periods, its cost and the outputs
    at the config's depth (as ``TensorSpec``s: the train state and the cache
    from their declarations)."""
    tables, outs = {}, {}
    for p in PROBE_PERIODS:
        tables[p], outs[p] = count_ops(cfg, shape_name, mesh, p)
    full = extrapolate(tables, cfg.num_periods)
    return {"tables": tables, "cost": cost_of(full), "n_ops": sum(r[0] for r in full.values()),
            "outputs": outs[PROBE_PERIODS[0]]}


def _full_outputs(bundle: Any, probe_outputs: Any, shape: Any) -> Any:
    """The step's outputs at the config's depth: the declared trees from the
    declarations (the state, the cache), the rest (logits, loss) from the
    probe, whose shapes do not depend on the depth."""
    from repro_torch.sharding.spec import TensorSpec, specs_to_shape_dtype
    from repro_torch.utils.pytree import tree_map

    def spec(x):
        return TensorSpec(tuple(x.shape), x.dtype)

    if bundle.name == "train_step":
        return bundle.args_sds[0], tree_map(spec, probe_outputs[1])
    logits, cache = probe_outputs
    if bundle.name == "serve_step":
        return spec(logits), bundle.args_sds[1]
    if cache is None:  # the encoder's prefill
        return spec(logits), None
    return spec(logits), specs_to_shape_dtype(bundle.model.abstract_cache(shape.global_batch, shape.seq_len))


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, mesh_kind: Any, fast: bool = False, ops_out: str | None = None,
             counts: dict | None = None) -> dict[str, Any]:
    """One (arch x shape x mesh) cell. ``counts`` caches the op counts by
    (arch, shape): a global step's count does not depend on the mesh."""
    from repro_torch.configs import SHAPES, applicability, get_config
    from repro_torch.launch.steps import build_step

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = applicability(cfg, shape)
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh_kind), "kind": shape.kind}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    mesh = _mesh(mesh_kind)
    rec["mesh_shape"] = dict(mesh.shape)
    t0 = time.time()
    bundle = build_step(cfg, shape_name, mesh)
    rec["step"] = bundle.name
    rec["build_s"] = round(time.time() - t0, 2)
    info = dict(n_params=bundle.model.n_params, n_active_params=bundle.model.n_active_params,
                tokens=shape.tokens if shape.kind != "decode" else shape.global_batch)
    if fast:
        rec.update(status="built", memory=memory_accounting(bundle), **info)
        return rec

    t1 = time.time()
    key = (arch, shape_name)
    counted = counts.get(key) if counts is not None else None
    if counted is None:
        counted = count_cell(cfg, shape_name, mesh)
        if counts is not None:
            counts[key] = counted
    rec["count_s"] = round(time.time() - t1, 2)
    rec.update(
        status=ACCOUNTED,
        memory=memory_accounting(bundle, _full_outputs(bundle, counted["outputs"], shape)),
        cost=counted["cost"],
        count={"batch": shape.global_batch, "probe_periods": list(PROBE_PERIODS), "periods": cfg.num_periods,
               "n_ops": counted["n_ops"]},
        absent=dict(ABSENT_CELL),
        **info,
    )
    if ops_out:
        write_ops(ops_out, counted["tables"], cfg.num_periods)
    print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: accounted "
          f"(build {rec['build_s']}s, count {rec['count_s']}s)")
    print(f"  memory: {rec['memory']}")
    print(f"  cost: flops={rec['cost']['flops']} bytes={rec['cost']['bytes accessed']}")
    return rec


def write_ops(path: str, tables: dict[int, dict], periods: int) -> None:
    with gzip.open(path, "wt") as f:
        json.dump({"periods": periods, "columns": ["count", "flops", "bytes"],
                   "probes": {str(p): t for p, t in tables.items()}}, f)


def read_ops(path: str) -> tuple[dict[int, dict], int]:
    with gzip.open(path, "rt") as f:
        d = json.load(f)
    return {int(p): t for p, t in d["probes"].items()}, int(d["periods"])


def _train_state(cfg: Any, mesh: Any) -> tuple[Any, Any]:
    """The train state's ``TensorSpec``s and specs, as ``build_step(cfg,
    "train_4k", mesh)`` declares them."""
    from repro_torch.launch.steps import build_step

    bundle = build_step(cfg, "train_4k", mesh)
    return bundle.args_sds[0], bundle.in_pspecs[0]


def snapshot_accounting(cfg: Any, mesh: Any, compress: bool = False, codec: str = "copy", parity_group: int = 0,
                        rs_parity: int = 2) -> dict[str, Any]:
    """The snapshot program's byte accounting for the train state."""
    from repro_torch.core.device_tier import cached_snapshot_program

    state_sds, pspecs = _train_state(cfg, mesh)
    prog = cached_snapshot_program(mesh, state_sds, pspecs, redundancy_axis="data", compress=compress,
                                   codec=codec, parity_group=parity_group, rs_parity=rs_parity)
    return {
        "exchanged_bytes_global": prog.exchanged_bytes,
        "own_bytes_global": prog.own_bytes,
        "pcie_bytes_global": prog.pcie_bytes,
        "snapshot_codec": codec,
        "fused_buckets": len(prog.buckets),
    }


def restore_accounting(cfg: Any, mesh: Any, codec: str = "rs", parity_group: int = 4,
                       rs_parity: int = 2) -> dict[str, Any]:
    """The striped restore program's byte accounting for the train state."""
    from repro_torch.core.device_tier import cached_striped_restore_program

    state_sds, pspecs = _train_state(cfg, mesh)
    prog = cached_striped_restore_program(mesh, state_sds, pspecs, redundancy_axis="data", codec=codec,
                                          parity_group=parity_group, rs_parity=rs_parity)
    return {
        "restore_codec": codec,
        "parity_group": parity_group,
        "rs_parity": rs_parity,
        "fused_buckets": len(prog.buckets),
        "pcie_bytes_global": prog.pcie_bytes,
        "host_decode_pcie_bytes_global": prog.host_decode_pcie_bytes,
        "pcie_savings_vs_host_decode": round(1.0 - prog.pcie_bytes / max(prog.host_decode_pcie_bytes, 1), 4),
    }


def run_snapshot_cell(arch: str, mesh_kind: Any, compress: bool = False, codec: str = "copy",
                      parity_group: int = 0, rs_parity: int = 2) -> dict[str, Any]:
    """The device tier's snapshot program for this arch's train state (the
    paper's checkpoint-creation hot path); ``codec="xor"/"rs"`` accounts the
    fused on-device encode, whose ``pcie_bytes_global`` counts stripes
    instead of whole partner copies."""
    from repro_torch.configs import get_config

    t0 = time.time()
    acc = snapshot_accounting(get_config(arch), _mesh(mesh_kind), compress, codec, parity_group, rs_parity)
    tag = "snapshot_step" + ("_compressed" if compress else "")
    if codec != "copy":
        tag += f"_{codec}{parity_group}"
    rec = {"arch": arch, "shape": tag, "mesh": _mesh_name(mesh_kind), "kind": "snapshot", **acc,
           "account_s": round(time.time() - t0, 2), "status": ACCOUNTED, "absent": dict(ABSENT_PROGRAM)}
    print(f"[dryrun] {arch} snapshot_step x {rec['mesh']}: accounted in {rec['account_s']}s; "
          f"exchanged {acc['exchanged_bytes_global'] / 2**30:.2f} GiB global")
    return rec


def run_restore_cell(arch: str, mesh_kind: Any, codec: str = "rs", parity_group: int = 4,
                     rs_parity: int = 2) -> dict[str, Any]:
    """The device tier's fused striped restore program for this arch's train
    state: the PCIe bytes of the on-device restore (survivor shards and held
    stripes up) against the host decode's (stripes and survivor buffers
    down, decoded buffers back up)."""
    from repro_torch.configs import get_config

    t0 = time.time()
    acc = restore_accounting(get_config(arch), _mesh(mesh_kind), codec, parity_group, rs_parity)
    rec = {"arch": arch, "shape": f"restore_{codec}{parity_group}", "mesh": _mesh_name(mesh_kind),
           "kind": "restore", **acc, "account_s": round(time.time() - t0, 2), "status": ACCOUNTED,
           "absent": dict(ABSENT_PROGRAM)}
    print(f"[dryrun] {arch} restore_{codec}{parity_group} x {rec['mesh']}: accounted in {rec['account_s']}s; "
          f"PCIe {acc['pcie_bytes_global'] / 2**30:.2f} GiB on-device vs "
          f"{acc['host_decode_pcie_bytes_global'] / 2**30:.2f} GiB host-decode "
          f"({100 * acc['pcie_savings_vs_host_decode']:.0f}% saved)")
    return rec


def _failed(arch: str, shape: str, mesh_kind: str, e: Exception) -> dict[str, Any]:
    return {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "failed",
            "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-4000:]}


def _write(path: str, rec: dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)


def main(argv: list[str] | None = None) -> None:
    from repro_torch.configs import SHAPES, list_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--snapshot", action="store_true", help="account the checkpoint snapshot program too")
    ap.add_argument("--snapshot-compress", action="store_true")
    ap.add_argument("--snapshot-codec", default="copy", choices=["copy", "xor", "rs"],
                    help="on-device redundancy encode for the snapshot program")
    ap.add_argument("--snapshot-parity-group", type=int, default=0,
                    help="group size g for --snapshot-codec xor/rs (default 4 when a striped codec is selected)")
    ap.add_argument("--restore", action="store_true",
                    help="account the fused striped RESTORE program too (per-arch PCIe comparison: "
                         "on-device restore vs host decode)")
    ap.add_argument("--restore-codec", default="rs", choices=["xor", "rs"],
                    help="striped codec for the --restore cell")
    ap.add_argument("--fast", action="store_true", help="build and account memory only (no op count)")
    ap.add_argument("--skip-existing", action="store_true", help="skip cells whose JSON already exists (resume)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    if args.snapshot_codec != "copy" and args.snapshot_parity_group < 1:
        args.snapshot_parity_group = 4  # striped codecs need a group size

    archs = list_archs() if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    counts: dict = {}
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch}__{shape}__{mesh_kind}".replace("/", "_")
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    continue
                try:
                    rec = run_cell(arch, shape, mesh_kind, fast=args.fast, counts=counts,
                                   ops_out=None if args.fast else os.path.join(args.out, tag + ".ops.json.gz"))
                except Exception as e:
                    failures += 1
                    rec = _failed(arch, shape, mesh_kind, e)
                    print(f"[dryrun] FAILED {tag}: {rec['error']}")
                _write(path, rec)
            counts.pop((arch, shape), None)  # shared by the meshes only
        if args.snapshot:
            for mesh_kind in meshes:
                tag = f"{arch}__snapshot__{mesh_kind}" + ("_comp" if args.snapshot_compress else "")
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    continue
                try:
                    rec = run_snapshot_cell(arch, mesh_kind, compress=args.snapshot_compress,
                                            codec=args.snapshot_codec, parity_group=args.snapshot_parity_group)
                except Exception as e:
                    failures += 1
                    rec = _failed(arch, "snapshot", mesh_kind, e)
                    print(f"[dryrun] FAILED {tag}: {rec['error']}")
                _write(path, rec)
        if args.restore:
            g = args.snapshot_parity_group if args.snapshot_parity_group >= 1 else 4
            for mesh_kind in meshes:
                tag = f"{arch}__restore__{mesh_kind}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    continue
                try:
                    rec = run_restore_cell(arch, mesh_kind, codec=args.restore_codec, parity_group=g)
                except Exception as e:
                    failures += 1
                    rec = _failed(arch, "restore", mesh_kind, e)
                    print(f"[dryrun] FAILED {tag}: {rec['error']}")
                _write(path, rec)
    print(f"dry-run complete; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
