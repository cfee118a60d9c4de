"""The port's dry run (``launch/dryrun.py``, ``launch/reanalyze.py``,
``launch/mesh.py``) against what the reference's dry run records without
compiling.

The reference side runs in one child process with 512 host devices
(``_torch_jax_oracle.py dryrun``): no test imports the reference's dry run
or its mesh module in-process, since they put 512 devices in front of every
later JAX test of the process. Held equal:

* ``applicability``'s verdicts for all 40 (arch, shape) pairs, and the
  ``skipped`` records;
* ``n_params``, ``n_active_params`` and ``tokens`` of every applicable cell;
* every applicable cell's per-device argument bytes, input by input
  (``in_shardings[i].shard_shape``), for all ten configs on both production
  meshes under ``moe_mode="tp"``, and for the MoE configs under ``"ep"``;
* the train state's snapshot (copy) and striped restore (rs, g=4) program
  bytes for the same cases.

The op count: FLOPs exactly linear in the batch and every op's count,
FLOPs and bytes exactly the dry run's extrapolation in the depth, for every family at reduced width; at least 6 x active params x
tokens FLOPs for a train step. One full-width cell (llama3.2-1b,
``train_4k``, single) runs through the CLI in a child process with no
``jax`` loaded; ``reanalyze`` re-derives its cost exactly and skips what
the reference's reanalysis skips. The reference's XLA-compile tests
(``test_hlo_parser_on_real_module``, ``test_small_mesh_compile_reduced``)
are red on the reference and are not used as oracles.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import _torch_jax_oracle as oracle
from repro_torch.configs import CONFIGS, SHAPES, applicability, get_config, list_archs
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun, reanalyze
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": make_production_mesh(), "multi": make_production_mesh(multi_pod=True)}
CASES = [(a, "tp") for a in list_archs()] + [(a, "ep") for a in oracle.MOE_ARCHS]
# one config of each family, reduced
FAMILIES = ("llama3.2-1b", "mixtral-8x7b", "mamba2-780m", "jamba-1.5-large-398b", "hubert-xlarge",
            "llama-3.2-vision-90b")


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    out = tmp_path_factory.mktemp("oracle") / "dryrun.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_jax_oracle.py"), "dryrun", str(out)],
                          capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return oracle.load(str(out))[1]


def test_production_meshes_allocate_nothing():
    assert MESHES["single"].shape == {"data": 16, "model": 16}
    assert MESHES["multi"].shape == {"pod": 2, "data": 16, "model": 16}
    assert all(m.device.type == "meta" for m in MESHES.values())


def test_applicability_matches_reference(jx):
    assert len(jx["applicability"]) == len(CONFIGS) * len(SHAPES) == 40
    for key, (ok, reason) in jx["applicability"].items():
        arch, shape = key.split("/")
        assert list(applicability(CONFIGS[arch], SHAPES[shape])) == [ok, reason], key
        if not ok:
            rec = dryrun.run_cell(arch, shape, "single")
            assert (rec["status"], rec["reason"]) == ("skipped", reason)


@pytest.mark.parametrize("arch,mode", CASES)
def test_cells_match_reference(jx, arch, mode):
    """Counts and per-device argument bytes of every applicable cell, and the
    train state's snapshot and restore program bytes, on both meshes."""
    cfg = get_config(arch).with_(moe_mode=mode)
    n = 0
    for sname, shape in SHAPES.items():
        if not applicability(cfg, shape)[0]:
            continue
        for mname, mesh in MESHES.items():
            want = jx["cells"][f"{arch}/{mode}/{sname}/{mname}"]
            bundle = build_step(cfg, sname, mesh)
            mem = dryrun.memory_accounting(bundle)
            assert list(mem["argument_bytes_by_input"].values()) == want["args"], (sname, mname)
            assert mem["argument_size_in_bytes"] == sum(want["args"])
            assert bundle.model.n_params == want["n_params"]
            assert bundle.model.n_active_params == want["n_active_params"]
            if mode == "tp":
                rec = dryrun.run_cell(arch, sname, mname, fast=True)
                assert rec["status"] == "built"
                assert [rec["n_params"], rec["n_active_params"], rec["tokens"]] == \
                    [want["n_params"], want["n_active_params"], want["tokens"]]
                assert rec["memory"] == mem
            if sname == "train_4k":
                snap = dryrun.snapshot_accounting(cfg, mesh)
                rest = dryrun.restore_accounting(cfg, mesh)
                assert [snap["exchanged_bytes_global"], snap["own_bytes_global"], snap["pcie_bytes_global"],
                        snap["fused_buckets"]] == want["snapshot"], mname
                assert [rest["pcie_bytes_global"], rest["host_decode_pcie_bytes_global"],
                        rest["fused_buckets"]] == want["restore"], mname
            n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge", "llama-3.2-vision-90b"])
def test_input_specs_are_the_step_inputs(arch):
    from repro_torch.launch.steps import input_specs

    cfg = get_config(arch)
    for sname, shape in SHAPES.items():
        if not applicability(cfg, shape)[0]:
            continue
        specs = input_specs(cfg, sname)
        bundle = build_step(cfg, sname, MESHES["single"])
        assert tuple(specs.values()) == bundle.args_sds, sname


def test_snapshot_and_restore_records_have_the_reference_keys():
    snap = dryrun.run_snapshot_cell("mixtral-8x7b", "multi")
    assert set(snap) == {"arch", "shape", "mesh", "kind", "exchanged_bytes_global", "own_bytes_global",
                         "pcie_bytes_global", "snapshot_codec", "fused_buckets", "account_s", "status", "absent"}
    assert (snap["shape"], snap["kind"], snap["status"]) == ("snapshot_step", "snapshot", "accounted")
    rest = dryrun.run_restore_cell("mixtral-8x7b", "multi")
    assert set(rest) == {"arch", "shape", "mesh", "kind", "restore_codec", "parity_group", "rs_parity",
                         "fused_buckets", "pcie_bytes_global", "host_decode_pcie_bytes_global",
                         "pcie_savings_vs_host_decode", "account_s", "status", "absent"}
    assert rest["shape"] == "restore_rs4"
    # the default tp layout's bytes stay what they were before expert
    # parallelism decided the layout (and equal the reference's)
    assert (snap["own_bytes_global"], snap["pcie_bytes_global"]) == (653_841_727_492, 1_364_370_456_580)
    assert rest["host_decode_pcie_bytes_global"] == 1_776_321_822_720
    llama = dryrun.run_snapshot_cell("llama3.2-1b", "single")
    assert (llama["own_bytes_global"], llama["pcie_bytes_global"]) == (17_301_536_772, 38_183_272_452)
    assert dryrun.run_restore_cell("llama3.2-1b", "single")["host_decode_pcie_bytes_global"] == 52_204_339_200


# ---------------------------------------------------------------------------
# the op count
# ---------------------------------------------------------------------------

def _small(kind: str, batch: int) -> InputShape:
    return InputShape("small", 64, batch, kind)


@pytest.mark.parametrize("arch", FAMILIES)
def test_count_is_linear_in_batch_and_exact_in_depth(arch):
    """At reduced width: a step's FLOPs are exactly linear in the batch
    (train, prefill, and the decode step where the arch decodes), but for
    MoE's decode step, whose one routing group is the batch: its expert
    capacity is a rounded fraction of the batch (so the dry run counts at
    the full global batch). For the families whose period is one layer, at
    4 periods every op's count, FLOPs and bytes equal the dry run's
    extrapolation from 1, 2 and 3 periods (the hybrid's and the VLM's
    periods of 8 and 5 layers take too long to count 10 times over)."""
    cfg = get_config(arch).reduced()
    mesh = MESHES["single"]
    kinds = ("train", "prefill") if cfg.is_encoder else ("train", "prefill", "decode")
    for kind in kinds:
        depths = (1, 2, 3, 4) if cfg.period == 1 else (1,)
        tables = {p: dryrun.count_ops(cfg, _small(kind, 2), mesh, p)[0] for p in depths}
        if cfg.period == 1:
            assert dryrun.extrapolate(tables, 4) == tables[4], kind
        one = dryrun.cost_of(dryrun.count_ops(cfg, _small(kind, 1), mesh, 1)[0])["flops"]
        two = dryrun.cost_of(tables[1])["flops"]
        assert one > 0
        assert (two == 2 * one) != (cfg.has_moe and kind == "decode"), (kind, one, two)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_flops_at_least_six_per_active_param_and_token(arch):
    """A train step does at least 6 FLOPs per token for each active
    parameter a matmul reads. At reduced width the token embedding (a
    lookup: no FLOPs, and never read by the encoder) is a large share of the
    parameters and is left out, as Kaplan et al.'s count leaves it out; the
    full-width llama cell below holds the floor with it in."""
    cfg = get_config(arch).reduced()
    shape = _small("train", 2)
    table, _ = dryrun.count_ops(cfg, shape, MESHES["single"], cfg.num_periods)
    model = build_step(cfg, shape, MESHES["single"]).model
    n = model.n_active_params - model.abstract_params["embed"].size
    assert dryrun.cost_of(table)["flops"] >= 6 * n * shape.tokens


# ---------------------------------------------------------------------------
# the CLI at full width, and the reanalysis
# ---------------------------------------------------------------------------

CLI = ["--arch", "llama3.2-1b", "--shape", "train_4k", "--mesh", "single", "--snapshot", "--restore"]


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """The CLI in a child process that checks, on its way out, that neither
    ``jax`` nor the reference was imported and ``XLA_FLAGS`` was left as
    it was."""
    out = tmp_path_factory.mktemp("dryrun")
    code = textwrap.dedent(f"""
        import os, runpy, sys
        flags = os.environ.get("XLA_FLAGS")
        sys.argv = ["dryrun", *{CLI!r}, "--out", {str(out)!r}]
        try:
            runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
        except SystemExit as e:
            code = e.code
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
        assert not loaded, loaded
        assert os.environ.get("XLA_FLAGS") == flags
        sys.exit(code)
    """)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT,
                          env={**env, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "dry-run complete; 0 failures" in proc.stdout
    return out


def test_full_width_train_cell(jx, cli_dir):
    rec = json.loads((cli_dir / "llama3.2-1b__train_4k__single.json").read_text())
    want = jx["cells"]["llama3.2-1b/tp/train_4k/single"]
    assert rec["status"] == "accounted" and rec["step"] == "train_step"
    assert list(rec["memory"]["argument_bytes_by_input"].values()) == want["args"]
    assert rec["memory"]["alias_size_in_bytes"] == want["args"][0]  # the donated state
    assert rec["memory"]["output_size_in_bytes"] == want["args"][0]
    assert [rec["n_params"], rec["n_active_params"], rec["tokens"]] == \
        [want["n_params"], want["n_active_params"], want["tokens"]]
    assert rec["cost"]["flops"] >= 6 * rec["n_active_params"] * rec["tokens"]
    assert rec["cost"]["bytes accessed"] > 0
    assert rec["count"] == {"batch": 256, "probe_periods": [1, 2, 3], "periods": 16,
                            "n_ops": rec["count"]["n_ops"]}
    for key in ("collectives", "hlo_estimate", "memory.temp_size_in_bytes"):
        assert key in rec["absent"]
    assert "collectives" not in rec and "temp_size_in_bytes" not in rec["memory"]
    snap = json.loads((cli_dir / "llama3.2-1b__snapshot__single.json").read_text())
    assert [snap["exchanged_bytes_global"], snap["own_bytes_global"], snap["pcie_bytes_global"],
            snap["fused_buckets"]] == want["snapshot"]
    rest = json.loads((cli_dir / "llama3.2-1b__restore__single.json").read_text())
    assert [rest["pcie_bytes_global"], rest["host_decode_pcie_bytes_global"], rest["fused_buckets"]] == want["restore"]


HLO = textwrap.dedent("""
    HloModule test
    %body.1 (p: (s32[], f32[8])) -> (s32[], f32[8]) {
      %ar = f32[8]{0} all-reduce(%x), replica_groups={}, to_apply=%add
    }
    ENTRY %main (p0: f32[8]) -> f32[8] {
      %w = (s32[], f32[8]) while(%init), condition=%cond.1, body=%body.1
      %ar2 = f32[8]{0} all-reduce(%p0), replica_groups={}, to_apply=%add
    }
""")


def test_reanalyze_rederives_and_skips_what_the_reference_skips(cli_dir, tmp_path, capsys):
    import shutil

    d = tmp_path / "cells"
    shutil.copytree(cli_dir, d)
    cell = d / "llama3.2-1b__train_4k__single.json"
    want = json.loads(cell.read_text())
    broken = dict(want, cost={"flops": 0.0, "bytes accessed": 0.0})
    cell.write_text(json.dumps(broken))
    # a skipped, a failed and an artifact-less accounted record stay as they are
    others = {
        "llama3.2-1b__long_500k__single.json": dryrun.run_cell("llama3.2-1b", "long_500k", "single"),
        "x__train_4k__single.json": {"arch": "x", "shape": "train_4k", "mesh": "single", "status": "failed",
                                     "error": "E"},
        "y__train_4k__single.json": dict(want, arch="y"),
    }
    for name, rec in others.items():
        (d / name).write_text(json.dumps(rec))
    # a record the reference compiled, with its HLO: its collectives are re-derived
    ref = {"arch": "llama3.2-1b", "shape": "train_4k", "mesh": "single", "status": "compiled"}
    (d / "ref__train_4k__single.json").write_text(json.dumps(ref))
    with gzip.open(d / "ref__train_4k__single.hlo.gz", "wt") as f:
        f.write(HLO)
    before = {p.name: p.read_text() for p in d.glob("*.json") if p.name != cell.name}

    reanalyze.main(["--dir", str(d)])
    assert capsys.readouterr().out.strip() == f"reanalyzed 2 cells in {d}"
    assert json.loads(cell.read_text()) == want
    for name, text in before.items():
        if name.startswith("ref__"):
            continue
        assert (d / name).read_text() == text, name
    got = json.loads((d / "ref__train_4k__single.json").read_text())
    assert got["while_trip"] == 16  # llama3.2-1b's periods: scan_layers
    assert got["collectives"]["bytes_by_kind"]["all-reduce"] == 32 * 16 + 32
    assert got["collectives"]["n_while"] == 1 and "hlo_estimate" in got


def test_no_port_module_sets_xla_flags():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        assert "XLA_FLAGS" not in path.read_text(), path


def test_dryrun_main_exits_1_on_a_failed_cell(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no")

    monkeypatch.setattr(dryrun, "run_snapshot_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k", "--snapshot", "--out", str(tmp_path)])
    assert e.value.code == 1
    assert json.loads((tmp_path / "hubert-xlarge__decode_32k__single.json").read_text())["status"] == "skipped"
    failed = json.loads((tmp_path / "hubert-xlarge__snapshot__single.json").read_text())
    assert failed["status"] == "failed" and failed["error"] == "RuntimeError: no" and "traceback" in failed


def test_count_does_not_depend_on_the_mesh():
    cfg = get_config("mamba2-780m").reduced()
    shape = _small("train", 2)
    a = dryrun.count_ops(cfg, shape, MESHES["single"], 1)[0]
    b = dryrun.count_ops(cfg, shape, MESHES["multi"], 1)[0]
    assert a == b


def test_chip_smoke_phase4b_rehearses_on_the_cpu(jx):
    """``chip_smoke.py``'s phase 4 at the rehearsal's small llama config on
    the CPU, then phase 4b: the dry run's accounting of each of phase 4's
    runs equal to the bytes the run fetched to the host, uploaded and
    rebuilt, the per-device state bytes those of each rank's shards of the
    state, and the CLI's three cells (the production mesh, full width)
    accounted, the snapshot and restore bytes the reference's."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "rehearse_chip_smoke.py"), "--phase4b"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [p["codec"] for p in out["programs"]] == ["rs", "xor", "lrc", "copy"]
    for p in out["programs"][:3]:  # the stripes fetched are the stripes uploaded
        assert p["pcie_bytes"] == p["own_bytes"] + p["h2d_bytes"]
        assert p["restore_pcie_bytes"] == p["h2d_bytes"] + p["restored_bytes"]
    comp = out["programs"][3]
    assert comp["d2h_bytes"] == comp["own_bytes"] + comp["code_d2h_bytes"] + comp["scale_d2h_bytes"]
    st = out["state"]
    assert st["allocated_bytes"] < st["per_device_bytes"] * 8 == st["allocated_bytes"] + 7 * st["whole_leaf_bytes"]
    cells = {line.split(":")[0].split()[-1]: json.loads(line.split(": ", 1)[1])
             for line in proc.stdout.splitlines() if line.startswith("dryrun cli ")}
    want = jx["cells"]["llama3.2-1b/tp/train_4k/single"]
    snap = cells["llama3.2-1b__snapshot__single.json"]
    assert [snap["exchanged_bytes_global"], snap["own_bytes_global"], snap["pcie_bytes_global"],
            snap["fused_buckets"]] == want["snapshot"]
    assert cells["llama3.2-1b__train_4k__single.json"]["status"] == "accounted"
