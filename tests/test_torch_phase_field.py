"""The paper's phase-field application on the port
(``examples/phase_field_stencil_torch.py``) against the reference example
(``examples/phase_field_stencil.py``) on the CPU at its own 128 x 128.

The reference example runs in-process through ``runpy.run_path`` (its
module globals give its ``ref``/``out`` fields, ``run``, ``step_field``,
``shift_window`` and ``PhaseFieldEntity``); the port's pieces are imported
from its twin. Tolerances, as measured:

* ``step_field`` on one float32 field: within 1 ulp of the reference's jitted
  step (98.6% of the cells bit-equal: XLA fuses the expression, the port
  runs it as eager ops in the same order); ``shift_window``: bit-equal;
* the initial field: within 3 ulp (``threefry.normal``; 1 ulp measured);
* the clean run's final field after 300 steps: within 1e-6 of the
  reference's (2.4e-7 measured), from the port's own initial field and from
  the reference's initial bytes;
* the two engines' committed stores, when both checkpoint the same field
  bytes (``from_numpy`` on the port, the reference's entity with its field
  set), byte-equal through ``dump_engine`` (the copy, xor and rs codecs);
* the port's faulty run (hosts 3 and 6 killed at steps 120 and 260)
  bit-equal to its clean run, with 2 recoveries, as the reference's.

Then the twin as a script (``--device cpu``, its output line for line the
reference's) and ``chip_smoke.py``'s phase 13 rehearsed on the CPU at
256 x 256 (``tools/rehearse_chip_smoke.py --phase13``).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_jax_oracle as oracle
from repro.core import interval as ref_interval
from repro.core.checkpoint import CheckpointEngine as JEngine
from repro.core.checkpoint import EngineConfig as JConfig
from repro_torch.core import gf256
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig

ROOT = Path(__file__).resolve().parents[1]
KILLS = {120: 3, 260: 6}
CONFIGS = {"copy": {}, "xor": dict(parity_group=4), "rs": dict(codec="rs", parity_group=4, rs_parity=2)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """The reference example's module globals and its printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(str(ROOT / "examples" / "phase_field_stencil.py"))
    return g, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def pf():
    spec = importlib.util.spec_from_file_location("phase_field_stencil_torch",
                                                  ROOT / "examples" / "phase_field_stencil_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def clean(pf):
    field, step, recoveries = pf.run(device="cpu")
    return field.numpy().copy(), step, recoveries


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place (same-sign values)."""
    assert np.all(np.sign(a) == np.sign(b))
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


def test_constants_are_the_reference_examples(pf, reference):
    g, _ = reference
    for name in ("H", "W", "N_HOSTS", "DT", "EPS2", "MOBILITY", "STEPS", "CKPT_EVERY", "WINDOW_SHIFT_EVERY"):
        assert getattr(pf, name) == g[name], name


def test_step_field_within_one_ulp_and_shift_window_exact(pf, reference):
    """One step of the stencil and one window shift on the same float32
    field (the reference's initial field, and a seeded uniform one)."""
    g, _ = reference
    fields = [np.asarray(g["PhaseFieldEntity"]().phi),
              np.random.default_rng(0).uniform(0.0, 1.0, (g["H"], g["W"])).astype(np.float32)]
    for x in fields:
        got = pf.step_field(torch.from_numpy(x.copy())).numpy()
        want = np.asarray(g["step_field"](jnp.asarray(x)))
        assert _ulps(got, want) <= 1
        got = pf.shift_window(torch.from_numpy(x.copy())).numpy()
        want = np.asarray(g["shift_window"](jnp.asarray(x)))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_initial_field_within_3_ulp(pf, reference):
    g, _ = reference
    got = pf.PhaseFieldEntity(device="cpu").phi
    want = np.asarray(g["PhaseFieldEntity"]().phi)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert _ulps(got.numpy(), want) <= 3


def test_clean_run_within_tolerance_of_the_reference(pf, reference, clean):
    g, _ = reference
    field, step, recoveries = clean
    assert (step, recoveries) == (g["STEPS"], 0)
    np.testing.assert_allclose(field, g["ref"], rtol=0, atol=1e-6)
    # from the reference's initial bytes: the stencil alone differs
    sim = pf.PhaseFieldEntity.from_numpy(np.asarray(g["PhaseFieldEntity"]().phi), device="cpu")
    same_start, _, _ = pf.run(sim=sim)
    np.testing.assert_allclose(same_start.numpy(), g["ref"], rtol=0, atol=1e-6)


def test_faulty_run_bitwise_equal_to_clean_run(pf, reference, clean):
    """Hosts 3 and 6 killed at steps 120 and 260: two recoveries, the final
    field bit-equal to the port's clean run (as the reference's is to its
    own), the window at offset 24."""
    g, _ = reference
    offsets = []
    field, step, recoveries = pf.run(kill_at=KILLS, device="cpu",
                                     observe=lambda ev, sim, eng: offsets.append(sim.window_offset))
    assert (step, recoveries) == (300, 2)
    assert np.array_equal(field.numpy(), clean[0])
    assert offsets[-1] == 24
    assert np.array_equal(g["out"], g["ref"])
    _, ref_step, ref_recoveries = g["run"](kill_at=dict(KILLS))
    assert (ref_step, ref_recoveries) == (step, recoveries)


def test_a_burst_of_two_hosts_rebuilds_under_rs_and_is_lost_under_xor(pf, clean):
    """Hosts 1 and 2 lost at once: rs 4+2 rebuilds both blocks (the field at
    step 150 equals the clean run's there); xor over groups of 4 raises."""
    from repro_torch.core.distribution import DataLostError

    kept = {}

    def keep(ev, sim, eng):
        if ev == "step" and sim.step == 150 and 150 not in kept:
            kept[150] = sim.phi.clone()

    pf.run(device="cpu", steps=150, observe=keep)
    with gf256.compute_device("cpu"):
        field, step, recoveries = pf.run({120: (1, 2)}, cfg=EngineConfig(**CONFIGS["rs"]), steps=150, device="cpu")
        assert (step, recoveries) == (150, 1)
        assert torch.equal(field, kept[150])
        with pytest.raises(DataLostError):
            pf.run({50: (1, 2)}, cfg=EngineConfig(**CONFIGS["xor"]), steps=51, device="cpu")


@pytest.mark.parametrize("codec", sorted(CONFIGS))
def test_committed_stores_byte_equal_for_the_same_field(pf, reference, codec):
    """Both engines checkpoint the reference's final field (offset 24, step
    300): own arenas, exchanged copies or parity stripes, manifests and
    checksums are byte-equal."""
    g, _ = reference
    jsim = g["PhaseFieldEntity"]()
    jsim.phi, jsim.window_offset, jsim.step = jnp.asarray(g["ref"]), 24, 300
    jeng = JEngine(g["N_HOSTS"], JConfig(**CONFIGS[codec]))
    jeng.register("domain", jsim)
    assert jeng.checkpoint({"step": 300})
    want_arrays, want_meta = oracle.dump_engine(jeng, np.asarray)

    sim = pf.PhaseFieldEntity.from_numpy(g["ref"], offset=24, step=300, device="cpu")
    with gf256.compute_device("cpu"):
        eng = CheckpointEngine(pf.N_HOSTS, EngineConfig(**CONFIGS[codec]), device="cpu")
        eng.register("domain", sim)
        assert eng.checkpoint({"step": 300})
        got_arrays, got_meta = oracle.dump_engine(eng, lambda t: t.numpy())
        eng.close()
    assert json.loads(json.dumps(got_meta)) == json.loads(json.dumps(want_meta))
    assert sorted(got_arrays) == sorted(want_arrays)
    for k, v in want_arrays.items():
        assert got_arrays[k].dtype == v.dtype and got_arrays[k].tobytes() == v.tobytes(), k


def test_snapshot_hands_out_views_and_restore_writes_in_place(pf):
    sim = pf.PhaseFieldEntity(device="cpu")
    shards = sim.snapshot_shards(pf.N_HOSTS)
    rows = pf.H // pf.N_HOSTS
    base = sim.phi.untyped_storage().data_ptr()
    for r, s in enumerate(shards):
        assert s["rows"].untyped_storage().data_ptr() == base
        assert s["rows"].data_ptr() == sim.phi[r * rows].data_ptr()
        assert s["offset"].dtype == s["step"].dtype == torch.int64
    before = sim.phi.clone()
    live = sim.phi
    sim.window_offset, sim.step = 8, 100
    sim.restore_shards({r: {"rows": before[r * rows:(r + 1) * rows] + 1.0, "offset": torch.tensor(16),
                            "step": torch.tensor(120)} for r in range(pf.N_HOSTS)})
    assert sim.phi is live and torch.equal(sim.phi, before + 1.0)
    assert (sim.window_offset, sim.step) == (16, 120)


def test_interval_lines_are_the_reference_examples(pf):
    mu = ref_interval.system_mtbf(87_600 * 3600.0, 2**15)
    assert pf.interval_lines() == (ref_interval.optimal_interval(mu, 5.0), ref_interval.overhead(5.0, mu))


def test_entity_needs_cuda_unless_asked_for_the_cpu(pf):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pf.PhaseFieldEntity()


def test_twin_script_on_the_cpu_prints_the_reference_lines(reference):
    _, ref_lines = reference
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "phase_field_stencil_torch.py"), "--device", "cpu"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert proc.stdout.splitlines() == ref_lines
    assert ref_lines[-1] == "OK"


def test_chip_smoke_phase13_rehearses_on_the_cpu():
    """``chip_smoke.py``'s phase 13 at 256 x 256 on the CPU: the faulty
    field bit-equal to the clean one with 2 recoveries, the rs burst
    rebuilt bit-equal at step 150, the xor burst lost."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "rehearse_chip_smoke.py"), "--phase13"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    run = json.loads(proc.stdout.strip().splitlines()[-2])
    assert run["clean"]["recoveries"] == 0 and run["faulty"]["recoveries"] == 2
    assert run["clean"]["window_offset"] == 24 and run["faulty"]["step"] == 300
    assert [c["step"] for c in run["faulty"]["creates"]] == [50, 100, 150, 200, 250, 300]
    assert run["rs_burst"]["recoveries"] == 1 and run["rs_burst"]["step"] == 150
    assert run["xor_burst"]["error"].startswith("DataLostError")
    assert "FAIL" not in proc.stdout
