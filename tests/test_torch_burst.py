"""The two-failure burst on the port (``examples/multi_failure_burst_torch.py``)
against the reference example (``examples/multi_failure_burst.py``) on the
CPU.

The reference example runs in-process through ``runpy.run_path`` (its
globals give its ``doomed`` ranks and its fault-free and faulty
``Trainer``s; its printed lines are kept); the port's twin's pieces run
in-process too. Held equal, exactly:

* engine level, 8 ranks, ranks 1 and 2 of group 0 wiped: xor (groups of 4)
  raises ``DataLostError`` in both packages with the same message; rs 4+2
  rebuilds both shards bit for bit, to the reference's bytes; the two
  engines' ``memory_report``s are equal;
* end to end: the burst's doomed ranks, the recovery count and the restore
  breakdown (``zero_comm_restores``, ``reconstructed_restores``) are the
  reference's, and the port's faulty trainer ends bit-equal to its
  fault-free run;
* the twin as a script (``--device cpu``) prints the reference's lines.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core.checkpoint import CheckpointEngine as JEngine
from repro.core.checkpoint import EngineConfig as JConfig
from repro.core.distribution import DataLostError as JDataLostError
from repro.runtime.failures import FailureInjector as JInjector
from repro_torch.core import gf256
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.core.distribution import DataLostError
from repro_torch.runtime.failures import FailureInjector

ROOT = Path(__file__).resolve().parents[1]
CODECS = {"xor": dict(parity_group=4), "rs": dict(codec="rs", parity_group=4, rs_parity=2)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(lines: str) -> list[str]:
    return [ln for ln in lines.splitlines() if " INFO " not in ln and " WARNING " not in ln]


@pytest.fixture(scope="module")
def reference():
    """The reference example's globals and printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(str(ROOT / "examples" / "multi_failure_burst.py"))
    return g, _quiet(buf.getvalue())


@pytest.fixture(scope="module")
def burst():
    spec = importlib.util.spec_from_file_location("multi_failure_burst_torch",
                                                  ROOT / "examples" / "multi_failure_burst_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trained(burst):
    with contextlib.redirect_stdout(io.StringIO()):
        return burst.train_through_burst("cpu")


def _ref_burst(g, cfg: dict):
    """The reference example's engine-level burst, returning what it prints:
    (memory report, the error or the rebuilt vectors, shards rebuilt)."""
    eng = JEngine(8, JConfig(**cfg))
    vec = g["ShardedVec"](8)
    eng.register("state", vec)
    assert eng.checkpoint({"step": 7})
    rep = eng.memory_report()
    for d in vec.data:
        d *= 0.0
    eng.stores[1].wipe()
    eng.stores[2].wipe()
    try:
        eng.restore()
    except JDataLostError as e:
        return rep, e, None
    return rep, [d.copy() for d in vec.data], eng.stats.reconstructed_restores


def _port_burst(burst, cfg: dict):
    with gf256.compute_device("cpu"), contextlib.redirect_stdout(io.StringIO()):
        return burst.burst("test", EngineConfig(**cfg), device="cpu")


def test_xor_raises_data_lost_in_both_packages(burst, reference):
    g, _ = reference
    out = _port_burst(burst, CODECS["xor"])
    _, err, _ = _ref_burst(g, CODECS["xor"])
    assert isinstance(out["lost"], DataLostError) and isinstance(err, JDataLostError)
    assert str(out["lost"]) == str(err)


def test_rs_rebuilds_both_shards_bit_equal(burst, reference):
    g, _ = reference
    out = _port_burst(burst, CODECS["rs"])
    _, rebuilt, n = _ref_burst(g, CODECS["rs"])
    assert out["lost"] is None and out["ok"] and out["rebuilt"] == n == 2
    # the port's engine restores the same bytes as the reference's
    eng = CheckpointEngine(8, EngineConfig(**CODECS["rs"]), device="cpu")
    vec = burst.ShardedVec(8)
    eng.register("state", vec)
    with gf256.compute_device("cpu"):
        assert eng.checkpoint({"step": 7})
        for d in vec.data:
            d *= 0.0
        eng.stores[1].wipe()
        eng.stores[2].wipe()
        eng.restore()
    eng.close()
    assert [d.numpy().tobytes() for d in vec.data] == [d.tobytes() for d in rebuilt]


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_memory_reports_equal(burst, reference, codec):
    g, _ = reference
    out = _port_burst(burst, CODECS[codec])
    rep, _, _ = _ref_burst(g, CODECS[codec])
    assert out["report"] == rep
    assert out["report"]["tolerance"] == (1 if codec == "xor" else 2)


def test_doomed_ranks_equal(burst, reference, trained):
    g, _ = reference
    kw = dict(burst.BURST)
    doomed = FailureInjector(8).schedule_group_burst(**kw)
    assert doomed == JInjector(8).schedule_group_burst(**kw) == g["doomed"] == trained[2]


def test_trainer_recovers_as_the_reference_and_ends_bit_equal(burst, reference, trained):
    g, _ = reference
    ref, faulty, _ = trained
    s, rs = faulty.engine.stats, g["faulty"].engine.stats
    assert faulty.n_recoveries == g["faulty"].n_recoveries >= 1
    assert (s.zero_comm_restores, s.reconstructed_restores) == (rs.zero_comm_restores, rs.reconstructed_restores)
    assert s.reconstructed_restores == 2 and faulty.engine.codec.name == "rs"
    assert burst.same_state(ref.state, faulty.state)
    assert [h["step"] for h in faulty.history] == [h["step"] for h in g["faulty"].history]


def test_twin_script_on_the_cpu_prints_the_reference_lines(reference):
    _, ref_lines = reference
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "multi_failure_burst_torch.py"), "--device", "cpu"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert _quiet(proc.stdout) == ref_lines
    assert ref_lines[-1] == "OK"


def test_bursts_need_cuda_unless_asked_for_the_cpu(burst):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        burst.burst("xor", EngineConfig(**CODECS["xor"]))
