"""The port stands alone: importing every ``repro_torch`` module, the
module-level code of ``chip_smoke.py`` and the example twins
(``examples/*_torch.py``, which ``chip_smoke.py`` loads) loads neither
``jax`` nor the JAX package ``repro``, and no source of the port, of
``chip_smoke.py`` or of an example twin imports either. The host
engine's path on the card needs no ``ml_dtypes`` either (the GPU machine
has none), and a process of a process mesh loads neither after running the
device tier's programs."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("import jax", "from jax", "from repro.", "import repro.", "from repro import")

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(path.rsplit("/", 1)[-1].removesuffix(".py"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
print(json.dumps({"modules": names, "loaded": loaded}))
"""


def _port_sources() -> list[Path]:
    return sorted(PORT.rglob("*.py"))


def _example_twins() -> list[Path]:
    return sorted((ROOT / "examples").glob("*_torch.py"))


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py"), *map(str, _example_twins())],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    want = {
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in _port_sources()
    }
    assert set(out["modules"]) == want  # every module was imported


@pytest.mark.parametrize("path", _port_sources() + [ROOT / "chip_smoke.py"] + _example_twins(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    text = path.read_text()
    assert not [f for f in FORBIDDEN if f in text]


_ENGINE_PROBE = r"""
import json, sys
import repro_torch.core.checkpoint, repro_torch.runtime.state, repro_torch.optim.grad_compress
print(json.dumps([m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]))
"""


def test_engine_path_loads_no_jax_repro_or_ml_dtypes():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _ENGINE_PROBE], capture_output=True, text=True,
                          env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_spawned_ranks_load_no_jax_and_no_repro():
    """A process of a process mesh (started by ``launch.mesh.spawn``, as the
    device tier's tests and ``chip_smoke.py`` start them) holds neither
    ``jax`` nor ``repro`` after it has built and run a snapshot program and
    a striped restore over gloo."""
    import _torch_dist_ranks as ranks
    from repro_torch.launch.mesh import spawn

    assert spawn(ranks.import_guard_rank, 2, timeout=120) == [[], []]
