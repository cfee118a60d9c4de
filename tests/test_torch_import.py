"""The port stands alone: importing every ``repro_torch`` module and the
module-level code of ``chip_smoke.py`` loads neither ``jax`` nor the JAX
package ``repro``, and no source of the port imports either. The host
engine's path on the card needs no ``ml_dtypes`` either (the GPU machine
has none)."""

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
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
print(json.dumps({"modules": names, "loaded": loaded}))
"""


def _port_sources() -> list[Path]:
    return sorted(PORT.rglob("*.py"))


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
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


@pytest.mark.parametrize("path", _port_sources() + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
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
