"""Bitwise replay across processes on the CPU's default thread pool.

Two processes of the same train CLI used to end on different states now and
then, never on one thread.
The op at fault was the float32 ``sqrt`` of the normal draw's erfinv
(``utils/threefry.py``): on the CPU it is MKL's vector sqrt, within 1 ulp
but not correctly rounded, and on a loaded thread pool it gave a different
result for the same input from one call to the next. The draw and AdamW's
update (``optim/adamw.py``) now take the root in float64 and round once:
the correctly rounded float32, whatever the thread count.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.optim.adamw import _sqrt
from repro_torch.utils import threefry

ROOT = Path(__file__).resolve().parents[1]


def _on_threads(n: int, fn):
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(n)
        return fn()
    finally:
        torch.set_num_threads(before)


def test_sqrt_is_correctly_rounded_on_any_thread_count():
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 64, 1 << 20).astype(np.float32))
    want = torch.from_numpy(np.sqrt(x.numpy().astype(np.float64)).astype(np.float32))
    for n in (1, 8):
        assert torch.equal(_on_threads(n, lambda: _sqrt(x)), want), n


def test_normal_draw_is_the_same_on_one_and_eight_threads():
    key = threefry.PRNGKey(3)
    one = _on_threads(1, lambda: threefry.normal(key, (1 << 18,)))
    eight = _on_threads(8, lambda: threefry.normal(key, (1 << 18,)))
    assert torch.equal(one.view(torch.int32), eight.view(torch.int32))


def test_train_cli_replays_across_processes_on_the_default_pool(tmp_path):
    """The reduced llama through a kill, twice in child processes with no
    thread setting: the same losses and SHA-256 of the final state."""
    env = {k: v for k, v in os.environ.items() if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    env["PYTHONPATH"] = str(ROOT / "src")
    args = ["-m", "repro_torch.launch.train", "--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
            "--steps", "8", "--period", "4", "--kill-at", "6:2"]
    for i in range(2):
        proc = subprocess.run([sys.executable, *args, "--out", str(tmp_path / f"{i}.json")], env=env, cwd=ROOT,
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
    a, b = (json.loads((tmp_path / f"{i}.json").read_text()) for i in range(2))
    assert a["n_recoveries"] == b["n_recoveries"] == 1
    assert [h["loss"] for h in a["history"]] == [h["loss"] for h in b["history"]]
    assert a["state_sha256"] == b["state_sha256"]
