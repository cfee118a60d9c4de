"""Bitwise replay of the train CLI on the CPU's default thread pool, and the
CPU ops whose result could depend on how the pool splits the work.

    python3 tools/replay_check.py cli --arch llama3.2-1b,mixtral-8x7b [--runs 12] [--at-a-time 4]
    python3 tools/replay_check.py ops [--calls 1500]

``cli`` runs the train CLI (reduced config, 12 steps, a checkpoint every 4,
a kill at step 6) ``--runs`` times per arch, ``--at-a-time`` processes at
once, with no thread setting in their environment, and prints one JSON line
per arch: the runs, the failures and how many runs ended on each SHA-256 of
the final state (one entry: every run replayed bit for bit).

``ops`` prints, for each elementwise op of the models' CPU path, one JSON
line: ``repeat``, the calls on the same input (4K to 1M elements, the
default pool) whose result differed from the first call's; ``split``, the
elements that differed from the one-thread result when the same input was
run on 2, 3 and 8 threads or from another offset (another split of the work
between the vector body and the scalar tail).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CLI = ("--reduced", "--device", "cpu", "--steps", "12", "--period", "4", "--kill-at", "6:2")


def cli(archs: list[str], runs: int, at_a_time: int) -> None:
    env = {k: v for k, v in os.environ.items() if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    env["PYTHONPATH"] = str(ROOT / "src")
    for arch in archs:
        shas, fails = collections.Counter(), 0
        with tempfile.TemporaryDirectory() as tmp:
            for start in range(0, runs, at_a_time):
                procs = []
                for i in range(start, min(runs, start + at_a_time)):
                    out = Path(tmp, f"{i}.json")
                    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, *CLI, "--out", str(out)]
                    procs.append((out, subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
                                                        stderr=subprocess.PIPE, text=True)))
                for out, p in procs:
                    _, err = p.communicate()
                    if p.returncode:
                        fails += 1
                        print(err[-1000:], file=sys.stderr)
                    else:
                        shas[json.loads(out.read_text())["state_sha256"]] += 1
        print(json.dumps({"arch": arch, "runs": runs, "at_a_time": at_a_time, "fails": fails,
                          "runs_per_sha256": sorted(shas.values())}), flush=True)


def ops(calls: int) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    fns = {"exp": torch.exp, "log": lambda x: torch.log(x.abs() + 1e-3), "tanh": torch.tanh,
           "rsqrt": lambda x: torch.rsqrt(x.abs() + 1e-3), "sqrt": lambda x: torch.sqrt(x.abs()),
           "log1p": lambda x: torch.log1p(x.abs()), "sigmoid": torch.sigmoid, "silu": F.silu,
           "softplus": F.softplus, "gelu": F.gelu, "softmax": lambda x: torch.softmax(x.view(-1, 64), -1)}
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.uniform(-8, 8, n).astype(np.float32)) for n in (4096, 32768, 98304, 1 << 20)]
    big = torch.from_numpy(rng.uniform(-8, 8, 1 << 21).astype(np.float32))
    threads = torch.get_num_threads()

    def bits(t):
        return t.reshape(-1).view(torch.int32)

    try:
        for name, f in fns.items():
            repeat = n_calls = 0
            for x in xs:
                first = bits(f(x)).clone()
                for _ in range(calls if x.numel() <= 32768 else max(1, calls // (x.numel() // 32768))):
                    n_calls += 1
                    repeat += int(not torch.equal(bits(f(x)), first))
            torch.set_num_threads(1)
            one = bits(f(big)).clone()
            split = 0
            for n in (2, 3, 8):
                torch.set_num_threads(n)
                split += int((bits(f(big)) != one).sum())
            for k in (64, 128, 192, 256) if name == "softmax" else (64, 67, 71, 77):  # the softmax: whole rows
                split += int((bits(f(big[k:].clone())) != one[k:]).sum())
            torch.set_num_threads(threads)
            print(json.dumps({"op": name, "repeat": repeat, "calls": n_calls, "split": split}), flush=True)
    finally:
        torch.set_num_threads(threads)


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="what", required=True)
    c = sub.add_parser("cli")
    c.add_argument("--arch", required=True, help="comma-separated archs")
    c.add_argument("--runs", type=int, default=12)
    c.add_argument("--at-a-time", type=int, default=4)
    o = sub.add_parser("ops")
    o.add_argument("--calls", type=int, default=1500)
    args = ap.parse_args()
    if args.what == "cli":
        cli(args.arch.split(","), args.runs, args.at_a_time)
    else:
        ops(args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
