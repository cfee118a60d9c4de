#!/usr/bin/env python3
"""Compare the GF(2^8) kernels (B3 ``rs_encode``, B4 ``rs_decode``), or the
row gather (B6, ``--kernel gather_rows``), of this tree with those built
from another kernel source directory, on one GPU in one process.

Run from the repository root on a machine with the CUDA toolkit and a card:

    python3 tools/gf_ab.py --other <csrc dir> [--other <csrc dir> ...] [--decode-only] [--reps 20]
    python3 tools/gf_ab.py --kernel gather_rows --other <csrc dir> [--reps 20]

Each ``<csrc dir>`` is another version of ``src/repro_torch/kernels/csrc``
(for example the parent commit's, unpacked under a git-ignored directory
with ``git archive``). The script builds each version's GF(2^8) libraries
alone, from nothing, one version after the other, and prints each build's
time; then, for each other version in turn, it times at the full-width bucket's row length (463,430,400
words, as ``chip_smoke.py`` phase 3), B4 at the xor restore's shape
(4 -> 1, all ones) twice, on four random rows and on phase 3's restore
inputs (three members and their XOR parity, from another allocation), at
the rs restore's (4 -> 2), and B3 at the rs create's (4 -> 2, Cauchy
generator), in the order this, other, other, this, this,
other, each time the mean of ``--reps`` launches (CUDA events), and checks
that the two versions' outputs are bit-equal. ``--decode-only`` leaves B3
out, for other versions whose ``repro_rs_encode`` takes other arguments.

``--kernel gather_rows`` builds each version's ``reshard`` library instead
and times B6 at ``chip_smoke.py`` phase 3's stacked w_up shape (4 x 512
rows of 524,288 B, 1,024 gathered for new rank 0 of the 4 -> 2 plan), with
the plan's index and with a seeded permutation of its rows, in the same
order, bit-equality checked. A version exporting ``repro_copy_runs`` (the
run-table kernel) takes this tree's run table; one exporting
``repro_gather_rows`` (the index kernel it replaced) takes the index vector
on the card.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORDS = 463_430_400
CAUCHY = ((142, 244, 71, 167), (244, 142, 167, 71))
DECODE_RS = [[123, 224, 4, 5], [1, 123, 12, 10]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path, action="append", help="another kernel source directory")
    ap.add_argument("--decode-only", action="store_true", help="time B4 only")
    ap.add_argument("--kernel", choices=("gf", "gather_rows"), default="gf", help="the kernels to compare")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import _build, rs_encode as rse

    if not torch.cuda.is_available():
        print("gf_ab: no CUDA device", file=sys.stderr)
        return 1
    print(smoke.gpu_line(), flush=True)
    if args.kernel == "gather_rows":
        names = ("reshard",)
    else:
        names = ("rs_decode",) if args.decode_only else ("rs_encode", "rs_decode")
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR

    def build(tag: str, src: Path) -> dict[str, Path]:
        _build.CSRC, _build.BUILD_DIR = src.resolve(), ROOT / "build" / "gf_ab" / tag
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
        _build.build_seconds.clear()
        t0 = time.perf_counter()
        logs = _build.build(names)
        print(f"build {tag}: {time.perf_counter() - t0:.1f} s ("
              + ", ".join(f"{k} {v:.1f} s" for k, v in _build.build_seconds.items()) + ")", flush=True)
        for name, text in logs.items():
            smoke.ptxas_summary(name, text)
        paths = {n: _build.lib_path(n) for n in names}
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
        return paths

    others = {f"other{n}": src for n, src in enumerate(args.other, 1)}
    libs = {"this": build("this", csrc), **{tag: build(tag, src) for tag, src in others.items()}}
    if args.kernel == "gather_rows":
        return gather_ab(smoke, libs, others, args.reps)
    sigs = {name: _build._SIGNATURES[name] for name in ("rs_encode", "rs_decode")}

    def fn(tag: str, name: str):
        _, c_name, argtypes = sigs[name]
        f = getattr(ctypes.CDLL(str(libs[tag][name])), c_name)
        f.argtypes, f.restype = argtypes, ctypes.c_int
        return f

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = list(smoke.rand_words((4, WORDS), gen).unbind(0))
    outs = [torch.empty(WORDS, dtype=torch.int32, device="cuda").view(torch.uint32) for _ in range(2)]
    stream = torch.cuda.current_stream().cuda_stream
    pin = _build.ptr_array(rows)

    parity = torch.empty(WORDS, dtype=torch.int32, device="cuda").view(torch.uint32)
    torch.bitwise_xor(torch.bitwise_xor(*[r.view(torch.int32) for r in rows[:2]]),
                      torch.bitwise_xor(*[r.view(torch.int32) for r in rows[2:]]), out=parity.view(torch.int32))
    pin_restore = _build.ptr_array([rows[0], rows[2], rows[3], parity])

    def dec(tag: str, mat: torch.Tensor, inputs=pin):
        f, m = fn(tag, "rs_decode"), mat.shape[0]
        pout = _build.ptr_array(outs[:m])
        return lambda: f(inputs, 4, pout, m, mat.data_ptr(), WORDS, stream)

    def enc(tag: str, coefs):
        f, m = fn(tag, "rs_encode"), len(coefs)
        pout, terms = _build.ptr_array(outs[:m]), rse._kernel_args(coefs)
        return lambda: f(pin, 4, pout, m, terms, WORDS, stream)

    ones = torch.ones((1, 4), dtype=torch.int32, device="cuda").view(torch.uint32)
    rs = torch.tensor(DECODE_RS, dtype=torch.int32, device="cuda").view(torch.uint32)
    cases = {"B4 xor 4->1 (all ones)": (1, lambda t: dec(t, ones)),
             "B4 xor 4->1 (all ones, restore inputs)": (1, lambda t: dec(t, ones, pin_restore)),
             "B4 rs 4->2": (2, lambda t: dec(t, rs))}
    if not args.decode_only:
        cases["B3 rs 4->2 (Cauchy)"] = (2, lambda t: enc(t, CAUCHY))
    ok = True
    for (case, (m, make)), other in ((c, o) for c in cases.items() for o in others):
        run = {"this": make("this"), "other": make(other)}
        results = []
        for t, fill in (("other", 0), ("this", 7)):
            for o in outs:
                o.fill_(fill)
            if run[t]() != 0:
                print(f"{case}: the {t} kernel failed to launch", flush=True)
                return 1
            torch.cuda.synchronize()
            results.append([o.clone() for o in outs[:m]])
        equal = all(torch.equal(a, b) for a, b in zip(*results))
        del results
        ok &= equal
        ms: dict[str, list[float]] = {"this": [], "other": []}
        for t in ("this", "other", "other", "this", "this", "other"):
            ms[t].append(smoke.time_ms(run[t], reps=args.reps))
        print(f"{case}: this {ms['this']} ms, {other} ({others[other]}) {ms['other']} ms, bit-equal {equal}",
              flush=True)
    print(smoke.gpu_line(), flush=True)
    return 0 if ok else 1


def gather_ab(smoke, libs: dict, others: dict, reps: int) -> int:
    """B6 of this tree against each other version's, at phase 3's stacked
    w_up shape, with the plan's index and a permutation of its rows."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, reshard as rk

    gen = torch.Generator(device="cuda").manual_seed(0)
    sources, axis, row_bytes, plan = smoke.leaf_case(get_config(smoke.ARCH), gen)
    stacked, base = smoke.stack_rows(sources, axis)
    del sources
    plan_idx = smoke.segment_index(plan.segments[0], base)
    perm = plan_idx[torch.randperm(plan_idx.numel(), generator=torch.Generator().manual_seed(0))]
    outs = {t: torch.empty((plan_idx.numel(), stacked.shape[1]), dtype=stacked.dtype, device="cuda")
            for t in ("this", "other")}
    stream = torch.cuda.current_stream().cuda_stream

    def gather(tag: str, lib_tag: str, idx: torch.Tensor):
        """A zero-argument launch of ``libs[lib_tag]``'s gather into
        ``outs[tag]``, and what it holds alive."""
        lib, out = ctypes.CDLL(str(libs[lib_tag]["reshard"])), outs[tag]
        if hasattr(lib, "repro_copy_runs"):
            f = lib.repro_copy_runs
            f.argtypes, f.restype = _build._SIGNATURES["copy_runs"][2], ctypes.c_int
            *table, keep = rk.kernel_table([stacked], out, rk.index_runs(idx, row_bytes))
            return (lambda: f(*table, stream)), keep
        f = lib.repro_gather_rows
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        f.argtypes, f.restype = [p, p, p, i64, i64, ctypes.c_int, p], ctypes.c_int
        on_card = idx.to("cuda")
        unit = rk.unit_bytes(row_bytes, stacked.data_ptr(), out.data_ptr())
        return (lambda: f(stacked.data_ptr(), on_card.data_ptr(), out.data_ptr(), on_card.numel(), row_bytes, unit,
                          stream)), on_card

    ok = True
    for (case, idx), other in ((c, o) for c in (("plan's index", plan_idx), ("permutation", perm)) for o in others):
        (this_fn, keep_this), (other_fn, keep_other) = gather("this", "this", idx), gather("other", other, idx)
        run = {"this": this_fn, "other": other_fn}
        for t, fill in (("other", 0), ("this", 7)):
            outs[t].view(torch.int32).fill_(fill)
            if run[t]() != 0:
                print(f"B6 {case}: the {t} kernel failed to launch", flush=True)
                return 1
        torch.cuda.synchronize()
        equal = torch.equal(outs["this"].view(torch.int32), outs["other"].view(torch.int32))
        ok &= equal
        ms: dict[str, list[float]] = {"this": [], "other": []}
        for t in ("this", "other", "other", "this", "this", "other"):
            ms[t].append(smoke.time_ms(run[t], reps=reps))
        print(f"B6 {case} ({rk.index_runs(idx, row_bytes).shape[0]} runs): this {ms['this']} ms, {other} "
              f"({others[other]}) {ms['other']} ms, bit-equal {equal}", flush=True)
        del keep_this, keep_other
    print(smoke.gpu_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
