#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build the kernels, hold
each against its plain PyTorch version, then create and restore a full-width
llama3.2-1b train state through the device tier and through the host-tier
checkpoint engine.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``); it exits non-zero,
printing no result, on any failure or without a card. Phases:

1. build: one ``nvcc`` per kernel source, all at once (the two GF(2^8)
   sources in parts, see ``kernels/_build.py``), timed; the card's
   name and power limit and the host's free memory; the GF(2^8) kernels'
   issued instructions per word by pipe, read from their SASS
   (``tools/sass_mix.py``);
2. kernel tests: ``pytest -m cuda tests/test_torch_cuda.py`` in a child
   process: B1-B6 against their plain versions at ragged small sizes
   (quantize: f32/bf16/f16, unaligned inputs, all-zero blocks, values on the
   round-half-even boundaries; gather: f32/bf16/int8/int32 rows of 1 byte to
   512 KiB, unaligned rows, repeated and reversed indices, 0 and 1 output
   rows), the device tier on the card against the CPU path (f32/bf16/int8
   leaves, padded shards, ragged groups, every tolerated failure
   combination, compress=True), and the host engine and its
   ``restore_elastic`` with the state on the card against the same engine on
   the CPU;
3. kernels at the main path's shapes (the encode outputs are stripe-slot
   views of a payload tensor, the decode runs at both runs' shapes, the
   quantize pair at the device-tier bucket's): each bit-equal to its plain
   version, with its time, its plain version's, a PyTorch call's where one
   computes the same function, and its bound (the largest of the bytes over
   HBM, the integer work on the ALU and FMA pipes and through dispatch, and
   f32 work), each resource's time printed;
4. device-tier path: the llama3.2-1b train state (~17.3 GB, seeded) on a
   virtual (8, 1) ("data", "model") mesh, with rs g=4 m=2 and with xor g=4:
   snapshot with the device checksum (held against ``np_checksum`` of the
   staged host bytes), staged fetch to pinned host memory (twice: first
   with fresh pinned buffers, then reusing them), ranks killed, parity
   uploaded, striped restore, every leaf compared; then the copy codec with
   compress=True: int8 partner codes and scales bit-equal to the plain
   quantize of the same bucket, the staged fetch, and the fetched partner
   dequantized on the card within half a step of the original;
5. engine path: the same state held by a ShardedStateEntity over 4 ranks
   (the ZeRO-1 data dim split four ways) plus an RngEntity, through
   ``CheckpointEngine(4, EngineConfig(compress=True, restore_mode="sync"))``:
   checkpoint, overwrite the live state, wipe rank 2's host store, restore;
   survivors byte-exact, rank 2's split float leaves bit-equal to the plain
   dequantize(quantize(x)); then the same cycle uncompressed, byte-exact.
   If the host lacks the RAM this path needs, depth (layers) is cut, never
   width, and the cut is printed;
6. elastic path: the same state and entities through
   ``CheckpointEngine(4, EngineConfig(restore_mode="sync"))`` attached to a
   ``VirtualCluster(4)``: checkpoint, overwrite the live state, kill rank 2,
   ``stabilize("elastic")``, ``restore_elastic(2)``, ``resize(2)``; re-protect
   with a checkpoint on 2 ranks, overwrite again, ``restore_elastic(8)``,
   ``resize(8)``. After each restore every leaf is byte-equal to the seeded
   original, and every leaf with a data axis of every new rank was built by
   the row gather (B6): 33 x 2 and 33 x 8 launches. 4 -> 3 would hold every
   split leaf whole on each of 3 new ranks (44.5 GB beside the live state
   and the recovered payloads: more than the card has), so the drill goes
   4 -> 2 -> 8, world sizes that divide every ZeRO-1 dim. Depth is cut, never
   width, if the host lacks the RAM, and the cut is printed.

Phase 3 also runs B6 at the main path's largest gather (the w_up master
leaf, 4 origins x 512 rows of 512 KiB, gathered for one new rank of the
4 -> 2 plan), with the copies around it (the axis move and the stacking)
timed on their own, and the host executor's result for that leaf held
against the gather's.

Phase 5 runs before phases 6 and 4: it needs the most host RAM, and phase
4's staged fetches leave pinned host blocks in PyTorch's cache. The kernels'
launch counts are set to 0 before each of the three paths and read after it;
every kernel a path runs must have launched in it.

The line before the last is the kernels' JSON; the last line is the result.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
ARCH = "llama3.2-1b"
# the largest leaf the elastic reshard gathers (phase 3's B6 shape)
W_UP_MASTER = ("opt", "master", "layers", "slot0", "ffn", "w_up")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores, NVIDIA data sheet
# Integer work per pipe (CUDA C++ Programming Guide, "Arithmetic
# Instructions" throughput table, compute capability 9.0: 64 results per
# clock per SM for 32-bit integer add, logical and shift operations (the ALU
# pipe) and 64 for 32-bit integer multiply and multiply-add (IMAD, on the FMA
# pipe)); dispatch is one warp instruction per clock in each of the SM's 4
# sub-partitions, 128 lanes per clock per SM. x 132 SMs x 1.98 GHz boost
# clock. The data sheet lists no integer rate.
ALU_OPS_PER_S = 64 * 132 * 1.98e9
FMA_OPS_PER_S = 64 * 132 * 1.98e9
DISPATCH_PER_S = 128 * 132 * 1.98e9
MAIN_RUNS = (("rs", 4, 2, (0, 2)), ("xor", 4, 1, (5,)))
DEVICE_TIER_KERNELS = ("checksum", "xor_reduce", "gf256_matmul", "gf256_matmul_dyn", "quantize_blockwise",
                       "dequantize_blockwise")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def host_free_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def host_rss_gib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


_HOST_START: list[float] = []  # (MemAvailable, this process's RSS) at start, GiB


def host_free_settled_gib(max_wait_s: float = 30.0) -> float:
    """MemAvailable once it accounts for the memory this process has freed.
    On the GPU machine freed pages reach MemAvailable only seconds after the
    process's resident set drops (``tools/memavailable_lag.py`` measures
    it), so a reading right after a path under-reports what the next one
    can use. Waits, at most ``max_wait_s``, until MemAvailable is within 2
    GiB of the start reading less this process's growth since."""
    want = _HOST_START[0] - max(host_rss_gib() - _HOST_START[1], 0.0) - 2.0
    t0 = time.perf_counter()
    while (free := host_free_gib()) < want and time.perf_counter() - t0 < max_wait_s:
        time.sleep(1.0)
    return free


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gf_ops(coefs, n_words: int) -> tuple[float, float]:
    """(ALU-pipe, FMA-pipe) instructions the GF(2^8) product needs for these
    coefficients: per input column, one xtime step per bit below its highest
    set bit (2 on the ALU pipe: the top-bit mask and the masked XOR, both
    LOP3; 2 on the FMA pipe: the reduction multiply-high by 0x1D << 25,
    IMAD.HI, and the doubling, IMAD.SHL), plus half a LOP3 per set
    coefficient bit (a three-input XOR folds two terms into an
    accumulator). This counts what the function needs for these
    coefficients, not what the compiled kernel issues (``tools/sass_mix.py``
    reads that)."""
    alu = fma = 0.0
    for i in range(len(coefs[0])):
        col = [int(row[i]) for row in coefs]
        steps = max(max(col).bit_length() - 1, 0)
        alu += 2 * steps + 0.5 * sum(bin(c).count("1") for c in col)
        fma += 2 * steps
    return alu * n_words, fma * n_words


def bound_times(nbytes: int, alu: float = 0.0, fma: float = 0.0, flops: float = 0.0) -> dict[str, float]:
    """The least time in ms the card needs for each resource: the bytes over
    HBM, the integer work on the ALU and FMA pipes and through dispatch,
    f32 work outside the tensor cores."""
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "alu": alu / ALU_OPS_PER_S * 1e3,
            "fma": fma / FMA_OPS_PER_S * 1e3, "dispatch": (alu + fma) / DISPATCH_PER_S * 1e3,
            "f32": flops / F32_FLOPS * 1e3}


def bound(nbytes: int, alu: float = 0.0, fma: float = 0.0, flops: float = 0.0) -> tuple[float, str]:
    t = bound_times(nbytes, alu, fma, flops)
    return max(t.values()), ("bytes" if t["bytes"] >= max(t.values()) else "operations")


def max_abs_err(pairs) -> int:
    """Largest |a - b| over the uint32 words of each (kernel, plain) pair of
    equal-size tensors; 0 when every pair is bit-equal."""
    import torch

    err, chunk = 0, 1 << 28
    for a, b in pairs:
        a, b = a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32)
        check(a.numel() == b.numel(), f"compared tensors differ in size: {a.numel()} != {b.numel()}")
        for s in range(0, a.numel(), chunk):
            d = (a[s : s + chunk].to(torch.int64) & 0xFFFFFFFF) - (b[s : s + chunk].to(torch.int64) & 0xFFFFFFFF)
            err = max(err, int(d.abs().max()))
    return err


def max_value_err(a, b) -> float:
    """Largest |a - b| over two equal-size tensors compared as numbers (int8
    codes as integers, floats in float64); 0 only where they are equal bit
    for bit (bits that differ between equal numbers, signed zeros, count as
    infinite)."""
    import torch

    check(a.numel() == b.numel(), f"compared tensors differ in size: {a.numel()} != {b.numel()}")
    a, b = a.reshape(-1), b.reshape(-1)
    err, chunk = 0.0, 1 << 27
    for s in range(0, a.numel(), chunk):
        x, y = a[s : s + chunk], b[s : s + chunk]
        if torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            continue
        d = float((x.to(torch.float64) - y.to(torch.float64)).abs().max())
        err = max(err, d if d > 0 else float("inf"))
    return err


def ptxas_summary(name: str, text: str) -> None:
    """One line per library from its ``-Xptxas -v`` report: the kernels
    compiled, the most registers any uses, and every spill (the GF(2^8)
    libraries hold 128 instantiations each)."""
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
    spills = [ln.strip() for ln in text.splitlines()
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    log(f"  ptxas {name}: {len(regs)} kernels, registers {min(regs, default=0)}-{max(regs, default=0)}, "
        f"{len(spills)} with spills" + "".join(f"\n    {ln}" for ln in spills[:8]))


def sass_phase() -> None:
    """The GF(2^8) kernels' issued instructions per uint32 word of each row,
    read from their SASS (``tools/sass_mix.py``): the grid-stride loop of the
    (K=4, M=2) instantiation (the rs encode and decode) and of (K=4, M=1)
    (the xor decode)."""
    import os

    sys.path.insert(0, str(ROOT / "tools"))
    import sass_mix
    from repro_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    for name in ("rs_encode", "rs_decode"):
        sass = subprocess.run([cuobjdump, "-sass", str(_build.lib_path(name))], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        for k, m in ((4, 2), (4, 1)):
            c = sass_mix.gf_word_mix(sass, k, m)
            log(f"sass {name} (K={k}, M={m}) loop, per word: " + ", ".join(f"{p} {v:.2f}" for p, v in c.items()))


# ---------------------------------------------------------------------------
# phase 2: the kernels on the card at small and ragged sizes (pytest -m cuda)
# ---------------------------------------------------------------------------

def kernel_tests_phase() -> None:
    """tests/test_torch_cuda.py: B1-B6 against their plain versions at
    ragged lengths, unaligned rows, all-ones words, every coefficient, zero
    blocks, half steps and every row width of the reshard; the device tier
    on the card against the CPU path for every codec and failure
    combination and for compress=True; the host engine and its elastic
    restore on the card against the CPU. Its launches happen in its own
    process."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-m", "cuda",
         str(ROOT / "tests" / "test_torch_cuda.py")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600,
    )
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines and " passed" in lines[-1] and "skipped" not in lines[-1],
          "tests/test_torch_cuda.py:\n" + proc.stdout[-4000:] + proc.stderr[-2000:])
    log(f"kernel tests on the card: {lines[-1]}")


# ---------------------------------------------------------------------------
# phase 3: each kernel at the main path's shapes
# ---------------------------------------------------------------------------

def rand_words(shape, gen):
    import torch

    x = torch.randint(-(2**31), 2**31, shape, generator=gen, device="cuda", dtype=torch.int64)
    return x.to(torch.int32).view(torch.uint32)


def kernel_phase_main(words: int, gen) -> list[dict]:
    """Each kernel at the main path's shapes: bit-equal to its plain version,
    timed, bounded."""
    import torch

    from repro_torch.core import gf256
    from repro_torch.core.device_tier import striped_decode_rows
    from repro_torch.kernels import checksum as ck, quantize as qk, ref, rs_decode as rd, rs_encode as rse
    from repro_torch.kernels import xor_parity as xp

    results = []

    def record(name, source, replaces, err, ms, plain, nbytes, alu=0.0, fma=0.0, flops=0.0, lib=None):
        check(err == 0, f"{name}: kernel differs from its plain version (max |err| {err})")
        b_ms, b_by = bound(nbytes, alu, fma, flops)
        results.append(dict(name=name, source=source, replaces=replaces, max_abs_err=err, ms=ms,
                            plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                            bounds=bound_times(nbytes, alu, fma, flops)))

    def empty():
        return torch.empty(words, dtype=torch.int32, device="cuda").view(torch.uint32)

    # B1: the (8, words) fused f32 bucket; the plain version row by row
    # (its int64 temporaries of all eight rows would not fit beside it)
    buf = rand_words((8, words), gen)

    def plain_checksum():
        return torch.cat([ref.checksum_rows(buf[r : r + 1]).view(torch.int32) for r in range(8)])

    err = max_abs_err([(ck.checksum_rows(buf), plain_checksum())])
    record("checksum", "src/repro_torch/kernels/csrc/checksum.cu", "src/repro/kernels/checksum.py:42", err,
           time_ms(lambda: ck.checksum_rows(buf)), time_ms(plain_checksum, reps=1),
           buf.numel() * 4 + 8 * 8, alu=2 * buf.numel(), fma=buf.numel())
    del buf
    torch.cuda.empty_cache()

    # a parity group of g=4 members, one (words,) coordinate row each
    x = rand_words((4, words), gen)
    rows = list(x.unbind(0))
    # the parity payload's stripe slots, (m, n_coords, sw), as `_parity`
    # builds them for full groups: blob b is the contiguous run of its holder
    # group's slots (here group 1's, coordinates 4..7), written in place
    check(words % 4 == 0, "bucket words divide the group")
    slots = torch.empty((2, 8, words // 4), dtype=torch.int32, device="cuda").view(torch.uint32)
    blobs = [slots[b, 4:8].view(-1) for b in range(2)]

    # B2: xor g=4
    xp.xor_reduce_into(rows, blobs[0])
    err = max_abs_err([(blobs[0], ref.xor_reduce(x))])
    xi = x.view(torch.int32)
    record("xor_reduce", "src/repro_torch/kernels/csrc/xor_parity.cu", "src/repro/kernels/xor_parity.py:42", err,
           time_ms(lambda: xp.xor_reduce_into(rows, blobs[0])), time_ms(lambda: ref.xor_reduce(x), reps=2),
           5 * words * 4, alu=2 * words,
           lib=time_ms(lambda: torch.bitwise_xor(torch.bitwise_xor(xi[0], xi[1]), torch.bitwise_xor(xi[2], xi[3]))))

    # B3: rs g=4 m=2 (the Cauchy generator)
    gen_c = gf256.cauchy_matrix(2, 4).tolist()
    rse.rs_encode_into(rows, gen_c, blobs)
    err = max_abs_err(zip(blobs, ref.gf256_matmul(x, gen_c)))
    record("gf256_matmul", "src/repro_torch/kernels/csrc/rs_encode.cu", "src/repro/kernels/rs_encode.py:83", err,
           time_ms(lambda: rse.rs_encode_into(rows, gen_c, blobs)), time_ms(lambda: ref.gf256_matmul(x, gen_c), reps=1),
           6 * words * 4, *gf_ops(gen_c, words))

    def decode_case(codec: str, m: int, killed: list[int], cols: list[int], inputs: list, lost: list):
        """B4 at one run's decode shape: the killed members of group 0/1
        rebuilt from ``inputs`` (survivors, then blobs) with the restore's
        decode rows; bit-equal to the lost rows and to the plain version."""
        dec, _ = striped_decode_rows(8, 4, codec, m, set(killed))
        coef = dec[killed][:, cols]
        cdev = torch.from_numpy(coef.astype("int32")).cuda().view(torch.uint32)
        outs = [empty() for _ in killed]
        rd.rs_decode_into(inputs, cdev, outs)
        check(max_abs_err(zip(outs, lost)) == 0, f"rs_decode {codec}: lost rows not rebuilt")
        stacked = torch.stack([t.view(torch.int32) for t in inputs]).view(torch.uint32)
        err = max_abs_err(zip(outs, ref.gf256_matmul_dyn(stacked, cdev)))
        ms = time_ms(lambda: rd.rs_decode_into(inputs, cdev, outs))
        plain = time_ms(lambda: ref.gf256_matmul_dyn(stacked, cdev), reps=1)
        nbytes, ops = (len(inputs) + len(outs)) * words * 4, gf_ops(coef.tolist(), words)
        b_ms, b_by = bound(nbytes, *ops)
        log(f"rs_decode at the {codec} run's shape ({len(inputs)} -> {len(outs)}, coefficients "
            f"{coef.tolist()}): {ms:.3f} ms, bound {b_ms:.3f} ms by {b_by}, {100 * b_ms / ms:.1f}% of the bound "
            f"(plain {plain:.3f} ms), max |err| {err}")
        return err, ms, plain, nbytes, ops

    # B4, rs run: ranks {0, 2} from survivors 1, 3 and blobs 0, 1
    rs_case = decode_case("rs", 2, [0, 2], [1, 3, 4, 5], [rows[1], rows[3], blobs[0], blobs[1]], [rows[0], rows[2]])
    # B4, xor run: rank 5 (member 1 of group 1) from members 0, 2, 3 and the XOR blob
    xp.xor_reduce_into(rows, blobs[0])
    xor_err = decode_case("xor", 1, [5], [0, 2, 3, 4], [rows[0], rows[2], rows[3], blobs[0]], [rows[1]])[0]
    err, ms, plain, nbytes, ops = rs_case
    record("gf256_matmul_dyn", "src/repro_torch/kernels/csrc/rs_decode.cu", "src/repro/kernels/rs_decode.py:77",
           max(err, xor_err), ms, plain, nbytes, *ops)
    del x, rows, xi, slots, blobs
    torch.cuda.empty_cache()

    # B5a/B5b: the compressed device-tier bucket, (8, row) f32 rows (row =
    # the bucket's words rounded up to whole 256-element blocks; at
    # llama3.2-1b they are already whole), quantized in one launch; the plain
    # versions row by row (their temporaries of all eight rows would not fit
    # beside it)
    row = -(-words // 256) * 256
    n = 8 * row
    xf = torch.randn((8, row), generator=gen, device="cuda")
    q = torch.empty(n, dtype=torch.int8, device="cuda")
    sc = torch.empty(n // 256, dtype=torch.float32, device="cuda")
    qk.quantize_into(xf.view(-1), q, sc)
    err = 0
    for r in range(8):
        pq, ps = ref.quantize_blockwise(xf[r])
        err = max(err, max_value_err(q[r * row : (r + 1) * row], pq),
                  max_value_err(sc[r * row // 256 : (r + 1) * row // 256], ps))
    # per element: |x|, the running max, one division, the rounding, the clamp
    record("quantize_blockwise", "src/repro_torch/kernels/csrc/quantize.cu", "src/repro/kernels/quantize.py:40",
           err, time_ms(lambda: qk.quantize_into(xf.view(-1), q, sc)),
           time_ms(lambda: [ref.quantize_blockwise(xf[r]) for r in range(8)], reps=1),
           4 * n + n + 4 * (n // 256), flops=5 * n)
    del xf
    out = torch.empty(n, dtype=torch.float32, device="cuda")
    qk.dequantize_into(q, sc, out)
    err = 0
    for r in range(8):
        rows_q, rows_s = q[r * row : (r + 1) * row], sc[r * row // 256 : (r + 1) * row // 256]
        err = max(err, max_value_err(out[r * row : (r + 1) * row], ref.dequantize_blockwise(rows_q, rows_s)))
    record("dequantize_blockwise", "src/repro_torch/kernels/csrc/quantize.cu", "src/repro/kernels/quantize.py:60",
           err, time_ms(lambda: qk.dequantize_into(q, sc, out)),
           time_ms(lambda: [ref.dequantize_blockwise(q[r * row : (r + 1) * row], sc[r * row // 256 : (r + 1) * row // 256])
                            for r in range(8)], reps=1),
           n + 4 * (n // 256) + 4 * n, flops=2 * n)
    del q, sc, out
    torch.cuda.empty_cache()
    for r in results:
        per = ", ".join(f"{k} {v:.3f}" for k, v in r.pop("bounds").items() if v)
        log(f"kernel {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, library {r['library_ms']}, "
            f"bound {r['bound_ms']:.3f} ms by {r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}% of it; "
            f"ms per resource: {per})")
    return results


def layout_and_plan(cfg, n_ranks: int):
    """The train-state layout over an (n_ranks, 1) ("data", "model") mesh on
    the card, with its ShardPlan."""
    from repro_torch.launch.steps import train_state_layout
    from repro_torch.runtime.state import ShardPlan
    from repro_torch.sharding.mesh import make_mesh

    mesh = make_mesh((n_ranks, 1), ("data", "model"))
    layout = train_state_layout(cfg, mesh)
    return mesh, layout, ShardPlan.from_pspecs(layout.sds, layout.pspecs)


def gather_kernel_main(cfg, gen) -> dict:
    """B6 at the main path's largest gather: the w_up master leaf, four
    origin shards of (16, 512, 8192) f32 (512 rows of 512 KiB along the
    split dim), stacked as the card executor stacks them and gathered for
    new rank 0 of the drill's 4 -> 2 plan (rank 2 killed). Bit-equal to the
    plain version; the host executor gives the same bytes for every new
    rank; the axis move and the stacking copies are timed on their own."""
    import torch

    from repro_torch.elastic.plan import plan_repartition
    from repro_torch.elastic.reshard import reshard_leaves, reshard_leaves_device, segment_index, stack_rows
    from repro_torch.kernels import _build, ref, reshard as rk

    _, layout, plan = layout_and_plan(cfg, ENGINE_RANKS)
    i = plan.treedef.index(W_UP_MASTER)
    axis, shape = plan.dims[i], list(plan.shapes[i])
    shape[axis] //= ENGINE_RANKS
    sources = {o: torch.randn(shape, generator=gen, device="cuda") for o in range(ENGINE_RANKS)}
    coords = [[c[i]] for c in plan.shard_coords(ENGINE_RANKS)]
    row_bytes = sources[0].numel() * 4 // shape[axis]
    # residency after killing rank 2: survivors 0, 1, 3 renumber to 0, 1, 2;
    # rank 2's copy is adopted on its pairwise partner 0; dense rank 2 leaves
    p = plan_repartition(coords, 2, {0: 0, 1: 1, 2: 0, 3: None}, [row_bytes])

    stacked, base, tail = stack_rows(sources, axis)
    idx_host = segment_index(p.segments[0], base)
    idx = idx_host.to("cuda")
    out = torch.empty((idx.numel(), stacked.shape[1]), dtype=stacked.dtype, device="cuda")
    rk.gather_rows_into(stacked, idx_host, out)
    err = max_abs_err([(out, ref.gather_rows(stacked, idx))])
    check(err == 0, f"gather_rows: kernel differs from its plain version (max |err| {err})")

    # the host executor on the same full-width leaf, every new rank
    dev = reshard_leaves_device(p, {o: [t] for o, t in sources.items()}, [axis])
    host = reshard_leaves(p, {o: [t.cpu()] for o, t in sources.items()}, [axis])
    for j in range(2):
        check(torch.equal(dev[j][0].cpu().view(torch.int32), host[j][0].view(torch.int32)),
              f"gather_rows: new rank {j} differs from the host executor")
    del dev, host

    unit = rk.unit_bytes(row_bytes, stacked.data_ptr(), out.data_ptr())
    stream = _build.stream_of(stacked.device)
    ms = time_ms(lambda: _build.call("gather_rows", stacked.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                     idx.numel(), row_bytes, unit, stream), reps=20)
    plain_ms = time_ms(lambda: ref.gather_rows(stacked, idx))
    idx64 = idx.long()
    library_ms = time_ms(lambda: torch.index_select(stacked, 0, idx64))
    moved = [sources[o].movedim(axis, 0).contiguous() for o in range(ENGINE_RANKS)]
    copies = dict(
        movedim_ms=time_ms(lambda: [sources[o].movedim(axis, 0).contiguous() for o in range(ENGINE_RANKS)]),
        stack_ms=time_ms(lambda: torch.cat(moved)),
        stack_rows_ms=time_ms(lambda: stack_rows(sources, axis)),  # the port's one copy: cat of moved views
    )
    # bytes: each selected source row read once, each output row written once, the indices
    rows_read = int(torch.unique(idx).numel())
    nbytes = (rows_read + idx.numel()) * row_bytes + 4 * idx.numel()
    b_ms, b_by = bound(nbytes, 0)
    log(f"kernel gather_rows at the w_up master leaf ({ENGINE_RANKS} x {shape[axis]} rows of {row_bytes} B "
        f"-> {idx.numel()} rows, unit {unit} B): {ms:.3f} ms (plain {plain_ms:.3f}, index_select "
        f"{library_ms:.3f}, bound {b_ms:.3f} ms by {b_by}); copies around it: " + json.dumps(copies))
    del sources, stacked, out, moved
    torch.cuda.empty_cache()
    return dict(name="gather_rows", source="src/repro_torch/kernels/csrc/reshard.cu",
                replaces="src/repro/kernels/reshard.py:48", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, **copies)


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def host_checksum(prog, host_own, specs, mesh) -> tuple[int, int]:
    """The handshake checksum from the staged host bytes with np_checksum:
    per bucket coordinate, each leaf shard's (s1, s2) shifted to its word
    offset (s2 += offset·s1), summed over coordinates, then mixed."""
    import itertools

    import torch

    from repro_torch.utils.pytree import tree_flatten
    from repro_torch.core.integrity import np_checksum
    from repro_torch.sharding.mesh import axes_of, full_rank

    _, leaves = tree_flatten(host_own)
    _, pspecs = tree_flatten(specs)
    mask = 0xFFFFFFFF
    acc1 = acc2 = 0
    for bi, bucket in enumerate(prog.buckets):
        c1 = c2 = 0
        for i, off in zip(bucket.leaf_idx, bucket.word_offsets):
            t = leaves[i]
            # the bytes as a same-width integer array: np_checksum reads bytes only
            a = t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]).numpy()
            ps = full_rank(pspecs[i], a.ndim)
            split, axis_dims, local_dims = [], {}, []
            for size, e in zip(a.shape, ps):
                k = 1
                for ax in axes_of(e):
                    axis_dims[ax] = len(split)
                    split.append(mesh.shape[ax])
                    k *= mesh.shape[ax]
                check(size % k == 0, "main path leaves divide the mesh")
                local_dims.append(len(split))
                split.append(size // k)
            leaf_axes = [ax for ax in bucket.axes if ax in axis_dims]
            v = a.reshape(split).transpose([axis_dims[ax] for ax in leaf_axes] + local_dims)
            for coord in itertools.product(*[range(mesh.shape[ax]) for ax in bucket.axes]):
                idx = tuple(c for ax, c in zip(bucket.axes, coord) if ax in leaf_axes)
                s1, s2 = np_checksum(v[idx])
                c1 = (c1 + s1) & mask
                c2 = (c2 + s2 + off * s1) & mask
        acc1 = (acc1 * 1000003 + c1 * (bi + 1)) & mask
        acc2 = (acc2 * 1000003 + c2 * (bi + 1)) & mask
    return acc1, acc2


def main_run(state, layout, mesh, codec: str, g: int, m: int, kill) -> dict:
    """One create / stage / kill / restore cycle of the main path; every
    device and host buffer it makes is freed when it returns."""
    import torch

    from repro_torch.core.device_tier import (
        build_snapshot_program, build_striped_restore_program, overwrite_shards,
        staged_snapshot_fetch, striped_decode_rows,
    )
    from repro_torch.utils.pytree import tree_flatten

    prog = build_snapshot_program(mesh, layout.sds, layout.pspecs, codec=codec, parity_group=g, rs_parity=m)
    rest = build_striped_restore_program(mesh, layout.sds, layout.pspecs, codec=codec, parity_group=g, rs_parity=m)
    check([b.tag for b in prog.buckets] == ["data:float32"], f"buckets {[b.tag for b in prog.buckets]}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = prog.snapshot_fn(state)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    dev_sum = tuple(c & 0xFFFFFFFF for c in payload["checksum"].view(torch.int32).cpu().tolist())
    del payload
    torch.cuda.empty_cache()

    # the first fetch allocates (pins) its host buffers; the second reuses
    # them from PyTorch's pinned-memory cache
    t0 = time.perf_counter()
    host = staged_snapshot_fetch(prog, state, double_buffer=True)
    d2h_first_s = time.perf_counter() - t0
    del host
    t0 = time.perf_counter()
    host = staged_snapshot_fetch(prog, state, double_buffer=True)
    d2h_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = host_checksum(prog, host["own"], layout.pspecs, mesh)
    host_sum_s = time.perf_counter() - t0
    check(dev_sum == want, f"{codec}: device checksum {dev_sum} != host np_checksum {want}")

    overwrite_shards(mesh, state, layout.pspecs, "data", kill)  # the killed ranks' memory
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parity = {tag: t.to("cuda", non_blocking=True) for tag, t in host["parity"].items()}
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    rows, mask = striped_decode_rows(mesh.shape["data"], g, codec, m, set(kill))
    t0 = time.perf_counter()
    restored = rest.restore_fn(state, parity, {"data": rows}, {"data": mask})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(len(restored) == len(prog.exchanged_names), "restore returned every exchanged leaf")
    del parity, restored
    for i, (h, x) in enumerate(zip(tree_flatten(host["own"])[1], tree_flatten(state)[1])):
        check(torch.equal(h.to("cuda").reshape(-1).view(torch.uint8), x.reshape(-1).view(torch.uint8)),
              f"{codec}: leaf {i} differs after restore")
    state_bytes = prog.own_bytes
    fused = sum(b.words * 4 * mesh.size for b in prog.buckets)
    return dict(
        codec=codec, g=g, m=m, killed=list(kill),
        create_s=create_s, create_gbps=state_bytes / create_s / 1e9,
        d2h_first_s=d2h_first_s, d2h_s=d2h_s, d2h_gbps=prog.pcie_bytes / d2h_s / 1e9,
        h2d_parity_s=h2d_s, restore_s=restore_s, restore_gbps=fused / restore_s / 1e9,
        host_checksum_s=host_sum_s, pcie_bytes=prog.pcie_bytes, peak_device_gb=peak / 1e9,
    )


def compressed_run(state, layout, mesh) -> dict:
    """The copy codec with compress=True: create (the quantize kernel on all
    eight coordinate rows at once), codes and scales bit-equal to the plain
    quantize of the same rows, the staged fetch, and the fetched partner
    dequantized on the card (the dequantize kernel) within half a step of
    the original."""
    import torch

    from repro_torch.core.device_tier import build_snapshot_program, staged_snapshot_fetch
    from repro_torch.kernels import ops, ref

    prog = build_snapshot_program(mesh, layout.sds, layout.pspecs, compress=True)
    check([b.tag for b in prog.buckets] == ["data:float32"], f"buckets {[b.tag for b in prog.buckets]}")
    bucket = prog.buckets[0]
    words, tag = bucket.words, bucket.tag
    row = -(-words // 256) * 256  # the compressed row: whole 256-element blocks
    fused = words * 4 * mesh.size
    check(prog.pcie_bytes == prog.own_bytes + fused // 4,
          f"compressed pcie_bytes {prog.pcie_bytes} != own {prog.own_bytes} + fused/4 {fused // 4}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = prog.snapshot_fn(state)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    q, sc = payload["partner"][tag]["q"], payload["partner"][tag]["scale"]
    check(q.numel() == 8 * row and sc.numel() == 8 * row // 256, "compressed partner shapes")
    del payload
    torch.cuda.empty_cache()

    # the plain version over the same bucket: the uncompressed copy program's
    # partner holds the same f32 rows, moved along the same pairs
    plain_prog = build_snapshot_program(mesh, layout.sds, layout.pspecs, include_own_copy=False, validate=False)
    rows = plain_prog.snapshot_fn(state)["partner"][tag].view(torch.float32).view(8, words)

    def padded(r: int):
        if row == words:
            return rows[r]
        x = torch.zeros(row, dtype=torch.float32, device=rows.device)
        x[:words] = rows[r]
        return x

    err = 0.0
    for r in range(8):
        pq, ps = ref.quantize_blockwise(padded(r))
        err = max(err, max_value_err(q[r * row : (r + 1) * row], pq),
                  max_value_err(sc[r * row // 256 : (r + 1) * row // 256], ps))
        del pq, ps
    check(err == 0, f"compressed partner differs from the plain quantize (max |err| {err})")

    t0 = time.perf_counter()
    host = staged_snapshot_fetch(prog, state, double_buffer=True)
    d2h_s = time.perf_counter() - t0
    hq = host["partner"][tag]["q"].to("cuda")
    hs = host["partner"][tag]["scale"].to("cuda")
    del host
    check(torch.equal(hq, q) and torch.equal(hs.view(torch.int32), sc.view(torch.int32)),
          "staged partner differs from the snapshot's")
    del q, sc
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deq = ops.dequantize_blockwise(hq, hs)
    torch.cuda.synchronize()
    deq_s = time.perf_counter() - t0
    # |x - q·s| <= s/2 up to the rounding of x/s and of q·s: s/2 + 254·s·2^-24
    worst = 0.0
    for r in range(8):
        d = (deq[r * row : (r + 1) * row] - padded(r)).abs().view(-1, 256).amax(1)
        step = hs[r * row // 256 : (r + 1) * row // 256]
        worst = max(worst, float((d / step).max()))
        check(bool((d <= step * (0.5 + 254 * 2.0**-24)).all()), f"row {r}: dequantized beyond half a step")
    peak = torch.cuda.max_memory_allocated()
    del rows, deq, hq, hs
    torch.cuda.empty_cache()
    free_pinned_cache()
    return dict(codec="copy", compress=True, create_s=create_s, d2h_s=d2h_s,
                d2h_gbps=prog.pcie_bytes / d2h_s / 1e9, dequantize_s=deq_s,
                worst_err_in_steps=worst, pcie_bytes=prog.pcie_bytes, peak_device_gb=peak / 1e9)


def free_pinned_cache() -> None:
    """Return the pinned host blocks PyTorch caches after a staged fetch
    (where this PyTorch build exposes the call)."""
    import torch

    fn = getattr(torch._C, "_host_emptyCache", None) or getattr(torch._C, "_accelerator_emptyHostCache", None)
    if fn is not None:
        fn()


def device_tier_path(state, layout, mesh) -> tuple[dict, list[dict]]:
    """The llama3.2-1b train state on the card through every run of
    MAIN_RUNS and the compressed copy run; returns the kernels' launch
    counts over this path alone."""
    import torch

    from repro_torch.kernels import ops

    runs = []
    ops.reset_launch_counts()  # this path's counts start here
    for codec, g, m, kill in MAIN_RUNS:
        before = ops.launch_counts()
        run = main_run(state, layout, mesh, codec, g, m, kill)
        after = ops.launch_counts()
        run["launches"] = {k: after[k] - before[k] for k in after}
        runs.append(run)
        torch.cuda.empty_cache()
        free_pinned_cache()
        run["host_free_after_gib"] = host_free_gib()
        log(f"main {codec} g={g} m={m} kill {list(kill)}: " + json.dumps(run))
    before = ops.launch_counts()
    run = compressed_run(state, layout, mesh)
    after = ops.launch_counts()
    run["launches"] = {k: after[k] - before[k] for k in after}
    runs.append(run)
    log("main copy compress=True: " + json.dumps(run))
    counts = ops.launch_counts()
    for name in DEVICE_TIER_KERNELS:
        check(counts[name] > 0, f"kernel {name} was launched no time on the device-tier path")
    return counts, runs


# ---------------------------------------------------------------------------
# phase 5: the host-tier checkpoint engine at full width
# ---------------------------------------------------------------------------

ENGINE_RANKS = 4  # the quickstart's virtual failure-domain hosts
HOST_HEADROOM_GIB = 6.0


def engine_host_need_gib(layout, plan) -> float:
    """Host RAM one engine cycle holds at its peak: the own arenas of all
    ranks, the exchange arenas, the compressed copies, the full-state host
    copy the capture takes, and ``np_checksum``'s weight table (uint32, a
    power of two at least the largest own buffer's words)."""
    from repro_torch.utils.pytree import tree_flatten

    sizes = [int(math.prod(sd.shape)) * sd.dtype.itemsize for sd in tree_flatten(layout.sds)[1]]
    split = sum(b for i, b in enumerate(sizes) if plan.split_dim(i, ENGINE_RANKS) is not None)
    repl = sum(sizes) - split
    own_max_words = (repl + split // ENGINE_RANKS) // 4
    weights = 4 * (1 << max(own_max_words - 1, 1).bit_length())
    need = ENGINE_RANKS * repl + split + split + split // 4 + sum(sizes) + weights
    return need / 2**30


def _int_view(t):
    import torch

    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def engine_cycle(state, originals, plan, compress: bool) -> dict:
    """checkpoint → overwrite the live state → wipe rank 2's host store →
    restore, then every leaf checked against the originals: byte-exact,
    except rank 2's quantized leaves under compress, which must equal the
    plain dequantize(quantize(x)) of the originals bit for bit."""
    import resource

    import torch

    from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
    from repro_torch.core.integrity import np_checksum
    from repro_torch.kernels import ref
    from repro_torch.obs.trace import tracer
    from repro_torch.runtime.state import RngEntity, ShardedStateEntity
    from repro_torch.utils.pytree import tree_flatten

    class TimedEntity(ShardedStateEntity):
        """The entity, with the time its capture (the device-to-host copy of
        every leaf and the split) takes."""

        snapshot_s = 0.0

        def snapshot_shards(self, n_ranks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            shards = super().snapshot_shards(n_ranks)
            self.snapshot_s += time.perf_counter() - t0
            return shards

    eng = CheckpointEngine(ENGINE_RANKS, EngineConfig(compress=compress, restore_mode="sync"))
    rng = RngEntity()
    rng.seed, rng.counter = SEED, 17
    entity = TimedEntity(lambda: state, plan)
    eng.register("state", entity)
    eng.register("rng", rng)
    tr = tracer()
    tr.reset()
    tr.enable()
    free0 = host_free_gib()
    check(eng.checkpoint({"step": 1}), "checkpoint: the handshake failed")
    free1 = host_free_gib()
    # the host checksum's rate on this machine, over rank 0's own buffer
    own0 = eng.stores[0].buffer.read_only.own["state"][0]
    t0 = time.perf_counter()
    np_checksum(own0.numpy())
    checksum_gbps = own0.numel() / (time.perf_counter() - t0) / 1e9
    live = tree_flatten(state)[1]
    for leaf in live:  # the live state moves on: every byte overwritten
        leaf.fill_(7)
    rng.seed = rng.counter = 0
    eng.stores[2].wipe()
    meta = eng.restore()
    torch.cuda.synchronize()
    tr.disable()
    spans: dict[str, float] = {}
    for ev in tr.events():
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"]
    tr.reset()
    check(meta["step"] == 1 and (rng.seed, rng.counter) == (SEED, 17), "restore: meta or rng entity")
    quantized = exact = 0
    for i, (x, o) in enumerate(zip(live, tree_flatten(originals)[1])):
        d = plan.split_dim(i, ENGINE_RANKS)
        if d is None:
            check(torch.equal(_int_view(x), _int_view(o)), f"leaf {i} (replicated) differs after restore")
            exact += 1
            continue
        for r, (xs, os) in enumerate(zip(x.chunk(ENGINE_RANKS, d), o.chunk(ENGINE_RANKS, d))):
            if r == 2 and compress and o.is_floating_point() and os.numel() >= 256:
                flat = os.reshape(-1)
                pad = torch.zeros(-(-flat.numel() // 8192) * 8192, dtype=flat.dtype, device=flat.device)
                pad[: flat.numel()] = flat
                want = ref.dequantize_blockwise(*ref.quantize_blockwise(pad))[: flat.numel()].to(o.dtype)
                check(torch.equal(_int_view(xs.reshape(-1)), _int_view(want)),
                      f"leaf {i} rank 2: not the plain dequantize(quantize(x))")
                quantized += 1
            else:
                check(torch.equal(_int_view(xs), _int_view(os)), f"leaf {i} rank {r} differs after restore")
                exact += 1
    stats = eng.stats
    out = dict(compress=compress, create_s=stats.last_create_s, capture_s=stats.last_capture_s,
               drain_s=stats.last_finalize_wait_s, restore_s=stats.last_restore_s,
               bytes_staged=stats.last_bytes_staged, bytes_exchanged=stats.last_bytes_exchanged,
               snapshot_shards_s=entity.snapshot_s, checksum_gbps=checksum_gbps,
               span_s={k: round(v, 6) for k, v in sorted(spans.items())},
               adopted=stats.adopted_restores, zero_comm=stats.zero_comm_restores,
               exact_pieces=exact, quantized_pieces=quantized,
               host_free_before_gib=free0, host_free_after_create_gib=free1,
               host_peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng
    return out


def engine_path(state, cfg) -> tuple[dict, list[dict]]:
    """The host-tier engine over 4 ranks, compressed then not; returns the
    kernels' launch counts over this path alone."""
    import gc

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_train_state, train_state_layout
    from repro_torch.runtime.state import ShardPlan
    from repro_torch.sharding.mesh import make_mesh
    from repro_torch.utils.pytree import tree_flatten, tree_map

    mesh4 = make_mesh((ENGINE_RANKS, 1), ("data", "model"))
    layout = train_state_layout(cfg, mesh4)
    plan = ShardPlan.from_pspecs(layout.sds, layout.pspecs)
    free = host_free_settled_gib()
    need = engine_host_need_gib(layout, plan)
    layers = cfg.num_layers
    while need + HOST_HEADROOM_GIB > free and layers > 1:
        layers //= 2
        cut = replace(cfg, num_layers=layers)
        layout = train_state_layout(cut, mesh4)
        plan = ShardPlan.from_pspecs(layout.sds, layout.pspecs)
        need = engine_host_need_gib(layout, plan)
    check(need + HOST_HEADROOM_GIB <= free, f"engine path: {need:.1f} GiB of host RAM needed, {free:.1f} free")
    if layers != cfg.num_layers:
        log(f"engine: depth cut to {layers} of {cfg.num_layers} layers (width kept): "
            f"{free:.1f} GiB host RAM free, {need:.1f} GiB needed")
        state = init_train_state(layout, mesh4, torch.Generator(device="cuda").manual_seed(SEED))
    split = sum(plan.split_dim(i, ENGINE_RANKS) is not None for i in range(len(plan.dims)))
    log(f"engine: {layers} layers, {len(plan.dims)} leaves ({split} split over {ENGINE_RANKS} ranks), "
        f"host RAM {free:.1f} GiB free, about {need:.1f} GiB needed")
    originals = tree_map(lambda t: t.clone(), state)
    runs = []
    ops.reset_launch_counts()  # this path's counts start here
    for compress in (True, False):
        for x, o in zip(tree_flatten(state)[1], tree_flatten(originals)[1]):
            x.copy_(o)
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        run = engine_cycle(state, originals, plan, compress)
        after = ops.launch_counts()
        run["launches"] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        runs.append(run)
        log(f"engine compress={compress}: " + json.dumps(run))
        gc.collect()
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    for name in ("quantize_blockwise", "dequantize_blockwise"):
        check(counts[name] > 0, f"kernel {name} was launched no time on the engine path")
    return counts, runs


# ---------------------------------------------------------------------------
# phase 6: elastic N-to-M restore at full width
# ---------------------------------------------------------------------------

ELASTIC_WORLDS = (4, 2, 8)  # checkpoint on 4, restore on 2; re-protect on 2, restore on 8
ELASTIC_KILL = 2


def _pow2_words_bytes(nbytes: int) -> int:
    """Bytes of ``np_checksum``'s weight table for a buffer of ``nbytes``."""
    return 4 * (1 << max(-(-nbytes // 4) - 1, 1).bit_length())


def elastic_host_need_gib(layout, plan) -> float:
    """Host RAM the two checkpoints of the drill add at their peaks (4 and 2
    ranks, plain copies): the own and exchange arenas, beside either the
    full-state host copy the capture takes or ``np_checksum``'s weight table
    growing to the largest own buffer (old and new table at once), less the
    table already held."""
    from repro_torch.core import integrity
    from repro_torch.utils.pytree import tree_flatten

    sizes = [int(math.prod(sd.shape)) * sd.dtype.itemsize for sd in tree_flatten(layout.sds)[1]]
    split = sum(b for i, b in enumerate(sizes) if plan.split_dim(i, ENGINE_RANKS) is not None)
    repl = sum(sizes) - split
    held = integrity._WEIGHTS.nbytes
    table, need = held, 0
    for n in ELASTIC_WORLDS[:2]:
        arenas = n * repl + 2 * split
        grown = max(table, _pow2_words_bytes(repl + split // n))
        need = max(need, arenas + table + sum(sizes), arenas + table + (grown if grown > table else 0))
        table = grown
    return (need - held) / 2**30


def elastic_device_need_gb(layout, plan, n_old: int, n_new: int, failed: int) -> float:
    """Card memory a restore_elastic holds at its peak: the live state, the
    recovered payloads (survivors' full shards, adopted copies' split
    leaves; replicated leaves of an adopted copy are shared), the new split
    shards, and the largest stacked leaf."""
    from repro_torch.utils.pytree import tree_flatten

    sizes = [int(math.prod(sd.shape)) * sd.dtype.itemsize for sd in tree_flatten(layout.sds)[1]]
    split = [b for i, b in enumerate(sizes) if plan.split_dim(i, n_old) is not None]
    repl = sum(sizes) - sum(split)
    recovered = (n_old - failed) * (repl + sum(split) // n_old) + failed * sum(split) // n_old
    return (sum(sizes) + recovered + sum(split) + max(split)) / 1e9


@contextlib.contextmanager
def device_timers(*targets):
    """CUDA events around every call of each (module, function name) while
    the block runs, and the card memory allocated as each call starts;
    yields {name: [(start, end, allocated bytes), ...]}."""
    import torch

    saved, events = [], {}
    for mod, name in targets:
        fn = getattr(mod, name)
        events[name] = []

        def timed(*args, _fn=fn, _ev=events[name], **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            allocated = torch.cuda.memory_allocated()
            start.record()
            out = _fn(*args, **kw)
            end.record()
            _ev.append((start, end, allocated))
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, timed)
    try:
        yield events
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def elastic_transition(eng, cluster, state, layout, mesh, plan, n_new: int) -> dict:
    """One restore_elastic onto ``n_new`` ranks and the cluster's resize,
    then every leaf checked byte for byte against the seeded original (made
    anew on the card: no copy of the state is kept beside it). The host peak
    is the process's peak resident set so far."""
    import resource

    import torch

    from repro_torch.elastic import reshard as reshard_mod
    from repro_torch.kernels import ops, reshard as rk
    from repro_torch.launch.steps import init_train_state
    from repro_torch.obs.trace import tracer
    from repro_torch.utils.pytree import tree_flatten

    n_old = eng.n_ranks
    failed = n_old - len(cluster.alive())
    log(f"elastic {n_old} -> {n_new}: card memory expected at the peak about "
        f"{elastic_device_need_gb(layout, plan, n_old, n_new, failed):.1f} GB "
        f"(live state + recovered payloads + new split shards + the largest stacked leaf)")
    tr = tracer()
    tr.reset()
    tr.enable()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated0 = torch.cuda.memory_allocated()
    before = ops.launch_counts()["gather_rows"]
    t0 = time.perf_counter()
    with device_timers((rk, "gather_rows_into"), (reshard_mod, "stack_rows")) as ev:
        meta = eng.restore_elastic(n_new)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    cluster.resize(n_new)
    tr.disable()
    launches = ops.launch_counts()["gather_rows"] - before
    peak = torch.cuda.max_memory_allocated()
    spans: dict[str, float] = {}
    for e in tr.events():
        spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"]
    tr.reset()
    gather_ms = sum(a.elapsed_time(b) for a, b, _ in ev["gather_rows_into"])
    stack_ms = sum(a.elapsed_time(b) for a, b, _ in ev["stack_rows"])
    allocated = dict(before_gb=allocated0 / 1e9, first_stack_gb=ev["stack_rows"][0][2] / 1e9,
                     last_stack_gb=ev["stack_rows"][-1][2] / 1e9, after_gb=torch.cuda.memory_allocated() / 1e9)
    rep = eng.last_elastic_report
    axised = sum(d is not None for d in plan.dims)
    check(launches == axised * n_new, f"elastic {n_old} -> {n_new}: {launches} gather launches, "
          f"expected {axised} leaves with a data axis x {n_new} new ranks")
    check(meta["step"] == 1 and eng.n_ranks == n_new and sorted(eng.stores) == list(range(n_new)),
          "elastic: meta or new world")
    check(rep.bytes_moved == rep.bytes_lower_bound, "elastic: movement above its lower bound")

    original = init_train_state(layout, mesh, torch.Generator(device="cuda").manual_seed(SEED))
    for i, (x, o) in enumerate(zip(tree_flatten(state)[1], tree_flatten(original)[1])):
        check(torch.equal(_int_view(x), _int_view(o)), f"elastic {n_old} -> {n_new}: leaf {i} differs")
    del original
    torch.cuda.empty_cache()
    return dict(n_old=n_old, n_new=n_new, failed=failed, restore_s=eng.stats.last_restore_s, wall_s=wall_s,
                span_s={k: round(v, 6) for k, v in sorted(spans.items())},
                bytes_total=rep.bytes_total, bytes_moved=rep.bytes_moved,
                bytes_lower_bound=rep.bytes_lower_bound, movement_ratio=rep.movement_ratio,
                gather_launches=launches, gather_ms=gather_ms,
                gather_share=gather_ms / 1e3 / eng.stats.last_restore_s,
                stack_ms=stack_ms, stack_share=stack_ms / 1e3 / eng.stats.last_restore_s,
                adopted=eng.stats.adopted_restores, zero_comm=eng.stats.zero_comm_restores,
                peak_device_gb=peak / 1e9, allocated=allocated, host_free_gib=host_free_gib(),
                host_peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)


def elastic_path(state, cfg) -> tuple[dict, list[dict]]:
    """The drill of phase 6 on ``state`` (the seeded llama3.2-1b train state,
    written back in place by every restore); returns the kernels' launch
    counts over this path alone."""
    import gc

    import torch

    from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_train_state
    from repro_torch.runtime.cluster import VirtualCluster
    from repro_torch.runtime.state import RngEntity, ShardedStateEntity
    from repro_torch.utils.pytree import tree_flatten

    mesh, layout, plan = layout_and_plan(cfg, ELASTIC_WORLDS[0])
    free = host_free_settled_gib()
    need = elastic_host_need_gib(layout, plan)
    layers = cfg.num_layers
    while need + HOST_HEADROOM_GIB > free and layers > 1:
        layers //= 2
        mesh, layout, plan = layout_and_plan(replace(cfg, num_layers=layers), ELASTIC_WORLDS[0])
        need = elastic_host_need_gib(layout, plan)
    check(need + HOST_HEADROOM_GIB <= free, f"elastic path: {need:.1f} GiB of host RAM needed, {free:.1f} free")
    if layers != cfg.num_layers:
        log(f"elastic: depth cut to {layers} of {cfg.num_layers} layers (width kept): "
            f"{free:.1f} GiB host RAM free, {need:.1f} GiB needed")
        state = init_train_state(layout, mesh, torch.Generator(device="cuda").manual_seed(SEED))
    log(f"elastic: {layers} layers, host RAM {free:.1f} GiB free, about {need:.1f} GiB needed")

    eng = CheckpointEngine(ELASTIC_WORLDS[0], EngineConfig(restore_mode="sync"))
    cluster = VirtualCluster(ELASTIC_WORLDS[0])
    cluster.attach_engine(eng)
    rng = RngEntity()
    rng.seed, rng.counter = SEED, 17
    eng.register("state", ShardedStateEntity(lambda: state, plan))
    eng.register("rng", rng)
    live = tree_flatten(state)[1]
    runs = []
    ops.reset_launch_counts()  # this path's counts start here
    for n_new in ELASTIC_WORLDS[1:]:
        n = eng.n_ranks
        check(eng.checkpoint({"step": 1}), f"checkpoint on {n} ranks: the handshake failed")
        create = dict(create_s=eng.stats.last_create_s, capture_s=eng.stats.last_capture_s,
                      drain_s=eng.stats.last_finalize_wait_s, bytes_staged=eng.stats.last_bytes_staged,
                      host_free_gib=host_free_gib())
        log(f"elastic checkpoint on {n} ranks: " + json.dumps(create))
        for leaf in live:  # the live state moves on: every byte overwritten
            leaf.fill_(7)
        rng.seed = rng.counter = 0
        report = None
        if n == ELASTIC_WORLDS[0]:  # the first transition follows a failure
            cluster.kill(ELASTIC_KILL, cause="drill")
            report = cluster.stabilize("elastic")
            check(report.policy == "elastic" and report.n_ranks_after == n - 1, f"stabilize: {report}")
        run = elastic_transition(eng, cluster, state, layout, mesh, plan, n_new)
        check((rng.seed, rng.counter) == (SEED, 17), "elastic: rng entity")
        run["checkpoint"] = create
        if report is not None:
            run["stabilize"] = dict(policy=report.policy, failed=report.failed,
                                    n_ranks_after=report.n_ranks_after, load_factor=report.load_factor)
        runs.append(run)
        log(f"elastic restore {run['n_old']} -> {n_new}: " + json.dumps(run))
    kinds = [e["kind"] for e in eng.journal.events()]
    check(kinds.count("failure") == 1 and kinds.count("resize") == 2, f"elastic journal: {kinds}")
    del eng, cluster
    gc.collect()
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    check(counts["gather_rows"] > 0, "kernel gather_rows was launched no time on the elastic path")
    return counts, runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    log(f"build: {len(_build.KERNELS)} libraries in {build_s:.1f} s (each until done: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in _build.build_seconds.items()) + ")")
    for name, text in logs.items():
        ptxas_summary(name, text)
    sass_phase()
    card = gpu_line()
    _HOST_START[:] = [host_free_gib(), host_rss_gib()]
    log(f"host free memory: {_HOST_START[0]:.1f} GiB")

    kernel_tests_phase()
    from repro_torch.configs import get_config
    from repro_torch.core.device_tier import build_snapshot_program
    from repro_torch.launch.steps import init_train_state, train_state_layout
    from repro_torch.sharding.mesh import make_mesh
    from repro_torch.utils.pytree import tree_flatten

    cfg = get_config(ARCH)
    mesh = make_mesh((8, 1), ("data", "model"))
    layout = train_state_layout(cfg, mesh)
    words = build_snapshot_program(mesh, layout.sds, layout.pspecs, codec="rs", parity_group=4).buckets[0].words
    log(f"main path bucket data:float32: (8, {words}) uint32 words")
    kernels = kernel_phase_main(words, torch.Generator(device="cuda").manual_seed(SEED))
    kernels.append(gather_kernel_main(cfg, torch.Generator(device="cuda").manual_seed(SEED)))

    t0 = time.perf_counter()
    state = init_train_state(layout, mesh, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_flatten(state["params"])[1])
    state_bytes = sum(x.numel() * x.element_size() for x in tree_flatten(state)[1])
    log(f"main: {ARCH} state {n_params} params, {state_bytes / 1e9:.3f} GB on the card "
        f"({time.perf_counter() - t0:.1f} s to make)")
    # the engine path first: it needs the most host RAM, and the device-tier
    # path's staged fetches leave pinned host blocks in PyTorch's cache
    counts5, runs5 = engine_path(state, cfg)
    log(f"engine path launches: {json.dumps(counts5)}")
    counts6, runs6 = elastic_path(state, cfg)
    log(f"elastic path launches: {json.dumps(counts6)}")
    counts4, runs4 = device_tier_path(state, layout, mesh)
    log(f"device-tier path launches: {json.dumps(counts4)}")
    for k in kernels:
        k["launches"] = counts4[k["name"]] + counts5[k["name"]] + counts6[k["name"]]
        k["route"] = "cuda"
        check(k["launches"] > 0, f"kernel {k['name']} was launched no time on the main paths")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
