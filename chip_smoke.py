#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build the kernels, hold
each against its plain PyTorch version, then create and restore a full-width
llama3.2-1b train state through the device tier.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``); it exits non-zero,
printing no result, on any failure or without a card. Phases:

1. build: one ``nvcc`` per kernel source, all at once; the card's name and
   power limit and the host's free memory;
2. kernel tests: ``pytest -m cuda tests/test_torch_cuda.py`` in a child
   process: B1-B4 against their plain versions at ragged small sizes, and the
   device tier on the card against the CPU path (f32/bf16/int8 leaves,
   padded shards, ragged groups, every tolerated failure combination);
3. kernels at the main path's shapes (the encode outputs are stripe-slot
   views of a payload tensor, and the decode runs at both runs' shapes):
   each bit-equal to its plain version, with its time, its plain version's,
   a PyTorch call's where one computes the same function, and its bound;
4. main path: the llama3.2-1b train state (~17.3 GB, seeded) on a virtual
   (8, 1) ("data", "model") mesh, with rs g=4 m=2 and with xor g=4:
   snapshot with the device checksum (held against ``np_checksum`` of the
   staged host bytes), staged fetch to pinned host memory (twice: first
   with fresh pinned buffers, then reusing them), ranks killed, parity
   uploaded, striped restore, every leaf compared. The kernels' launch
   counts are read over this phase alone.

The line before the last is the kernels' JSON; the last line is the result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
ARCH = "llama3.2-1b"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# Integer instruction issue: 4 schedulers per SM, each one 32-lane warp
# instruction per clock, so 128 lanes per SM (64 on the INT32 pipe, 64 on
# the FMA pipe, which runs IMAD; Hopper architecture white paper) x 132 SMs
# x 1.98 GHz boost clock. The data sheet lists no integer rate.
INT_OPS_PER_S = 128 * 132 * 1.98e9
MAIN_RUNS = (("rs", 4, 2, (0, 2)), ("xor", 4, 1, (5,)))


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


def gf_ops(coefs, n_words: int) -> float:
    """Integer instructions the GF(2^8) product needs for these coefficients,
    per uint32 word of 4 field bytes: per input column, 4 per xtime step up
    to its highest set bit (the top-bit mask, a LOP3; the reduction
    multiply-high by 0x1D << 25, an IMAD.HI; the doubling, an IMAD.SHL; the
    masked XOR that joins them, a LOP3), plus half a LOP3 per set
    coefficient bit (a three-input XOR folds two terms into an accumulator).
    This counts what the function needs, not what the compiled kernel issues
    (``tools/sass_mix.py`` reads that)."""
    ops = 0.0
    for i in range(len(coefs[0])):
        col = [int(row[i]) for row in coefs]
        top = max(col).bit_length()
        ops += 4 * max(top - 1, 0) + 0.5 * sum(bin(c).count("1") for c in col)
    return ops * n_words


def bound(nbytes: int, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


# ---------------------------------------------------------------------------
# phase 2: the kernels on the card at small and ragged sizes (pytest -m cuda)
# ---------------------------------------------------------------------------

def kernel_tests_phase() -> None:
    """tests/test_torch_cuda.py: B1-B4 against their plain versions at ragged
    lengths, unaligned rows, all-ones words and every coefficient, and the
    device tier on the card against the CPU path for every codec and failure
    combination. Its launches happen in its own process."""
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
    from repro_torch.kernels import checksum as ck, ref, rs_decode as rd, rs_encode as re, xor_parity as xp

    results = []

    def record(name, source, replaces, err, ms, plain, nbytes, ops, lib=None):
        check(err == 0, f"{name}: kernel differs from its plain version (max |err| {err})")
        b_ms, b_by = bound(nbytes, ops)
        results.append(dict(name=name, source=source, replaces=replaces, max_abs_err=err, ms=ms,
                            plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))

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
           buf.numel() * 4 + 8 * 8, 3 * buf.numel())
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
           5 * words * 4, 3 * words,
           time_ms(lambda: torch.bitwise_xor(torch.bitwise_xor(xi[0], xi[1]), torch.bitwise_xor(xi[2], xi[3]))))

    # B3: rs g=4 m=2 (the Cauchy generator)
    gen_c = gf256.cauchy_matrix(2, 4).tolist()
    re.rs_encode_into(rows, gen_c, blobs)
    err = max_abs_err(zip(blobs, ref.gf256_matmul(x, gen_c)))
    record("gf256_matmul", "src/repro_torch/kernels/csrc/rs_encode.cu", "src/repro/kernels/rs_encode.py:83", err,
           time_ms(lambda: re.rs_encode_into(rows, gen_c, blobs)), time_ms(lambda: ref.gf256_matmul(x, gen_c), reps=1),
           6 * words * 4, gf_ops(gen_c, words))

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
        b_ms, b_by = bound(nbytes, ops)
        log(f"rs_decode at the {codec} run's shape ({len(inputs)} -> {len(outs)}): {ms:.3f} ms "
            f"(plain {plain:.3f} ms, bound {b_ms:.3f} ms by {b_by}), max |err| {err}")
        return err, ms, plain, nbytes, ops

    # B4, rs run: ranks {0, 2} from survivors 1, 3 and blobs 0, 1
    rs_case = decode_case("rs", 2, [0, 2], [1, 3, 4, 5], [rows[1], rows[3], blobs[0], blobs[1]], [rows[0], rows[2]])
    # B4, xor run: rank 5 (member 1 of group 1) from members 0, 2, 3 and the XOR blob
    xp.xor_reduce_into(rows, blobs[0])
    xor_err = decode_case("xor", 1, [5], [0, 2, 3, 4], [rows[0], rows[2], rows[3], blobs[0]], [rows[1]])[0]
    err, ms, plain, nbytes, ops = rs_case
    record("gf256_matmul_dyn", "src/repro_torch/kernels/csrc/rs_decode.cu", "src/repro/kernels/rs_decode.py:77",
           max(err, xor_err), ms, plain, nbytes, ops)
    del x, rows, xi, slots, blobs
    torch.cuda.empty_cache()
    for r in results:
        log(f"kernel {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.3f} ms by {r['bound_by']})")
    return results


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


def main_path() -> tuple[dict, list[dict]]:
    """The llama3.2-1b train state on the card, through every run of
    MAIN_RUNS; returns the kernels' launch counts over those runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.utils.pytree import tree_flatten
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_train_state, train_state_layout
    from repro_torch.sharding.mesh import make_mesh

    mesh = make_mesh((8, 1), ("data", "model"))
    layout = train_state_layout(get_config(ARCH), mesh)
    t0 = time.perf_counter()
    state = init_train_state(layout, mesh, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_flatten(state["params"])[1])
    state_bytes = sum(x.numel() * x.element_size() for x in tree_flatten(state)[1])
    log(f"main: {ARCH} state {n_params} params, {state_bytes / 1e9:.3f} GB on the card "
        f"({time.perf_counter() - t0:.1f} s to make)")
    runs = []
    ops.reset_launch_counts()  # the main path's counts start here
    for codec, g, m, kill in MAIN_RUNS:
        before = ops.launch_counts()
        run = main_run(state, layout, mesh, codec, g, m, kill)
        after = ops.launch_counts()
        run["launches"] = {k: after[k] - before[k] for k in after}
        runs.append(run)
        log(f"main {codec} g={g} m={m} kill {list(kill)}: " + json.dumps(run))
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was launched no time on the main path")
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
    log(f"build: {len(_build.KERNELS)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    card = gpu_line()
    log(f"host free memory: {host_free_gib():.1f} GiB")

    kernel_tests_phase()
    from repro_torch.configs import get_config
    from repro_torch.core.device_tier import build_snapshot_program
    from repro_torch.launch.steps import train_state_layout
    from repro_torch.sharding.mesh import make_mesh

    layout = train_state_layout(get_config(ARCH), make_mesh((8, 1), ("data", "model")))
    words = build_snapshot_program(make_mesh((8, 1), ("data", "model")), layout.sds, layout.pspecs,
                                   codec="rs", parity_group=4).buckets[0].words
    log(f"main path bucket data:float32: (8, {words}) uint32 words")
    kernels = kernel_phase_main(words, torch.Generator(device="cuda").manual_seed(SEED))
    counts, runs = main_path()
    for k in kernels:
        k["launches"] = counts[k["name"]]
        k["route"] = "cuda"
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
