"""The CUDA kernels, the torch GF(2^8) backend, the device tier, the host
engine (copy and striped codecs) and its elastic N-to-M
restore on the card, against their plain PyTorch versions and the CPU path,
bit for bit; and the Trainer on the card against the Trainer on the CPU
(f32 arithmetic: losses and final state within rtol 1e-4, atol 1e-4 of
each leaf's largest magnitude); the MoE and Mamba-2 layers on the card
against the CPU, forward and backward deterministic. Each test needs a
CUDA card and ``nvcc`` and skips without them; on the GPU run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``."""

from __future__ import annotations

import itertools
import os

import numpy as np
import pytest
import torch

from repro_torch.core import gf256
from repro_torch.core.device_tier import (
    build_snapshot_program,
    build_striped_restore_program,
    overwrite_shards,
    staged_snapshot_fetch,
    striped_decode_rows,
)
from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
from repro_torch.kernels import checksum as ck
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantize as qk
from repro_torch.kernels import reshard as rk
from repro_torch.kernels import rs_decode as rd
from repro_torch.kernels import rs_encode as re
from repro_torch.kernels import xor_parity as xp
from repro_torch.runtime.state import RngEntity, ShardedStateEntity, ShardPlan
from repro_torch.sharding.mesh import make_mesh
from repro_torch.utils.pytree import tree_flatten

pytestmark = pytest.mark.cuda
# before the first cuBLAS call: deterministic cuBLAS (the MoE and SSD tests)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _words(rng, shape, device) -> torch.Tensor:
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    w.reshape(-1)[::5] = 0xFFFFFFFF
    return torch.from_numpy(w.view(np.int32)).to(device).view(torch.uint32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32).cpu(), b.view(torch.int32).cpu())


def _empty(n: int, device) -> torch.Tensor:
    return torch.empty(n, dtype=torch.int32, device=device).view(torch.uint32)


@pytest.mark.parametrize("n", [1, 5, 1027, 70_001])
@pytest.mark.parametrize("offset", [0, 1])  # 1: rows 4 bytes past a 16-byte boundary
def test_kernels_match_plain_versions(cuda, n, offset):
    base = _words(np.random.default_rng(n), (6, n + 1), cuda)
    rows = [base[i, offset : offset + n] for i in range(6)]
    x = torch.stack([r.view(torch.int32) for r in rows]).view(torch.uint32)
    before = ops.launch_counts()

    assert _same(ck.checksum_rows(base[:, offset : offset + n]), ref.checksum_rows(x))
    out = _empty(n, cuda)
    xp.xor_reduce_into(rows[:4], out)
    assert _same(out, ref.xor_reduce(x[:4]))
    gen = gf256.cauchy_matrix(2, 6).tolist()
    outs = [_empty(n, cuda) for _ in range(2)]
    re.rs_encode_into(rows, gen, outs)
    assert _same(torch.stack([o.view(torch.int32) for o in outs]), ref.gf256_matmul(x, gen))
    coefs = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 6)).astype(np.int32))
    coefs = coefs.to(cuda).view(torch.uint32)
    outs = [_empty(n, cuda) for _ in range(3)]
    rd.rs_decode_into(rows, coefs, outs)
    assert _same(torch.stack([o.view(torch.int32) for o in outs]), ref.gf256_matmul_dyn(x, coefs))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert all(after[k] == before[k] + 1 for k in ("checksum", "xor_reduce", "gf256_matmul", "gf256_matmul_dyn"))


def test_every_coefficient_and_all_ones_generator(cuda):
    x = _words(np.random.default_rng(3), (16, 4099), cuda)
    rows = list(x.unbind(0))
    for half in range(2):
        c = torch.arange(128 * half, 128 * (half + 1), dtype=torch.int32).view(8, 16)
        cu = c.to(cuda).view(torch.uint32)
        want = ref.gf256_matmul_dyn(x, cu)
        dec = [_empty(4099, cuda) for _ in range(8)]
        rd.rs_decode_into(rows, cu, dec)
        enc = [_empty(4099, cuda) for _ in range(8)]
        re.rs_encode_into(rows, c.tolist(), enc)
        for j in range(8):
            assert _same(dec[j], want[j]) and _same(enc[j], want[j])
    ones, out = [_empty(4099, cuda)], _empty(4099, cuda)
    re.rs_encode_into(rows[:5], [[1] * 5], ones)
    xp.xor_reduce_into(rows[:5], out)
    assert _same(ones[0], out)


def _gf_both(rows, coefs: np.ndarray, device) -> tuple[list, list]:
    """B3 with ``coefs`` as its static generator and B4 with it as a device
    matrix, each into fresh outputs."""
    n = rows[0].numel()
    enc = [_empty(n, device) for _ in range(coefs.shape[0])]
    re.rs_encode_into(rows, coefs.tolist(), enc)
    dec = [_empty(n, device) for _ in range(coefs.shape[0])]
    rd.rs_decode_into(rows, torch.from_numpy(coefs.astype(np.int32)).to(device).view(torch.uint32), dec)
    return enc, dec


@pytest.mark.parametrize("k", range(1, 17))
def test_every_gf_instantiation_matches_plain_version(cuda, k):
    """Each (K, M) instantiation of B3 and B4 launched once, 4 bytes off a
    16-byte boundary for odd M (the word tail loop) and aligned otherwise."""
    rng = np.random.default_rng(k)
    x = _words(rng, (k, 1031), cuda)
    for m in range(1, 9):
        rows = [x[i, m % 2 :] for i in range(k)]
        stacked = torch.stack([r.view(torch.int32) for r in rows]).view(torch.uint32)
        coefs = rng.integers(0, 256, (m, k))
        before = ops.launch_counts()
        enc, dec = _gf_both(rows, coefs, cuda)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        assert after["gf256_matmul"] == before["gf256_matmul"] + 1
        assert after["gf256_matmul_dyn"] == before["gf256_matmul_dyn"] + 1
        want = ref.gf256_matmul(stacked, coefs.tolist())
        for j in range(m):
            assert _same(enc[j], want[j]) and _same(dec[j], want[j]), (k, m, j)


_SPECIAL = {
    "zero_column": np.array([[0, 7, 142, 1], [0, 244, 1, 255]]),
    "all_ones": np.ones((1, 4), np.int64),
    "zeros_and_ones": np.array([[1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 0, 0]]),
    "all_zeros": np.zeros((2, 4), np.int64),
}


@pytest.mark.parametrize("name", sorted(_SPECIAL))
@pytest.mark.parametrize("n", [1, 5, 1027, 70_001])
@pytest.mark.parametrize("offset", [0, 1])  # 1: rows 4 bytes past a 16-byte boundary
def test_gf_special_matrices_match_plain_versions(cuda, name, n, offset):
    """A zero column, the all-ones row (the xor decode), a 0/1 matrix and
    all zeros, through B3 and B4 at ragged lengths."""
    coefs = _SPECIAL[name]
    base = _words(np.random.default_rng(n + offset), (4, n + 1), cuda)
    rows = [base[i, offset : offset + n] for i in range(4)]
    stacked = torch.stack([r.view(torch.int32) for r in rows]).view(torch.uint32)
    enc, dec = _gf_both(rows, coefs, cuda)
    want = ref.gf256_matmul(stacked, coefs.tolist())
    for j in range(coefs.shape[0]):
        assert _same(enc[j], want[j]) and _same(dec[j], want[j])
    if name == "all_ones":
        out = _empty(n, cuda)
        xp.xor_reduce_into(rows, out)
        assert _same(dec[0], out)


def test_decode_matrix_overwritten_between_launches(cuda):
    """B4 twice on one stream with the device matrix overwritten in between
    (a general pattern, then an all-0/1 one) and no host sync: each launch reads the matrix it was queued after."""
    n = 70_001
    x = _words(np.random.default_rng(11), (4, n), cuda)
    rows = list(x.unbind(0))
    first = np.array([[123, 224, 4, 5], [1, 123, 12, 10]])
    second = np.array([[1, 0, 1, 1], [0, 1, 1, 1]])
    coefs = torch.from_numpy(first.astype(np.int32)).to(cuda).view(torch.uint32)
    nxt = torch.from_numpy(second.astype(np.int32)).to(cuda).view(torch.uint32)
    outs1 = [_empty(n, cuda) for _ in range(2)]
    outs2 = [_empty(n, cuda) for _ in range(2)]
    rd.rs_decode_into(rows, coefs, outs1)
    coefs.copy_(nxt)
    rd.rs_decode_into(rows, coefs, outs2)
    torch.cuda.synchronize()
    for outs, c in ((outs1, first), (outs2, second)):
        want = ref.gf256_matmul(x, c.tolist())
        for j in range(2):
            assert _same(outs[j], want[j])


def _table(dsts, srcs, mat, lo, hi, accumulate=False):
    """The numpy table backend's product on copies of host buffers."""
    outs = [d.clone() for d in dsts]
    gf256.gf_matrix_addmul_into(outs, srcs, mat, lo, hi, accumulate, backend="table")
    return outs


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("k,m", [(1, 1), (4, 2), (6, 4), (17, 2), (18, 9)])
def test_torch_gf_backend_on_the_card_matches_table(cuda, pinned, k, m):
    """The torch backend through B4 on the card: sources ragged and 1-7 bytes
    off the word grid, ranges starting and ending mid-word, overwrite and
    accumulate, more than 16 sources or 8 outputs (split launches), from
    pinned or pageable host buffers: the table backend's bytes, and B4
    launched."""
    rng = np.random.default_rng(k * 10 + m)
    base = torch.from_numpy(rng.integers(0, 256, 300_000, dtype=np.uint8))
    if pinned:
        base = base.pin_memory()
    srcs = [base[i % 7 + 1000 * i : i % 7 + 1000 * i + 40_001 - 311 * i] for i in range(k)]
    mat = rng.integers(0, 256, (m, k)).tolist()
    n = max(s.numel() for s in srcs)
    for lo, hi, acc in ((0, n, False), (3, n - 5, True), (1_001, 20_003, False)):
        init = [torch.from_numpy(rng.integers(0, 256, n + 2, dtype=np.uint8)) for _ in range(m)]
        dsts = [d.pin_memory() for d in init] if pinned else [d.clone() for d in init]
        before = ops.launch_counts()["gf256_matmul_dyn"]
        with gf256.compute_device(cuda):
            gf256.gf_matrix_addmul_into(dsts, srcs, mat, lo, hi, acc, backend="torch")
        live = sum(any(row[i] for row in mat) for i in range(k))  # 0·x columns are not staged
        assert ops.launch_counts()["gf256_matmul_dyn"] - before == -(-live // 16) * -(-m // 8)
        for got, want in zip(dsts, _table(init, srcs, mat, lo, hi, acc)):
            assert torch.equal(got, want), (lo, hi, acc)


def test_torch_gf_backend_zero_rows_and_every_coefficient_on_the_card(cuda):
    src = torch.from_numpy(np.random.default_rng(2).integers(0, 256, 4101, dtype=np.uint8)).pin_memory()
    for c in range(256):
        dst = torch.full((4101,), 0xAB, dtype=torch.uint8)
        with gf256.compute_device(cuda):
            gf256.gf_matrix_addmul_into([dst], [src], ((c,),), backend="torch")
        assert torch.equal(dst, _table([dst], [src], ((c,),), 0, 4101)[0]), c
        if c == 0:
            assert not dst.any()


def test_torch_gf_backend_four_threads_on_four_streams(cuda):
    """Four threads, each on its own CUDA stream (as the engine's workers
    are), products interleaved: every result the table backend's."""
    import concurrent.futures

    rng = np.random.default_rng(4)
    cases = [([torch.from_numpy(rng.integers(0, 256, 1_000_003 + 17 * t + i, dtype=np.uint8)).pin_memory()
               for i in range(4)], gf256.cauchy_matrix(2, 4).tolist()) for t in range(8)]

    def work(case):
        srcs, mat = case
        n = max(s.numel() for s in srcs)
        outs = [torch.empty(n, dtype=torch.uint8).pin_memory() for _ in range(2)]
        stream = torch.cuda.Stream(cuda)
        with gf256.compute_device(cuda), torch.cuda.stream(stream):
            for lo in range(0, n, 1 << 18):
                gf256.gf_matrix_addmul_into(outs, srcs, mat, lo, min(lo + (1 << 18), n), backend="torch")
        return all(torch.equal(o, w) for o, w in zip(outs, _table(outs, srcs, mat, 0, n)))

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        assert all(ex.map(work, cases))


def test_gf_probe_times_torch_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(gf256, "_PROBE_GBPS", {})
    gf256._probe_backends()
    assert set(gf256._PROBE_GBPS) == {"table", "swar", "torch"} and gf256._PROBE_GBPS["torch"] > 0


@pytest.mark.parametrize("codec,g,m", [("copy", 0, 2), ("xor", 2, 1), ("rs", 2, 2), ("rs", 3, 2), ("lrc", 2, 2)])
def test_device_tier_on_the_card_matches_the_cpu(cuda, codec, g, m):
    rng = np.random.default_rng(0)
    cpu_state = {
        "w": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
        "v": torch.from_numpy(rng.standard_normal((8,)).astype(np.float32)).to(torch.bfloat16),
        "b": torch.from_numpy(rng.integers(-100, 100, (16,)).astype(np.int8)),
        "u": torch.from_numpy(rng.standard_normal((7, 2)).astype(np.float32)),  # padded 7 -> 8 rows
    }
    specs = {"w": ("data", "model"), "v": ("data",), "b": ("data",), "u": ("data", None)}
    pays = {}
    for dev in ("cpu", cuda):
        mesh = make_mesh((4, 2), ("data", "model"), device=dev)
        st = {k: v.to(dev) for k, v in cpu_state.items()}
        prog = build_snapshot_program(mesh, st, specs, codec=codec, parity_group=g, rs_parity=m)
        pays[str(dev)] = (prog.snapshot_fn(st), staged_snapshot_fetch(prog, st, double_buffer=True))
    (a, _), (b, staged) = pays["cpu"], pays["cuda"]
    key = "partner" if codec == "copy" else "parity"
    assert _same(a["checksum"], b["checksum"])
    for tag in a[key]:
        assert _same(a[key][tag], b[key][tag]) and _same(a[key][tag], staged[key][tag])
    if codec == "copy":
        return
    mesh = make_mesh((4, 2), ("data", "model"), device=cuda)
    rest = build_striped_restore_program(mesh, cpu_state, specs, codec=codec, parity_group=g, rs_parity=m)
    for nf in range(1, (1 if codec == "xor" else m) + 1):
        for failed in itertools.combinations(range(4), nf):
            try:
                rows, mask = striped_decode_rows(4, g, codec, m, set(failed))
            except ValueError:
                continue
            bad = {k: v.to(cuda) for k, v in cpu_state.items()}
            overwrite_shards(mesh, bad, specs, "data", failed)
            rest.restore_fn(bad, staged[key], {"data": rows}, {"data": mask})
            for k in cpu_state:
                assert torch.equal(bad[k].cpu().view(torch.uint8), cpu_state[k].view(torch.uint8)), (failed, k)


def _quant_input(n: int, dtype, device) -> torch.Tensor:
    """Normal values at a few scales, with an all-zero block and a block
    whose values sit on the round-half-even boundaries (max 127: scale 1,
    codes k + 0.5)."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32) * np.repeat(10.0 ** rng.integers(-3, 4, -(-n // 256)), 256)[:n]
    if n >= 768:
        x[256:512] = 0.0
        x[512] = 127.0
        x[513:768] = np.arange(255, dtype=np.float32) % 127 - 63 + 0.5
    return torch.from_numpy(x).to(dtype).to(device)


@pytest.mark.parametrize("n", [1, 255, 256, 769, 8193, 70_001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("offset", [0, 1])  # 1: x one element past a 16-byte boundary
def test_quantize_kernels_match_plain_versions(cuda, n, dtype, offset):
    base = _quant_input(n + 1, dtype, cuda)
    x = base[offset : offset + n]
    before = ops.launch_counts()
    q, s = ops.quantize_blockwise(x)
    xp = torch.zeros(q.numel(), dtype=dtype, device=cuda)
    xp[:n] = x
    rq, rs = ref.quantize_blockwise(xp)
    assert _same(q.view(torch.int32), rq.view(torch.int32)) and _same(s.view(torch.int32), rs.view(torch.int32))
    out = ops.dequantize_blockwise(q, s)
    assert _same(out.view(torch.int32), ref.dequantize_blockwise(rq, rs).view(torch.int32))
    # codes one byte past a 4-byte boundary take the kernel's byte-wise loads
    qs = torch.empty(q.numel() + 1, dtype=torch.int8, device=cuda)
    qs[1:] = q
    out2 = torch.empty_like(out)
    qk.dequantize_into(qs[1:], s, out2)
    assert _same(out2.view(torch.int32), out.view(torch.int32))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["quantize_blockwise"] == before["quantize_blockwise"] + 1
    assert after["dequantize_blockwise"] == before["dequantize_blockwise"] + 2
    if n >= 768 and dtype == torch.float32 and offset == 0:
        assert float(s[1]) == np.float32(1e-30) and not q[256:512].any()
        assert float(s[2]) == 1.0 and q[513:517].tolist() == [-62, -62, -60, -60]


def test_device_tier_compressed_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(0)
    cpu_state = {
        "w": torch.from_numpy(rng.standard_normal((8, 300)).astype(np.float32)),
        "v": torch.from_numpy(rng.standard_normal((8, 100)).astype(np.float32)).to(torch.bfloat16),
        "b": torch.from_numpy(rng.integers(-100, 100, (16,)).astype(np.int8)),
    }
    specs = {"w": ("data", "model"), "v": ("data", None), "b": ("data",)}
    out = {}
    for dev in ("cpu", cuda):
        mesh = make_mesh((4, 2), ("data", "model"), device=dev)
        st = {k: v.to(dev) for k, v in cpu_state.items()}
        prog = build_snapshot_program(mesh, st, specs, compress=True)
        out[str(dev)] = (prog.snapshot_fn(st), staged_snapshot_fetch(prog, st, double_buffer=True))
    (a, _), (b, staged) = out["cpu"], out["cuda"]
    assert _same(a["checksum"], b["checksum"])
    for tag in a["partner"]:
        for part in ("q", "scale"):
            x = a["partner"][tag][part]
            for y in (b["partner"][tag][part], staged["partner"][tag][part]):
                assert torch.equal(x.view(torch.uint8), y.cpu().view(torch.uint8)), (tag, part)


def _engine_state():
    """A small train-state-like tree on the CPU (f32 and bf16 leaves split on
    the data dim, a replicated f32 leaf, an int32 step) and its ShardPlan."""
    rng = np.random.default_rng(5)
    cpu_state = {
        "opt": {"m": torch.from_numpy(rng.standard_normal((8, 1000)).astype(np.float32)),
                "w16": torch.from_numpy(rng.standard_normal((4, 700)).astype(np.float32)).to(torch.bfloat16)},
        "params": {"embed": torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))},
        "step": torch.tensor(3, dtype=torch.int32),
    }
    specs = {"opt": {"m": ("data", None), "w16": ("data", None)}, "params": {"embed": (None, None)}, "step": ()}
    return cpu_state, ShardPlan.from_pspecs(cpu_state, specs)


def _state_on(cpu_state: dict, dev) -> dict:
    return {k: ({kk: vv.to(dev, copy=True) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev, copy=True))
            for k, v in cpu_state.items()}


@pytest.mark.parametrize("compress", [False, True])
def test_engine_on_the_card_matches_the_cpu(cuda, compress):
    """The host engine with a state on the card (compression and restore on
    the card) commits the same arenas and restores the same state as with
    the state on the CPU."""
    cpu_state, plan = _engine_state()
    results = {}
    for dev in ("cpu", cuda):
        state = _state_on(cpu_state, dev)
        eng = CheckpointEngine(4, EngineConfig(compress=compress, restore_mode="sync"), device=dev)
        eng.register("state", ShardedStateEntity(lambda: state, plan))
        eng.register("rng", RngEntity())
        before = ops.launch_counts()
        assert eng.checkpoint({"step": 1})
        arenas = {(r, k): f.clone() for r, st in eng.stores.items() for k, (f, _) in st.buffer.read_only.own.items()}
        held = {(r, gi, key): t.clone() for r, st in eng.stores.items()
                for gi, d in st.buffer.read_only.parity.items() for key, t in d.items()}
        for leaf in tree_flatten(state)[1]:
            leaf.fill_(7)
        eng.stores[2].wipe()
        eng.restore()
        torch.cuda.synchronize()
        after = ops.launch_counts()
        results[str(dev)] = (arenas, held, [t.cpu() for t in tree_flatten(state)[1]])
        if str(dev) != "cpu":
            n = int(compress)
            assert after["quantize_blockwise"] - before["quantize_blockwise"] == 2 * 4 * n  # 2 leaves x 4 ranks
            assert after["dequantize_blockwise"] - before["dequantize_blockwise"] == 2 * n  # rank 2's leaves
    (a_ar, a_held, a_st), (b_ar, b_held, b_st) = results["cpu"], results["cuda"]
    assert a_ar.keys() == b_ar.keys() and all(torch.equal(a_ar[k], b_ar[k]) for k in a_ar)
    assert a_held.keys() == b_held.keys() and all(torch.equal(a_held[k], b_held[k]) for k in a_held)
    for x, y in zip(a_st, b_st):
        assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("codec", ["xor", "rs", "lrc"])
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("compress", [False, True])
def test_striped_engine_on_the_card_matches_the_cpu(cuda, codec, workers, compress):
    """A striped host codec on 8 ranks in groups of 4 with the torch GF
    backend: on the card every encode range and chunked decode runs B4 (on
    the workers' streams), from pinned arenas and the pinned encode scratch; the
    committed arenas, exchange sets and stripes and the restored state (two
    losses in group 0, one for xor; pipelined and sync) are the CPU
    engine's, byte for byte."""
    cpu_state, plan = _engine_state()
    kills = (5,) if codec == "xor" else (0, 2)
    cfg = dict(codec=codec, parity_group=4, compress=compress, async_workers=workers, gf_backend="torch",
               restore_chunk_bytes=4096, encode_chunk_bytes=4096)
    results = {}
    try:
        for dev in ("cpu", cuda):
            for mode in ("pipelined", "sync"):
                state = _state_on(cpu_state, dev)
                eng = CheckpointEngine(8, EngineConfig(restore_mode=mode, **cfg), device=dev)
                eng.register("state", ShardedStateEntity(lambda: state, plan))
                eng.register("rng", RngEntity())
                before = ops.launch_counts()["gf256_matmul_dyn"]
                assert eng.checkpoint_async({"step": 1}) and eng.finalize_async() is True
                encodes = ops.launch_counts()["gf256_matmul_dyn"] - before
                if str(dev) != "cpu":
                    assert encodes > 0
                    assert all(b.is_pinned() for b in eng._enc_scratch.values())
                ro = {r: st.buffer.read_only for r, st in eng.stores.items()}
                snap = {("own", r, k): f.clone() for r in ro for k, (f, _) in ro[r].own.items()}
                snap.update({("exch", r, k): f.clone() for r in ro for k, (f, _) in ro[r].own_exch.items()})
                snap.update({(r, gi, key): t.clone() for r in ro for gi, d in ro[r].parity.items()
                             for key, t in d.items()})
                for leaf in tree_flatten(state)[1]:
                    leaf.fill_(7)
                for r in kills:
                    eng.stores[r].wipe()
                before = ops.launch_counts()["gf256_matmul_dyn"]
                eng.restore()
                torch.cuda.synchronize()
                if str(dev) != "cpu" and (mode == "pipelined" or codec != "xor"):
                    # (xor's sync decode XORs on the host, as the reference's does)
                    assert ops.launch_counts()["gf256_matmul_dyn"] > before
                assert eng.stats.reconstructed_restores == len(kills)
                results[(str(dev), mode)] = (snap, [t.cpu() for t in tree_flatten(state)[1]])
                eng.close()
    finally:
        gf256.set_backend(None)
    want_snap, want_st = results[("cpu", "sync")]
    for key, (snap, st) in results.items():
        assert snap.keys() == want_snap.keys() and all(torch.equal(snap[k], want_snap[k]) for k in snap), key
        for x, y in zip(st, want_st):
            assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)), key


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("compress", [False, True])
def test_default_engine_on_the_card_matches_the_cpu(cuda, compress, workers):
    """The reference's default engine with the state on the card: the own
    and exchange arenas are pinned; a background drain over ``workers``
    workers (under compress, B5a on the workers' own streams) commits the
    CPU engine's bytes; the pipelined restore (under compress, B5b chunk by
    chunk) gives the bytes of the sync restore on the card and of the CPU."""
    cpu_state, plan = _engine_state()
    results = {}
    for dev in ("cpu", cuda):
        for mode in ("pipelined", "sync"):
            state = _state_on(cpu_state, dev)
            eng = CheckpointEngine(4, EngineConfig(compress=compress, async_workers=workers, restore_mode=mode,
                                                   restore_chunk_bytes=4096), device=dev)
            eng.register("state", ShardedStateEntity(lambda: state, plan))
            eng.register("rng", RngEntity())
            before = ops.launch_counts()
            assert eng.checkpoint_async({"step": 1}) and eng.finalize_async() is True
            if str(dev) != "cpu":
                assert all(eng.stores[r]._arenas and all(a.is_pinned() for a in eng.stores[r]._arenas.values())
                           for r in range(4))
            arenas = {(r, k): f.clone() for r, st in eng.stores.items() for k, (f, _) in st.buffer.read_only.own.items()}
            held = {(r, gi, key): t.clone() for r, st in eng.stores.items()
                    for gi, d in st.buffer.read_only.parity.items() for key, t in d.items()}
            for leaf in tree_flatten(state)[1]:
                leaf.fill_(7)
            eng.stores[2].wipe()
            eng.restore()
            torch.cuda.synchronize()
            after = ops.launch_counts()
            results[(str(dev), mode)] = (arenas, held, [t.cpu() for t in tree_flatten(state)[1]])
            if str(dev) != "cpu" and compress:
                assert after["quantize_blockwise"] - before["quantize_blockwise"] == 2 * 4  # 2 leaves x 4 ranks
                deq = after["dequantize_blockwise"] - before["dequantize_blockwise"]
                assert deq == 2 if mode == "sync" else deq > 2  # rank 2's leaves; chunk by chunk
            if mode == "pipelined":
                assert eng.stats.last_restore_chunks > 1
            eng.close()
    want_ar, want_held, want_st = results[("cpu", "sync")]
    for key, (ar, hd, st) in results.items():
        assert ar.keys() == want_ar.keys() and all(torch.equal(ar[k], want_ar[k]) for k in ar), key
        assert hd.keys() == want_held.keys() and all(torch.equal(hd[k], want_held[k]) for k in hd), key
        for x, y in zip(st, want_st):
            assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)), key


_GATHER_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.int32)
_ROW_BYTES = (1, 2, 3, 4, 6, 64, 4100, 513_024)


def _rows(rng, rows: int, row_bytes: int, device, offset: int = 0) -> torch.Tensor:
    """A (rows, row_bytes) byte matrix of random bytes, ``offset`` bytes into
    its allocation."""
    raw = torch.from_numpy(rng.integers(0, 256, rows * row_bytes + offset, dtype=np.uint8)).to(device)
    return raw[offset:].view(rows, row_bytes)


@pytest.mark.parametrize("dtype,row_bytes", [(d, b) for d in _GATHER_DTYPES for b in _ROW_BYTES
                                             if b % torch.empty(0, dtype=d).element_size() == 0])
def test_gather_rows_matches_its_plain_version(cuda, dtype, row_bytes):
    """B6 for every row width of the shapes it meets (4-byte norm rows to
    half-megabyte MLP rows) and the odd ones between: repeated and reversed
    indices, one launch per call."""
    rng = np.random.default_rng(row_bytes)
    rows = 9 if row_bytes > 4096 else 37
    src = _rows(rng, rows, row_bytes, cuda).view(dtype)
    for idx in (torch.arange(rows - 1, -1, -1), torch.tensor([3, 3, 0, rows - 1, 3]),
                torch.from_numpy(rng.integers(0, rows, 2 * rows))):
        idx = idx.to(torch.int32)
        before = ops.launch_counts()["gather_rows"]
        got = ops.gather_rows(src, idx.to(cuda))
        got_host_idx = ops.gather_rows(src, idx)
        torch.cuda.synchronize()
        assert ops.launch_counts()["gather_rows"] == before + 2
        want = ref.gather_rows(src, idx.to(cuda))
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        assert torch.equal(got_host_idx.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("offset", [1, 2, 4, 8])  # f32 elements past a 16-byte boundary
def test_gather_rows_off_a_16_byte_boundary(cuda, offset):
    """Source and output ``offset`` elements into their allocations: the
    kernel copies in the widest unit the addresses allow (4, 8 or 16 bytes)."""
    rng = np.random.default_rng(offset)
    base = torch.from_numpy(rng.standard_normal(11 * 96 + offset).astype(np.float32)).to(cuda)
    src = base[offset:].view(11, 96)
    out = torch.empty(5 * 96 + offset, dtype=torch.float32, device=cuda)[offset:].view(5, 96)
    idx = torch.tensor([10, 0, 5, 5, 1], dtype=torch.int32)
    rk.gather_rows_into(src, idx, out)
    assert torch.equal(out.view(torch.int32), ref.gather_rows(src, idx.to(cuda)).view(torch.int32))
    assert rk.unit_bytes(96 * 4, src.data_ptr(), out.data_ptr()) == min(16, 4 * offset)


@pytest.mark.parametrize("rows_out", [0, 1])
def test_gather_rows_with_no_or_one_output_row(cuda, rows_out):
    src = _rows(np.random.default_rng(0), 5, 64, cuda)
    idx = torch.full((rows_out,), 4, dtype=torch.int32, device=cuda)
    before = ops.launch_counts()["gather_rows"]
    got = ops.gather_rows(src, idx)
    torch.cuda.synchronize()
    assert got.shape == (rows_out, 64) and torch.equal(got, src[4:5].expand(rows_out, 64))
    assert ops.launch_counts()["gather_rows"] == before + rows_out  # nothing to copy: no launch


def test_gather_rows_raises_on_an_index_out_of_range_on_the_card(cuda):
    src = torch.zeros((4, 8), device=cuda)
    for bad in ([0, 4], [-1]):
        with pytest.raises(IndexError):
            ops.gather_rows(src, torch.tensor(bad, dtype=torch.int32, device=cuda))


def _gather_case(case: str, rng, device):
    """(source, index) of one card case of the run-table gather: rows of 1-15
    bytes (runs under 16 bytes), 2- and 4-byte rows, a permutation of
    4-KiB rows, 5,000 runs (past the kernel's by-value table), no rows."""
    if case == "short":
        return _rows(rng, 40, 7, device), torch.from_numpy(rng.integers(0, 40, 90))
    if case == "two_byte":
        return _rows(rng, 1000, 2, device).view(torch.bfloat16), torch.from_numpy(rng.integers(0, 1000, 3000))
    if case == "four_byte":
        return _rows(rng, 1000, 4, device).view(torch.float32), torch.from_numpy(rng.integers(0, 1000, 3000))
    if case == "permutation":
        return _rows(rng, 256, 4096, device), torch.from_numpy(rng.permutation(256))
    if case == "many":
        idx = rng.permutation(6000)[:5000]
        idx[np.r_[False, idx[1:] == idx[:-1] + 1]] = 0  # no two consecutive: 5,000 runs
        return _rows(rng, 6000, 12, device), torch.from_numpy(idx)
    assert case == "zero"
    return _rows(rng, 8, 64, device), torch.zeros(0, dtype=torch.int64)


@pytest.mark.parametrize("case", ["short", "two_byte", "four_byte", "permutation", "many", "zero"])
def test_copy_runs_gather_matches_its_plain_version(cuda, case):
    """The run-table kernel equals ``ref.gather_rows`` bit for bit, in one
    launch per call (none for no rows)."""
    src, idx = _gather_case(case, np.random.default_rng(len(case)), cuda)
    idx = idx.to(torch.int32)
    row_bytes = src.shape[1] * src.element_size()
    table = rk.index_runs(idx, row_bytes)
    if case == "many":
        assert table.shape[0] == 5000 > rk.INLINE_RUNS
    out = torch.empty((idx.numel(), src.shape[1]), dtype=src.dtype, device=cuda)
    before = ops.launch_counts()["gather_rows"]
    rk.copy_runs_into([src], out, table)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gather_rows"] == before + (idx.numel() > 0)
    assert torch.equal(out.view(torch.uint8), ref.gather_rows(src, idx.to(cuda)).view(torch.uint8))


@pytest.mark.parametrize("src_offset,out_offset", [(1, 1), (3, 7), (15, 0), (0, 13), (8, 8), (5, 12)])
def test_copy_runs_heads_and_tails_off_16_bytes(cuda, src_offset, out_offset):
    """Source and output 1-15 bytes past a 16-byte boundary, rows of 4,100
    bytes, runs of 1-3 rows: 16-byte middles where the two addresses agree
    modulo 16 with their head and tail bytes, narrower units where they do
    not; bit-equal to the plain gather."""
    rng = np.random.default_rng(src_offset * 16 + out_offset)
    rows, row_bytes = 9, 4100
    src = _rows(rng, rows, row_bytes, cuda, src_offset)
    idx = torch.tensor([4, 5, 6, 0, 8, 8, 1, 2], dtype=torch.int32)
    raw = torch.zeros(idx.numel() * row_bytes + out_offset, dtype=torch.uint8, device=cuda)
    out = raw[out_offset:].view(idx.numel(), row_bytes)
    rk.copy_runs_into([src], out, rk.index_runs(idx, row_bytes))
    assert torch.equal(out, ref.gather_rows(src, idx.to(cuda)))
    assert int(raw[:out_offset].count_nonzero()) == 0


@pytest.mark.parametrize("n_old,n_new", [(4, 2), (2, 8), (4, 3), (3, 4)])
def test_reshard_in_place_on_the_card_matches_the_host_executor(cuda, n_old, n_new):
    """``reshard_leaves_device`` on card shards (one launch per split leaf
    per new rank, the origin shards read in place) gives the host
    executor's bytes, for leaves split on their first, middle and last dims
    in f32, bf16, int8 and int32: strided runs of a few bytes (row by row),
    of 0.5-3 KiB (aligned rows, units across rows) and of 24-96 KiB (across
    chunks)."""
    from repro_torch.elastic import plan_repartition, reshard_leaves, reshard_leaves_device

    rng = np.random.default_rng(n_old * 10 + n_new)
    state = {
        "m": torch.from_numpy(rng.standard_normal((2, 24, 300)).astype(np.float32)),
        "w16": torch.from_numpy(rng.standard_normal((24, 70)).astype(np.float32)).to(torch.bfloat16),
        "n": torch.from_numpy(rng.standard_normal(24).astype(np.float32)),
        "q": torch.from_numpy(rng.integers(-9, 9, (3, 5, 24)).astype(np.int8)),
        "i": torch.from_numpy(rng.integers(-9, 9, (48, 3)).astype(np.int32)),
        "r": torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32)),
        "w": torch.from_numpy(rng.standard_normal((64, 24, 128)).astype(np.float32)),
        "big": torch.from_numpy(rng.standard_normal((3, 48, 2048)).astype(np.float32)),
    }
    specs = {"m": (None, "data", None), "w16": ("data", None), "n": ("data",), "q": (None, None, "data"),
             "i": ("data", None), "r": (None, None), "w": (None, "data", None), "big": (None, "data", None)}
    plan = ShardPlan.from_pspecs(state, specs)
    coords = plan.shard_coords(n_old)
    shards = ShardedStateEntity(lambda: state, plan).snapshot_shards(n_old)
    host_leaves = {o: [t.clone() for t in tree_flatten(s)[1]] for o, s in enumerate(shards)}
    card_leaves = {o: [t.to(cuda) for t in leaves] for o, leaves in host_leaves.items()}
    axes = [ls.axis for ls in coords[0]]
    p = plan_repartition(coords, n_new, {o: o if o < n_new else None for o in range(n_old)})
    before = ops.launch_counts()["gather_rows"]
    card = reshard_leaves_device(p, card_leaves, axes)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gather_rows"] - before == sum(a is not None for a in axes) * n_new
    for j, new in enumerate(reshard_leaves(p, host_leaves, axes)):
        for i, (x, y) in enumerate(zip(card[j], new)):
            assert x.is_cuda and x.shape == y.shape and x.dtype == y.dtype, (j, i)
            assert torch.equal(x.cpu().reshape(-1).view(torch.uint8), y.contiguous().reshape(-1).view(torch.uint8)), (j, i)


@pytest.mark.parametrize("n_old,n_new,kill", [(4, 2, None), (4, 6, 1), (2, 8, None), (8, 3, 5)])
def test_restore_elastic_on_the_card_matches_the_cpu(cuda, n_old, n_new, kill):
    """restore_elastic with the state on the card (every split leaf of every
    new rank built by B6) restores the same bytes, with the same report, as
    the same engine on the CPU (host slicing)."""
    rng = np.random.default_rng(9)
    cpu_state = {
        "opt": {"m": torch.from_numpy(rng.standard_normal((2, 24, 300)).astype(np.float32)),
                "w16": torch.from_numpy(rng.standard_normal((24, 70)).astype(np.float32)).to(torch.bfloat16),
                "n": torch.from_numpy(rng.standard_normal(24).astype(np.float32)),
                "odd": torch.from_numpy(rng.integers(-9, 9, (7, 5)).astype(np.int32))},
        "params": {"embed": torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))},
        "step": torch.tensor(3, dtype=torch.int32),
    }
    specs = {"opt": {"m": (None, "data", None), "w16": ("data", None), "n": ("data",), "odd": ("data", None)},
             "params": {"embed": (None, None)}, "step": ()}
    plan = ShardPlan.from_pspecs(cpu_state, specs)
    results = {}
    for dev in ("cpu", cuda):
        state = {k: ({kk: vv.to(dev, copy=True) for kk, vv in v.items()} if isinstance(v, dict)
                     else v.to(dev, copy=True))
                 for k, v in cpu_state.items()}
        eng = CheckpointEngine(n_old, EngineConfig(restore_mode="sync"), device=dev)
        eng.register("state", ShardedStateEntity(lambda: state, plan))
        eng.register("rng", RngEntity())
        assert eng.checkpoint({"step": 1})
        for leaf in tree_flatten(state)[1]:
            leaf.fill_(7)
        if kill is not None:
            eng.stores[kill].wipe()
        before = ops.launch_counts()["gather_rows"]
        eng.restore_elastic(n_new)
        launches = ops.launch_counts()["gather_rows"] - before
        rep = eng.last_elastic_report
        results[str(dev)] = ([t.cpu() for t in tree_flatten(state)[1]], launches,
                             (rep.bytes_total, rep.bytes_moved, rep.bytes_lower_bound))
        assert eng.checkpoint({"step": 2})
    (a, la, ra), (b, lb, rb) = results["cpu"], results["cuda"]
    assert ra == rb and la == 0
    axised = sum(d is not None for d in plan.dims)  # every leaf with a data axis, per new rank
    assert lb == axised * n_new
    for x, y, o in zip(a, b, tree_flatten(cpu_state)[1]):
        assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        assert torch.equal(x.reshape(-1).view(torch.uint8), o.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("policy,kills", [("spare", {8: [1], 17: [2]}), ("elastic", {12: [3]})])
def test_trainer_on_the_card_matches_the_cpu(cuda, policy, kills):
    """Reduced llama3.2-1b, 20 steps, a checkpoint every 5, hosts killed per
    ``kills``: the card takes the CPU's steps (rollbacks included) from the
    same initial state and batches, both drawn from the seed by the threefry
    streams (no copy between them); under the elastic policy the restore
    runs the row gather (B6) on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.failures import FailureInjector
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    model = build_model(get_config("llama3.2-1b").reduced())
    tcfg = TrainerConfig(batch=4, seq=32, total_steps=20, checkpoint_period=5, n_virtual_hosts=4,
                         n_spares=4 if policy == "spare" else 0, recovery_policy=policy)
    runs = [Trainer(model, tcfg, injector=FailureInjector(4, schedule=kills), device=dev) for dev in ("cpu", cuda)]
    for (p, x), y in zip(zip(*tree_flatten(runs[1].state)), tree_flatten(runs[0].state)[1]):
        assert torch.equal(x.cpu().reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)), p  # same draws
    before = ops.launch_counts()["gather_rows"]
    cpu, card = (t.run(20) for t in runs)
    assert [h["step"] for h in card] == [h["step"] for h in cpu]
    assert runs[1].n_recoveries == runs[0].n_recoveries == len(kills)
    assert (ops.launch_counts()["gather_rows"] > before) == (policy == "elastic")
    np.testing.assert_allclose([h["loss"] for h in card], [h["loss"] for h in cpu], rtol=1e-4)
    for (p, x), y in zip(zip(*tree_flatten(runs[1].state)), tree_flatten(runs[0].state)[1]):
        want = y.numpy()
        np.testing.assert_allclose(x.cpu().numpy(), want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg="/".join(p))


def _twice_deterministic(fn):
    """``fn()`` twice under ``torch.use_deterministic_algorithms(True)``: both
    results, which must be the same bits."""
    torch.use_deterministic_algorithms(True)
    try:
        a, b = fn(), fn()
    finally:
        torch.use_deterministic_algorithms(False)
    for x, y in zip(a, b):
        assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
    return a


@pytest.mark.parametrize("arch", ["grok-1-314b", "mixtral-8x7b"])
@pytest.mark.parametrize("shape,groups", [((2, 32), None), ((16, 1), 1)])
def test_moe_on_the_card_matches_the_cpu(cuda, arch, shape, groups):
    """The reduced MoE layer at 8 experts (decode's 16 tokens in one group:
    C = 5, slots dropped), f32: the card routes exactly as the CPU (experts,
    capacity positions, drops), its output and aux loss within rtol 1e-5 /
    atol 1e-6; the forward and its backward (cumsum, the argmax top-k, the
    one-hot comparisons, the einsums) run under deterministic algorithms
    and give the same bits twice."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = replace(get_config(arch).reduced(), num_experts=8)
    rng = np.random.default_rng(20)
    specs = moe.abstract_params(cfg)
    params = {k: torch.from_numpy((rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(np.float32))
              for k, s in specs.items()}
    x = torch.from_numpy(rng.standard_normal((*shape, cfg.d_model)).astype(np.float32))
    r_cpu = moe.route(params, x, cfg, groups)
    out_cpu, aux_cpu = moe.apply(params, x, cfg, num_groups=groups)
    pc = {k: v.to(cuda).requires_grad_() for k, v in params.items()}
    xc = x.to(cuda).requires_grad_()

    def run():
        out, aux = moe.apply(pc, xc, cfg, num_groups=groups)
        grads = torch.autograd.grad(out.square().sum() + aux, [xc, *pc.values()])
        return [out.detach(), aux.detach(), *grads]

    out, aux, *_ = _twice_deterministic(run)
    r = moe.route(pc, xc, cfg, groups)
    for name in ("sel", "pos_in_expert", "within_cap"):
        assert torch.equal(getattr(r, name).cpu(), getattr(r_cpu, name)), name
    np.testing.assert_allclose(out.cpu().numpy(), out_cpu.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_cpu), rtol=1e-5, atol=1e-6)


def test_ssd_on_the_card_matches_the_cpu(cuda):
    """The reduced Mamba-2 SSD layer, f32: ``apply`` at chunk 8 and 128 and
    three ``decode`` steps on the card against the CPU (out, conv and state
    within rtol 1e-5 / atol 1e-5); the chunked forward and its backward run
    under deterministic algorithms and give the same bits twice."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config("mamba2-780m").reduced()
    rng = np.random.default_rng(21)
    params = {}
    for k, s in ssm.abstract_params(cfg).items():
        scale = 0.3 if len(s.shape) == 1 or k == "conv_w" else 1 / np.sqrt(s.shape[0])
        params[k] = torch.from_numpy((scale * rng.standard_normal(s.shape)).astype(np.float32))
    pc = {k: v.to(cuda).requires_grad_() for k, v in params.items()}
    tol = dict(rtol=1e-5, atol=1e-5)
    for seq, chunk in ((32, 8), (256, 128)):
        x = torch.from_numpy((0.5 * rng.standard_normal((2, seq, cfg.d_model))).astype(np.float32))
        out_cpu, cache_cpu = ssm.apply(params, x, cfg, chunk=chunk)
        xc = x.to(cuda).requires_grad_()

        def run():
            out, cache = ssm.apply(pc, xc, cfg, chunk=chunk)
            grads = torch.autograd.grad(out.square().sum() + cache["state"].sum(), [xc, *pc.values()])
            return [out.detach(), cache["conv"].detach(), cache["state"].detach(), *grads]

        out, conv, state, *_ = _twice_deterministic(run)
        np.testing.assert_allclose(out.cpu().numpy(), out_cpu.detach().numpy(), **tol)
        np.testing.assert_allclose(conv.cpu().numpy(), cache_cpu["conv"].detach().numpy(), **tol)
        np.testing.assert_allclose(state.cpu().numpy(), cache_cpu["state"].detach().numpy(), **tol)
    with torch.no_grad():
        cache = {k: v.detach() for k, v in cache_cpu.items()}
        card = {k: v.to(cuda, copy=True) for k, v in cache.items()}
        plain = {k: v.detach() for k, v in params.items()}
        for _ in range(3):
            x = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32))
            want, _ = ssm.decode(plain, x, cache, cfg)
            got, _ = ssm.decode({k: v.detach() for k, v in pc.items()}, x.to(cuda), card, cfg)
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **tol)
            for k in ("conv", "state"):
                np.testing.assert_allclose(card[k].cpu().numpy(), cache[k].numpy(), **tol)
