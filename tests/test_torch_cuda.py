"""The CUDA kernels, the device tier, the host engine and its elastic N-to-M
restore on the card, against their plain PyTorch versions and the CPU path,
bit for bit. Each test needs a
CUDA card and ``nvcc`` and skips without them; on the GPU run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``."""

from __future__ import annotations

import itertools

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


@pytest.mark.parametrize("codec,g,m", [("copy", 0, 2), ("xor", 2, 1), ("rs", 2, 2), ("rs", 3, 2)])
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


@pytest.mark.parametrize("compress", [False, True])
def test_engine_on_the_card_matches_the_cpu(cuda, compress):
    """The host engine with a state on the card (compression and restore on
    the card) commits the same arenas and restores the same state as with
    the state on the CPU."""
    rng = np.random.default_rng(5)
    cpu_state = {
        "opt": {"m": torch.from_numpy(rng.standard_normal((8, 1000)).astype(np.float32)),
                "w16": torch.from_numpy(rng.standard_normal((4, 700)).astype(np.float32)).to(torch.bfloat16)},
        "params": {"embed": torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))},
        "step": torch.tensor(3, dtype=torch.int32),
    }
    specs = {"opt": {"m": ("data", None), "w16": ("data", None)}, "params": {"embed": (None, None)}, "step": ()}
    plan = ShardPlan.from_pspecs(cpu_state, specs)
    results = {}
    for dev in ("cpu", cuda):
        state = {k: ({kk: vv.to(dev, copy=True) for kk, vv in v.items()} if isinstance(v, dict)
                     else v.to(dev, copy=True))
                 for k, v in cpu_state.items()}
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
