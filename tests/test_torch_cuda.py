"""The four CUDA kernels and the device tier on the card, against their plain
PyTorch versions and the CPU path, bit for bit. Each test needs a CUDA card
and ``nvcc`` and skips without them; on the GPU run
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
from repro_torch.kernels import checksum as ck
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rs_decode as rd
from repro_torch.kernels import rs_encode as re
from repro_torch.kernels import xor_parity as xp
from repro_torch.sharding.mesh import make_mesh

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
    assert all(after[k] == before[k] + 1 for k in after)


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
