"""The port's device tier against the JAX package's, byte for byte.

One subprocess (eight virtual CPU devices, as tests/test_device_tier.py runs)
runs the JAX programs on the (4, 2) ("data", "model") mesh with an
f32/bf16/int8 state and writes an .npz; the port runs here on
``device="cpu"`` with the same bytes. Every comparison is exact.
"""

from __future__ import annotations

import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_jax_oracle as oracle
from repro_torch.core.device_tier import (
    build_snapshot_program,
    build_striped_restore_program,
    cached_snapshot_program,
    overwrite_shards,
    program_cache_clear,
    program_cache_stats,
    staged_snapshot_fetch,
    striped_decode_rows,
)
from repro_torch.launch.steps import state_from_numpy, state_to_numpy
from repro_torch.sharding.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
CASES = {name: (codec, g, m) for name, codec, g, m in oracle.CASES}
STRIPED = [n for n, (codec, _, _) in CASES.items() if codec != "copy"]


def run_oracle(kind: str, out: Path) -> tuple[dict, dict]:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_jax_oracle.py"), kind, str(out)],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return oracle.load(str(out))


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return run_oracle("device_tier", tmp_path_factory.mktemp("oracle") / "device_tier.npz")


@pytest.fixture(scope="module")
def setup():
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    state_np, specs = oracle.device_tier_state()
    return mesh, state_np, specs


def _port_state(state_np):
    return state_from_numpy(state_np, device="cpu")


def _np(x) -> np.ndarray:
    return state_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b) -> bool:
    """Same shape, dtype and bytes."""
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _prog(setup, name, **kw):
    mesh, state_np, specs = setup
    codec, g, m = CASES[name]
    return build_snapshot_program(mesh, _port_state(state_np), specs, codec=codec, parity_group=g, rs_parity=m, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_buckets_and_byte_accounting(jx, setup, name):
    _, meta = jx
    prog = _prog(setup, name)
    want = meta[name]
    got = [
        {"tag": b.tag, "axis": b.axis, "dtype": b.dtype, "axes": list(b.axes),
         "leaf_idx": list(b.leaf_idx), "word_offsets": list(b.word_offsets), "words": b.words}
        for b in prog.buckets
    ]
    assert got == want["buckets"]
    assert (prog.own_bytes, prog.exchanged_bytes, prog.pcie_bytes) == (
        want["own_bytes"], want["exchanged_bytes"], want["pcie_bytes"])
    assert list(prog.exchanged_names) == want["exchanged_names"]
    codec, g, m = CASES[name]
    if codec == "copy":
        return
    mesh, state_np, specs = setup
    rest = build_striped_restore_program(mesh, _port_state(state_np), specs, codec=codec, parity_group=g, rs_parity=m)
    assert oracle._restore_meta(rest) == want["restore"]


@pytest.mark.parametrize("name", list(CASES))
def test_snapshot_payload_matches(jx, setup, name):
    arrays, _ = jx
    _, state_np, _ = setup
    payload = _prog(setup, name).snapshot_fn(_port_state(state_np))
    assert _same(payload["checksum"], arrays[f"{name}/checksum"])
    for k in state_np:
        assert _same(payload["own"][k], arrays[f"{name}/own/{k}"]), k
    key = "partner" if CASES[name][0] == "copy" else "parity"
    assert set(payload) == {"own", key, "checksum"}
    for tag, val in payload[key].items():
        assert _same(val, arrays[f"{name}/{key}/{tag}"]), tag


@pytest.mark.parametrize("double_buffer", [True, False])
def test_staged_fetch_matches_snapshot(jx, setup, double_buffer):
    arrays, _ = jx
    _, state_np, _ = setup
    state = _port_state(state_np)
    prog = _prog(setup, "xor2")
    staged = staged_snapshot_fetch(prog, state, double_buffer=double_buffer)
    assert set(staged) == {"own", "parity"}  # the staged path folds no checksum
    for tag, val in staged["parity"].items():
        assert _same(val, arrays[f"staged{int(double_buffer)}/parity/{tag}"]), tag
        assert _same(val, arrays[f"xor2/parity/{tag}"]), tag
    for k in state_np:
        assert _same(staged["own"][k], arrays[f"xor2/own/{k}"]), k
        assert staged["own"][k].data_ptr() != state[k].data_ptr()  # never aliases live state


@pytest.mark.parametrize("double_buffer", [True, False])
def test_compressed_snapshot_matches(jx, setup, double_buffer):
    """compress=True: every bucket (f32, bf16, and int8 cast to f32) is
    quantized on all coordinate rows at once; the partners' int8 codes and
    f32 scales, the checksum, the own copy and the staged fetch equal the
    reference's byte for byte, and the host traffic is own + fused/4."""
    arrays, meta = jx
    mesh, state_np, specs = setup
    state = _port_state(state_np)
    prog = build_snapshot_program(mesh, state, specs, compress=True)
    want = meta["compressed"]
    assert [b.tag for b in prog.buckets] == [b["tag"] for b in want["buckets"]]
    assert (prog.own_bytes, prog.exchanged_bytes, prog.pcie_bytes) == (
        want["own_bytes"], want["exchanged_bytes"], want["pcie_bytes"])
    fused = sum(b.words * 4 * int(np.prod([mesh.shape[a] for a in b.axes])) for b in prog.buckets)
    assert prog.pcie_bytes == prog.own_bytes + fused // 4
    payload = prog.snapshot_fn(state)
    assert _same(payload["checksum"], arrays["compressed/checksum"])
    staged = staged_snapshot_fetch(prog, state, double_buffer=double_buffer)
    assert set(payload["partner"]) == set(staged["partner"]) == {b.tag for b in prog.buckets}
    for tag in payload["partner"]:
        for part in ("q", "scale"):
            assert _same(payload["partner"][tag][part], arrays[f"compressed/partner/{tag}/{part}"]), (tag, part)
            assert _same(staged["partner"][tag][part], arrays[f"compressed/staged/{tag}/{part}"]), (tag, part)
    for k in state_np:
        assert _same(payload["own"][k], state_np[k]) and _same(staged["own"][k], state_np[k]), k
    with pytest.raises(ValueError):
        build_snapshot_program(mesh, state, specs, codec="xor", parity_group=2, compress=True)


@pytest.mark.parametrize("name", STRIPED)
def test_decode_rows_match(jx, name):
    arrays, meta = jx
    codec, g, m = CASES[name]
    for tag, accepted in meta[name]["combos"]:
        failed = set() if tag == "none" else {int(r) for r in tag.split("-")}
        if not accepted:
            with pytest.raises(ValueError):
                striped_decode_rows(4, g, codec, m, failed)
            continue
        rows, mask = striped_decode_rows(4, g, codec, m, failed)
        assert np.array_equal(rows, arrays[f"{name}/rows/{tag}"]) and rows.dtype == np.uint32
        assert np.array_equal(mask, arrays[f"{name}/mask/{tag}"]) and mask.dtype == np.uint32


@pytest.mark.parametrize("name", STRIPED)
def test_striped_restore_every_failure_combo(jx, setup, name):
    """Every failure combination the codec tolerates, with garbage in the
    failed shards: the port's restore equals the JAX restore and the
    original state, leaf for leaf."""
    arrays, meta = jx
    mesh, state_np, specs = setup
    codec, g, m = CASES[name]
    state = _port_state(state_np)
    payload = _prog(setup, name, include_own_copy=False, validate=False).snapshot_fn(state)
    rest = build_striped_restore_program(mesh, state, specs, codec=codec, parity_group=g, rs_parity=m)
    names = sorted(state_np)
    n_ok = 0
    for tag, accepted in meta[name]["combos"]:
        if not accepted:
            continue
        failed = () if tag == "none" else tuple(int(r) for r in tag.split("-"))
        bad = _port_state(oracle.corrupt(state_np, failed, {"w": 2, "v": 2, "b": 4}))
        rows, mask = arrays[f"{name}/rows/{tag}"], arrays[f"{name}/mask/{tag}"]
        out = rest.restore_fn(bad, payload["parity"], {"data": rows}, {"data": mask})
        assert sorted(out) == sorted(k.split("/")[-1] for k in arrays if k.startswith(f"{name}/restored/{tag}/"))
        for idx, leaf in out.items():
            assert _same(leaf, arrays[f"{name}/restored/{tag}/{idx}"]), (tag, idx)
            assert _same(leaf, state_np[names[int(idx)]]), (tag, idx)
        n_ok += 1
    assert n_ok > 1


def test_overwrite_shards_hits_only_the_killed_ranks(setup):
    mesh, state_np, specs = setup
    state = _port_state(state_np)
    overwrite_shards(mesh, state, specs, "data", [1, 3], value=99)
    want = oracle.corrupt(state_np, (1, 3), {"w": 2, "v": 2, "b": 4})
    for k in state_np:
        assert _same(state[k], want[k]), k


def test_program_cache_reuses_builds(setup):
    mesh, state_np, specs = setup
    state = _port_state(state_np)
    program_cache_clear()
    a = cached_snapshot_program(mesh, state, specs, codec="xor", parity_group=2)
    b = cached_snapshot_program(mesh, state, specs, codec="xor", parity_group=2)
    c = cached_snapshot_program(mesh, state, specs, codec="rs", parity_group=2)
    assert a is b and c is not a
    assert program_cache_stats() == {"hits": 1, "misses": 2, "size": 2}


def test_no_quiet_fallback_to_the_cpu(setup):
    """A state on another device than the mesh's is refused, and asking for
    CUDA where there is none raises instead of running on the CPU."""
    mesh, state_np, specs = setup
    prog = _prog(setup, "xor2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh((4, 2), ("data", "model"))
    meta_state = {k: torch.empty(v.shape, dtype=_port_state(state_np)[k].dtype, device="meta") for k, v in state_np.items()}
    with pytest.raises(ValueError):
        prog.snapshot_fn(meta_state)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_distribution_matches(n):
    """Rank permutations, parity groups, blob holders, copy shifts and
    Algorithm 4's recovery plan: the port's copy of
    ``repro.core.distribution`` gives the reference's answers."""
    from repro.core import distribution as jdist
    from repro_torch.core import distribution as tdist

    for scheme in ("pairwise", "neighbor") + (("mirror",) if n % 2 == 0 else ()):
        pairs = tdist.perm_pairs(n, scheme)
        assert pairs == jdist.perm_pairs(n, scheme)
        assert tdist.inverse_perm(pairs) == jdist.inverse_perm(pairs)
    assert tdist.perm_pairs(n, shift=1) == jdist.perm_pairs(n, shift=1)
    for g in range(1, n + 1):
        groups = tdist.parity_groups(n, g)
        assert [grp.members for grp in groups] == [grp.members for grp in jdist.parity_groups(n, g)]
        assert [tdist.group_of(r, g) for r in range(n)] == [jdist.group_of(r, g) for r in range(n)]
        ng = len(groups)
        assert [tdist.blob_holder_group(ng, gi, b) for gi in range(ng) for b in range(3)] == [
            jdist.blob_holder_group(ng, gi, b) for gi in range(ng) for b in range(3)]
    for copies in range(1, 4):
        assert tdist.multi_copy_shifts(n, copies) == jdist.multi_copy_shifts(n, copies)
    # Algorithm 4: the same plan, or DataLostError on both sides
    for scheme in ("pairwise", "neighbor"):
        for failed in ({n - 1}, {0, n // 2}, {0, 1}):
            got = want = None
            try:
                want = jdist.recovery_plan(n, failed, scheme)
            except jdist.DataLostError:
                want = "lost"
            try:
                got = tdist.recovery_plan(n, failed, scheme)
            except tdist.DataLostError:
                got = "lost"
            assert got == want, (scheme, failed)
