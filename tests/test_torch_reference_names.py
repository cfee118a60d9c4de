"""The reference's small public names and their counterparts in the port,
on the same trees and mesh shapes, in-process: ``utils/pytree.py``'s
helpers, ``core/serialization.py``'s ``serialize_tree``/``deserialize_tree``,
``core/integrity.py``'s ``np_tree_checksum``, ``sharding/axes.py``'s
``tree_shardings`` and ``sharding/mesh.py``'s mesh helpers."""

from __future__ import annotations

import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import integrity as r_integrity
from repro.core import serialization as r_ser
from repro.sharding import axes as r_axes
from repro.sharding import mesh as r_mesh
from repro.utils import pytree as r_tree
from repro_torch.core import integrity as t_integrity
from repro_torch.core import serialization as t_ser
from repro_torch.launch.steps import state_from_numpy, state_to_numpy
from repro_torch.sharding import axes as t_axes
from repro_torch.sharding import mesh as t_mesh
from repro_torch.utils import pytree as t_tree


def _trees():
    rng = np.random.default_rng(5)
    return {
        "flat": {"w": rng.standard_normal((4, 3)).astype(np.float32), "step": np.asarray(7, np.int32)},
        "nested": {
            "params": {"b": rng.standard_normal(5).astype(ml_dtypes.bfloat16),
                       "a": {"k": rng.integers(-9, 9, (2, 2)).astype(np.int8)}},
            "opt": {"m": np.zeros((3,), np.float32), "v": np.full((2, 1), np.nan, np.float32)},
        },
        "leaf": rng.standard_normal(6).astype(np.float32),
    }


TREES = _trees()


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _torch_tree(tree):
    return state_from_numpy(tree, device="cpu") if isinstance(tree, dict) else state_from_numpy(
        {"x": tree}, device="cpu")["x"]


def _np(x) -> np.ndarray:
    return state_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _raw(x) -> tuple:
    a = _np(x)
    return a.dtype.name, a.shape, a.tobytes()


@pytest.mark.parametrize("name", sorted(TREES))
def test_flatten_and_map_with_names(name):
    tree = TREES[name]
    want = r_tree.flatten_with_names(_jax_tree(tree))
    got = t_tree.flatten_with_names(_torch_tree(tree))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [_raw(x) for _, x in got] == [_raw(x) for _, x in want]
    r_mapped = r_tree.tree_map_with_names(lambda n, x: len(n), _jax_tree(tree))
    t_mapped = t_tree.tree_map_with_names(lambda n, x: len(n), _torch_tree(tree))
    assert t_mapped == r_mapped


@pytest.mark.parametrize("name", sorted(TREES))
def test_sizes(name):
    tree = TREES[name]
    assert t_tree.tree_bytes(_torch_tree(tree)) == r_tree.tree_bytes(_jax_tree(tree))
    assert t_tree.tree_num_params(_torch_tree(tree)) == r_tree.tree_num_params(_jax_tree(tree))


@pytest.mark.parametrize("name", sorted(TREES))
def test_cast_and_zeros_like(name):
    """Equal names, dtypes and values; a NaN stays NaN, though its bits
    need not (PyTorch's CPU cast to bf16 gives 0xFFFF, XLA's 0x7FC0)."""
    tree = TREES[name]
    for r_dt, t_dt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = r_tree.flatten_with_names(r_tree.tree_cast(_jax_tree(tree), r_dt))
        got = t_tree.flatten_with_names(t_tree.tree_cast(_torch_tree(tree), t_dt))
        assert [n for n, _ in got] == [n for n, _ in want]
        assert r_tree.tree_equal([_np(x) for _, x in got], [_np(x) for _, x in want])
    want = r_tree.flatten_with_names(r_tree.tree_zeros_like(_jax_tree(tree)))
    got = t_tree.flatten_with_names(t_tree.tree_zeros_like(_torch_tree(tree)))
    assert [(n, _raw(x)) for n, x in got] == [(n, _raw(x)) for n, x in want]


def _nudged(tree, eps: float):
    """Each float leaf plus ``eps`` (in float32, cast back)."""
    if isinstance(tree, dict):
        return {k: _nudged(v, eps) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.kind == "f" or a.dtype == ml_dtypes.bfloat16:
        return (a.astype(np.float32) + np.float32(eps)).astype(a.dtype)
    return a


@pytest.mark.parametrize("name", sorted(TREES))
@pytest.mark.parametrize("eps", [0.0, 1e-7, 1e-3])
def test_equal_and_allclose(name, eps):
    a, b = TREES[name], _nudged(TREES[name], eps)
    ja, jb, ta, tb = _jax_tree(a), _jax_tree(b), _torch_tree(a), _torch_tree(b)
    assert t_tree.tree_equal(ta, tb) == r_tree.tree_equal(ja, jb)
    for rtol, atol in ((1e-6, 1e-6), (0.0, 1e-2)):
        assert t_tree.tree_allclose(ta, tb, rtol, atol) == r_tree.tree_allclose(ja, jb, rtol, atol)
    assert t_tree.tree_equal(ta, ta) and r_tree.tree_equal(ja, ja)  # NaN equals NaN


@pytest.mark.parametrize("name", sorted(TREES))
def test_serialize_round_trip(name):
    tree = TREES[name]
    want = r_ser.serialize_tree(_jax_tree(tree))
    got = t_ser.serialize_tree(_torch_tree(tree))
    assert got.names == want.names and got.nbytes == want.nbytes
    assert [_raw(x) for x in got.leaves] == [_raw(x) for x in want.leaves]
    assert all(x.device.type == "cpu" for x in got.leaves)
    back = t_ser.deserialize_tree(got)
    assert [(n, _raw(x)) for n, x in t_tree.flatten_with_names(back)] == [
        (n, _raw(x)) for n, x in r_tree.flatten_with_names(r_ser.deserialize_tree(want))]
    first = t_tree.flatten_with_names(back)[0][1]
    assert first.data_ptr() != got.leaves[0].data_ptr()  # copies, not views of the snapshot


@pytest.mark.parametrize("name", sorted(TREES))
def test_np_tree_checksum(name):
    leaves = [_np(x) for _, x in r_tree.flatten_with_names(_jax_tree(TREES[name]))]
    assert t_integrity.np_tree_checksum(leaves) == r_integrity.np_tree_checksum(leaves)


@pytest.mark.parametrize("sizes,names", [((8, 1), ("data", "model")), ((16, 16), ("data", "model")),
                                         ((2, 16, 16), ("pod", "data", "model"))])
def test_tree_shardings_are_the_specs(sizes, names):
    from repro.configs import CONFIGS as R_CONFIGS
    from repro.models import build_model as r_build_model
    from repro_torch.configs import CONFIGS
    from repro_torch.models import build_model

    r_model, t_model = r_build_model(R_CONFIGS["llama3.2-1b"]), build_model(CONFIGS["llama3.2-1b"])
    rm = r_mesh.abstract_mesh(*zip(names, sizes))
    tm = t_mesh.make_mesh(sizes, names, device="meta")
    want = r_tree.flatten_with_names(
        r_axes.tree_shardings(r_model.abstract_params, r_axes.rules_for_shape(r_model.rules, "train", 256), rm))
    got = t_tree.flatten_with_names(
        t_axes.tree_shardings(t_model.abstract_params, t_axes.rules_for_shape(t_model.rules, "train", 256), tm))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [spec for _, spec in got] == [tuple(s.spec) for _, s in want]


@pytest.mark.parametrize("sizes,names", [((8,), ("data",)), ((4, 2), ("data", "model")),
                                         ((2, 16, 16), ("pod", "data", "model")), ((16, 16), ("data", "model"))])
def test_mesh_helpers(sizes, names):
    """On a mesh over devices 0..n-1 in row-major order (what
    ``jax.make_mesh`` gives over a host's devices), the port's helpers
    answer as the reference's."""
    n = int(np.prod(sizes))
    devices = np.array([types.SimpleNamespace(id=i) for i in range(n)], dtype=object).reshape(sizes)
    ref = types.SimpleNamespace(shape=dict(zip(names, sizes)), devices=devices)
    port = t_mesh.make_mesh(sizes, names, device="meta")
    for axes in (None, "data", ("data", "model"), ("pod", "data"), ("nope",)):
        assert t_mesh.mesh_axis_size(port, axes) == r_mesh.mesh_axis_size(ref, axes)
    assert t_mesh.data_axes(port) == r_mesh.data_axes(ref)
    assert np.array_equal(t_mesh.flat_device_index(port), r_mesh.flat_device_index(ref))
    for chips in (1, 4, 8):
        assert t_mesh.hosts_of_mesh(port, chips) == r_mesh.hosts_of_mesh(ref, chips)
    # a process mesh's coordinates are the same row-major order
    axes = tuple(zip(names, sizes))
    for r in (0, n // 2, n - 1):
        c = t_mesh.coords_of(axes, r)
        assert t_mesh.ProcessMesh(axes, r, torch.device("cpu"), "gloo").rank_of(c) == r
        assert devices[tuple(c[a] for a in names)].id == r
