"""The port's llama3.2-1b train-state layout against the JAX package's
``build_step(cfg, "train_4k", mesh)`` on an (8, 1) ("data", "model") mesh,
leaf for leaf (path, shape, dtype, spec) with nothing materialised, and the
slice end to end at reduced size against the JAX run: rs g=4 m=2, create,
kill ranks {0, 2}, restore. Exact equality throughout."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.device_tier import (
    build_snapshot_program,
    build_striped_restore_program,
    dtype_name,
    overwrite_shards,
    striped_decode_rows,
)
from repro_torch.launch.steps import (
    init_train_state,
    state_from_numpy,
    state_to_numpy,
    train_state_layout,
)
from repro_torch.sharding.mesh import make_mesh
from repro_torch.utils.pytree import tree_flatten, tree_unflatten
from test_torch_device_tier import run_oracle


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return run_oracle("state", tmp_path_factory.mktemp("oracle") / "state.npz")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((8, 1), ("data", "model"), device="cpu")


def _spec_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def test_llama_layout_matches_build_step(jx, mesh):
    _, meta = jx
    layout = train_state_layout(get_config("llama3.2-1b"), mesh)
    paths, sds = tree_flatten(layout.sds)
    _, specs = tree_flatten(layout.pspecs)
    got = [["/".join(p), list(s.shape), dtype_name(s.dtype), _spec_json(sp)] for p, s, sp in zip(paths, sds, specs)]
    assert got == meta["layout"]
    n = sum(int(np.prod(s.shape)) for p, s in zip(paths, sds) if p[0] == "params")
    assert n == 1_235_814_400
    # the ZeRO-1 leaves make one data:float32 bucket
    prog = build_snapshot_program(mesh, layout.sds, layout.pspecs, codec="rs", parity_group=4)
    assert [b.tag for b in prog.buckets] == ["data:float32"]
    assert len(prog.buckets[0].leaf_idx) == 3 * 11


def test_reduced_slice_create_kill_restore_matches_jax(jx, mesh):
    arrays, meta = jx
    cfg = get_config("llama3.2-1b").reduced()
    layout = train_state_layout(cfg, mesh)
    paths, _ = tree_flatten(layout.sds)
    assert ["/".join(p) for p in paths] == meta["small_paths"]
    state = state_from_numpy(tree_unflatten(paths, [arrays[f"state/{'/'.join(p)}"] for p in paths]), device="cpu")
    original = {k: v.clone() for k, v in zip(paths, tree_flatten(state)[1])}

    prog = build_snapshot_program(mesh, layout.sds, layout.pspecs, codec="rs", parity_group=4, rs_parity=2)
    assert [[b.tag, list(b.leaf_idx), list(b.word_offsets), b.words] for b in prog.buckets] == [
        [b["tag"], b["leaf_idx"], b["word_offsets"], b["words"]] for b in meta["small_buckets"]]
    payload = prog.snapshot_fn(state)
    assert np.array_equal(state_to_numpy(payload["checksum"]), arrays["checksum"])
    for tag, val in payload["parity"].items():
        got, want = state_to_numpy(val), arrays[f"parity/{tag}"]
        assert got.shape == want.shape and np.array_equal(got, want), tag

    overwrite_shards(mesh, state, layout.pspecs, "data", (0, 2), value=-7.0)
    _, leaves = tree_flatten(state)
    assert not all(torch.equal(original[p], x) for p, x in zip(paths, leaves))
    rows, mask = striped_decode_rows(8, 4, "rs", 2, {0, 2})
    rest = build_striped_restore_program(mesh, layout.sds, layout.pspecs, codec="rs", parity_group=4, rs_parity=2)
    out = rest.restore_fn(state, payload["parity"], {"data": rows}, {"data": mask})
    assert sorted(out, key=int) == sorted((k.split("/")[1] for k in arrays if k.startswith("restored/")), key=int)
    for idx, leaf in out.items():
        want = arrays[f"restored/{idx}"]
        got = state_to_numpy(leaf)
        assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8)), idx
    for p, x in zip(paths, tree_flatten(state)[1]):
        assert torch.equal(original[p], x), p


def test_init_train_state_is_seeded_and_shaped(mesh):
    layout = train_state_layout(get_config("llama3.2-1b").reduced(), mesh)
    a = init_train_state(layout, mesh, torch.Generator().manual_seed(3))
    b = init_train_state(layout, mesh, torch.Generator().manual_seed(3))
    for (path, spec), x, y in zip(zip(*tree_flatten(layout.sds)), tree_flatten(a)[1], tree_flatten(b)[1]):
        assert tuple(x.shape) == spec.shape and x.dtype == spec.dtype, path
        assert torch.equal(x, y), path
    assert torch.equal(a["opt"]["master"]["embed"], a["params"]["embed"].float())


def test_state_numpy_round_trip_is_bit_exact():
    import ml_dtypes

    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(ml_dtypes.bfloat16),
            "b": {"c": rng.integers(0, 2**32, (5,), dtype=np.uint32), "d": np.asarray(7, np.int32)},
            "e": rng.standard_normal(6).astype(np.float32)}
    tree["a"].view(np.uint16)[0, 0] = 0x7FC1  # a NaN payload survives only a bit copy
    back = state_to_numpy(state_from_numpy(tree, device="cpu"))
    for (p, x), y in zip(zip(*tree_flatten(tree)), tree_flatten(back)[1]):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), p


def test_tree_flatten_leaves_no_reference_behind():
    """Flattened leaves are freed as soon as the caller drops them, without
    the cyclic garbage collector (a self-recursive closure used to hold them
    in a reference cycle: on the card, gigabytes of recovered shards outlived
    an elastic restore)."""
    import gc
    import weakref

    leaf = torch.zeros(4)
    ref = weakref.ref(leaf)
    gc.disable()
    try:
        paths, leaves = tree_flatten({"a": {"b": leaf}, "c": torch.ones(2)})
        assert paths == [("a", "b"), ("c",)] and leaves[0] is leaf
        del leaf, leaves
        assert ref() is None
    finally:
        gc.enable()
