"""The port's AdamW and learning-rate schedule against the JAX package's,
on the CPU, from the same numpy inputs.

Tolerances: one ``adamw_update`` — master, m, v and params rtol 1e-6, with
atol 1e-6 of each leaf's largest magnitude (the moments' ``b*m + (1-b)*g``
cancels to near 0 in places, where only absolute precision is left);
``warmup_cosine`` over steps 0..60 rtol 1e-7."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.adamw import global_norm as ref_global_norm
from repro.optim.schedule import warmup_cosine as ref_warmup_cosine
from repro_torch.optim.adamw import AdamWConfig, adamw_update, global_norm, init_opt_state
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.utils.pytree import tree_flatten, tree_map

SHAPES = {"a": (64, 32), "b": {"c": (7,), "d": (3, 5, 2)}}


def _tree(rng, scale: float, nonneg: bool = False) -> dict:
    def leaf(shape):
        x = scale * rng.standard_normal(shape)
        return (np.abs(x) if nonneg else x).astype(np.float32)

    return {"a": leaf(SHAPES["a"]), "b": {"c": leaf(SHAPES["b"]["c"]), "d": leaf(SHAPES["b"]["d"])}}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _check_leaves(got, want) -> None:
    for (p, g), w in zip(zip(*tree_flatten(got)), tree_flatten(jax.device_get(want))[1]):
        w = np.asarray(w, dtype=np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                   err_msg="/".join(p))


# grad scale 0.5: the global norm is above 1, so the clip scales every grad;
# grad scale 0.01: below 1, no clip
@pytest.mark.parametrize("grad_scale", [0.5, 0.01])
def test_one_adamw_step_matches_reference(grad_scale):
    rng = np.random.default_rng(0)
    grads, w = _tree(rng, grad_scale), _tree(rng, 1.0)
    m, v = _tree(rng, 1e-2), _tree(rng, 1e-3, nonneg=True)
    step = 3  # bias correction with b**4
    ref_params, ref_opt, ref_stats = ref_adamw_update(
        grads, {"master": w, "m": m, "v": v}, jnp.int32(step), RefAdamWConfig(lr=1e-3),
        lr_schedule=ref_warmup_cosine(1e-3, 10, 60), param_dtype=jnp.float32)

    params, opt = _t(w), {"master": _t(w), "m": _t(m), "v": _t(v)}
    live = tree_flatten(params)[1] + [x for t in opt.values() for x in tree_flatten(t)[1]]
    ptrs = [x.data_ptr() for x in live]
    st = torch.tensor(step, dtype=torch.int32)
    stats = adamw_update(_t(grads), params, opt, st, AdamWConfig(lr=1e-3),
                         lr_schedule=warmup_cosine(1e-3, 10, 60))
    assert int(st) == step + 1
    assert [x.data_ptr() for x in live] == ptrs  # written in place
    np.testing.assert_allclose(float(stats["grad_norm"]), float(ref_stats["grad_norm"]), rtol=1e-6)
    assert float(stats["lr"]) == float(ref_stats["lr"])
    _check_leaves(params, ref_params)
    for k in ("master", "m", "v"):
        _check_leaves(opt[k], ref_opt[k])


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(1), 3.0)
    np.testing.assert_allclose(float(global_norm(_t(tree))), float(ref_global_norm(tree)), rtol=1e-6)


@pytest.mark.parametrize("args", [(3e-3, 5, 60), (1e-3, 10, 60)], ids=["quickstart", "trainer_default"])
def test_warmup_cosine_matches_reference(args):
    ref = ref_warmup_cosine(*args)
    want = np.array([np.asarray(ref(jnp.int32(s))) for s in range(61)])
    got = warmup_cosine(*args)(torch.arange(61, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)


def test_init_opt_state_copies_master():
    """master is an f32 copy even of f32 params (never an alias: the update
    and restores write both in place); moments start at zero."""
    params = {"w": torch.randn(4, 3), "b": torch.randn(3).to(torch.bfloat16)}
    opt = init_opt_state(params)
    assert opt["master"]["w"].data_ptr() != params["w"].data_ptr()
    assert torch.equal(opt["master"]["w"], params["w"])
    assert opt["master"]["b"].dtype == torch.float32 and torch.equal(opt["master"]["b"], params["b"].float())
    assert all(torch.count_nonzero(x) == 0 for k in ("m", "v") for x in tree_flatten(opt[k])[1])
