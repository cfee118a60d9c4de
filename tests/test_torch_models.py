"""The port's dense model against the JAX package's, on the CPU, in f32: the
building blocks (rmsnorm, RoPE, blockwise attention, the MLPs, the
attention layer) and the reduced llama3.2-1b loss and its gradient, from
the same numpy inputs. Params cross with ``state_from_numpy``.

Tolerances: blocks rtol 1e-5 with atol 1e-6 (outputs that cancel to near 0
have no relative precision); loss rtol 1e-5; every gradient leaf rtol 1e-4,
atol 1e-6."""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro_torch.configs import get_config
from repro_torch.launch.steps import state_from_numpy
from repro_torch.models import attention, build_model, common, lm, mlp
from repro_torch.sharding.spec import init_tree, tree_count
from repro_torch.utils import threefry
from repro_torch.utils.pytree import tree_flatten, tree_unflatten

BLOCK_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops run faster on one thread than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    _close(common.rmsnorm(_t(x), _t(scale), 1e-5), ref_common.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5),
           **BLOCK_TOL)


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    pos = np.arange(64, dtype=np.int32) + 7
    _close(common.apply_rope(_t(x), _t(pos), 500_000.0), ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0),
           **BLOCK_TOL)


# (seq, chunk, causal, window, softcap): two chunks; a padded last chunk;
# a window that skips KV chunks; non-causal with a softcap, padded
ATTN_CASES = {
    "two_chunks": (64, 32, True, None, None),
    "padded": (40, 32, True, None, None),
    "local_window": (64, 16, True, 24, None),
    "noncausal_softcap": (40, 16, False, None, 20.0),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_blockwise_attention_matches_reference(case):
    seq, chunk, causal, window, cap = ATTN_CASES[case]
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, seq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, seq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, seq, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, attn_cap=cap, q_chunk=chunk, k_chunk=chunk)
    got = attention.blockwise_attention(_t(q), _t(k), _t(v), **kw)
    want = ref_attention.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    assert tuple(got.shape) == want.shape
    _close(got, want, **BLOCK_TOL)


def _layer_params(ref_specs, rng) -> dict:
    """Normal weights over the square root of their contracted dims (wo
    contracts heads and head_dim), so outputs are of order 1."""
    def fan_in(k, shape):
        return shape[0] * shape[1] if k == "wo" else shape[0]

    return {k: (rng.standard_normal(s.shape) / np.sqrt(fan_in(k, s.shape))).astype(np.float32)
            for k, s in ref_specs.items()}


@pytest.mark.parametrize("kind", ["attn", "local"])
def test_attention_layer_matches_reference(kind):
    jcfg = ref_get_config("llama3.2-1b").reduced()
    cfg = get_config("llama3.2-1b").reduced()
    rng = np.random.default_rng(3)
    params = _layer_params(ref_attention.abstract_params(jcfg), rng)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    got, _ = attention.apply({k: _t(v) for k, v in params.items()}, _t(x), cfg, kind=kind)
    want, _ = ref_attention.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg, kind=kind)
    _close(got, want, **BLOCK_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    jcfg = ref_get_config("llama3.2-1b").reduced().with_(mlp_kind=kind)
    cfg = replace(get_config("llama3.2-1b").reduced(), mlp_kind=kind)
    rng = np.random.default_rng(4)
    params = _layer_params(ref_mlp.abstract_params(jcfg), rng)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    _close(mlp.apply({k: _t(v) for k, v in params.items()}, _t(x), cfg),
           ref_mlp.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg), **BLOCK_TOL)


def test_abstract_params_match_reference():
    """One declaration: paths, shapes, dims, init rules and dtypes equal the
    reference's at full width, and so does the parameter count."""
    ref = ref_build_model(ref_get_config("llama3.2-1b"))
    model = build_model(get_config("llama3.2-1b"))
    ref_paths, ref_specs = [], []
    for path, s in jax.tree_util.tree_flatten_with_path(ref.abstract_params, is_leaf=lambda s: hasattr(s, "dims"))[0]:
        ref_paths.append(tuple(k.key for k in path))
        ref_specs.append(s)
    paths, specs = tree_flatten(model.abstract_params)
    assert paths == ref_paths
    for p, a, b in zip(paths, specs, ref_specs):
        assert (a.shape, a.dims, a.init, a.scale) == (b.shape, b.dims, b.init, b.scale), p
        assert str(a.dtype).split(".")[-1] == np.dtype(b.dtype).name, p
    assert model.n_params == ref.n_params == 1_235_814_400


def test_init_tree_is_seeded_per_leaf():
    cfg = get_config("llama3.2-1b").reduced()
    specs = lm.abstract_params(cfg)
    a = init_tree(threefry.PRNGKey(5), specs, "cpu")
    b = init_tree(threefry.PRNGKey(5), specs, "cpu")
    paths, la = tree_flatten(a)
    for p, x, y in zip(paths, la, tree_flatten(b)[1]):
        assert torch.equal(x, y), p
    assert torch.count_nonzero(a["final_norm"]) == 0  # "zeros" leaves
    # fan-in scaled normals: w_down's fan-in is d_ff
    assert abs(float(a["layers"]["slot0"]["ffn"]["w_down"].std()) * np.sqrt(cfg.d_ff) - 1) < 0.1
    assert tree_count(specs) == sum(x.numel() for x in la)


@pytest.fixture(scope="module")
def loss_case():
    """Reduced llama3.2-1b params (norm scales perturbed off zero) and a
    batch of seq 64: two attention chunks of 32."""
    jcfg = ref_get_config("llama3.2-1b").reduced()
    ref = ref_build_model(jcfg)
    rng = np.random.default_rng(6)
    params = jax.device_get(ref.init(jax.random.PRNGKey(0)))
    params = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype), params)
    tokens = rng.integers(0, jcfg.vocab_size, (4, 64)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    fn = jax.jit(jax.value_and_grad(lambda p, b: ref.loss(p, b), has_aux=True))
    (loss, _), grads = fn(params, jax.tree.map(jnp.asarray, batch))
    return params, batch, float(loss), jax.device_get(grads)


def test_loss_and_grads_match_reference(loss_case):
    params, batch, want_loss, want_grads = loss_case
    model = build_model(get_config("llama3.2-1b").reduced())
    paths, leaves = tree_flatten(state_from_numpy(params, device="cpu"))
    leaves = [x.requires_grad_() for x in leaves]
    loss, metrics = model.loss(tree_unflatten(paths, leaves), {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert float(metrics["tokens"]) == batch["labels"].size
    want_paths, want = [], []
    for path, g in jax.tree_util.tree_flatten_with_path(want_grads)[0]:
        want_paths.append(tuple(k.key for k in path))
        want.append(g)
    assert want_paths == paths
    for p, g, w in zip(paths, grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6, err_msg="/".join(p))


def test_remat_full_gives_the_same_loss_and_grads(loss_case):
    """``remat="full"`` (each period and the loss chunk under
    ``torch.utils.checkpoint``) and ``remat="dots"`` (the period's matmul
    outputs saved, the rest recomputed) recompute the same arithmetic:
    loss and gradients bit-equal to ``"none"``'s."""
    params, batch, _, _ = loss_case
    cfg = get_config("llama3.2-1b").reduced()
    out = []
    for remat in ("none", "full", "dots"):
        model = build_model(replace(cfg, remat=remat))
        paths, leaves = tree_flatten(state_from_numpy(params, device="cpu"))
        leaves = [x.requires_grad_() for x in leaves]
        loss, _ = model.loss(tree_unflatten(paths, leaves), {k: _t(v) for k, v in batch.items()})
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    for loss, grads in out[1:]:
        assert torch.equal(out[0][0], loss)
        for a, b in zip(out[0][1], grads):
            assert torch.equal(a, b)

