"""The port's encoder (hubert-xlarge) and VLM (llama-3.2-vision-90b) paths
against the JAX package's, on the CPU, in f32 (in-process: neither needs a
mesh), from the same numpy inputs; params cross with ``state_from_numpy``.

* Cross-attention: ``attention.apply(kind="cross")`` (q from ``x``, k/v from
  the source, no RoPE, no causal mask; 40 source rows over chunks of 32, so
  the source pads) and ``attention.decode(kind="cross")`` over a filled
  cross cache, which decode leaves unwritten; the cross cache's declaration.
* The reduced encoder's forward (every position's logits from prefill, no
  cache), masked-prediction loss and gradients; the reduced VLM's loss and
  gradients, prefill logits and cache (the cross slot's ``vision_tokens``
  rows) and three decode steps' logits.
* The twin of ``tests/test_models.py::test_encoder_is_bidirectional``; the
  encoder has no decode step.
* ``make_batch`` for both families at several steps: tokens, labels and the
  mask byte-equal to the reference's, frames and the vision stub within
  ``threefry.normal``'s 3 ulp.

Tolerances (``tests/test_torch_models.py``'s): layer outputs and the
encoder's logits rtol 1e-5 with atol 1e-6; loss rtol 1e-5; every gradient
leaf rtol 1e-4 with atol 1e-6. The VLM's logits and caches through its five
layers (values of order 1-3) rtol 1e-5 with atol 1e-5: the same stack with
five self-attention slots differs from the reference by 3e-6 as well.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.synthetic import make_batch as ref_make_batch
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.steps import state_from_numpy
from repro_torch.models import attention, build_model
from repro_torch.utils.pytree import tree_flatten, tree_leaves, tree_unflatten

BLOCK_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
DEEP_TOL = dict(rtol=1e-5, atol=1e-5)
HUBERT, VLM = "hubert-xlarge", "llama-3.2-vision-90b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops run faster on one thread than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in float32 ulp between two arrays."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(2**31)) - ia, ia)  # sign-magnitude to a monotone line
    ib = np.where(ib < 0, np.int64(-(2**31)) - ib, ib)
    return int(np.abs(ia - ib).max())


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cross_case():
    """The reduced VLM's config and one cross layer's params (d_model 64, 4
    heads over 2 KV heads of 16): normal weights over the square root of
    their contracted dims, so outputs are of order 1, as in
    ``tests/test_torch_models.py``."""
    cfg = get_config(VLM).reduced()
    rng = np.random.default_rng(3)
    shapes = {k: s.shape for k, s in attention.abstract_params(cfg, cross=True).items()}
    params = {k: (rng.standard_normal(s) / np.sqrt(s[0] * s[1] if k == "wo" else s[0])).astype(np.float32)
              for k, s in shapes.items()}
    return cfg, ref_get_config(VLM).reduced(), params, rng


def test_cross_params_and_cache_spec_match_reference(cross_case):
    cfg, jcfg, _, _ = cross_case
    for cross in (False, True):
        got = attention.abstract_params(cfg, cross=cross)
        want = ref_attention.abstract_params(jcfg, cross=cross)
        assert {k: (s.shape, s.dims) for k, s in got.items()} == {k: (s.shape, s.dims) for k, s in want.items()}
    for kind in ("attn", "cross"):
        got = attention.decode_cache_spec(cfg, 3, 24, kind)
        want = ref_attention.decode_cache_spec(jcfg, 3, 24, kind)
        assert {k: (s.shape, s.dims) for k, s in got.items()} == {k: (s.shape, s.dims) for k, s in want.items()}
    assert got["k"].shape == (3, cfg.vision_tokens, cfg.num_kv_heads, cfg.resolved_head_dim)


def test_cross_attention_apply_matches_reference(cross_case):
    """Queries of 24 positions against 40 source rows: no RoPE, no causal
    mask (a change of the last source row moves the first query's output),
    the padded source rows masked."""
    cfg, jcfg, params, rng = cross_case
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    want, wkv = ref_attention.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg, kind="cross",
                                    kv_src=jnp.asarray(src))
    tp = {k: _t(v) for k, v in params.items()}
    got, kv = attention.apply(tp, _t(x), cfg, kind="cross", kv_src=_t(src))
    _close(got, want, **BLOCK_TOL)
    for k in ("k", "v"):
        assert tuple(kv[k].shape) == (2, 40, cfg.num_kv_heads, cfg.resolved_head_dim)
        _close(kv[k], wkv[k], **BLOCK_TOL)
    src2 = src.copy()
    src2[:, -1] += 1.0
    moved, _ = attention.apply(tp, _t(x), cfg, kind="cross", kv_src=_t(src2))
    assert not torch.allclose(moved[:, 0], got[:, 0], atol=1e-7)


def test_cross_attention_decode_matches_reference_and_writes_nothing(cross_case):
    cfg, jcfg, params, rng = cross_case
    B, V, KV, D = 2, cfg.vision_tokens, cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {k: rng.standard_normal((B, V, KV, D)).astype(np.float32) for k in ("k", "v")}
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    tp = {k: _t(v) for k, v in params.items()}
    tcache = {k: _t(v) for k, v in cache.items()}
    for pos in (3, 11):
        want, wcache = ref_attention.decode(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                            jax.tree.map(jnp.asarray, cache), jnp.asarray(pos, jnp.int32), jcfg,
                                            kind="cross")
        got, out = attention.decode(tp, _t(x), tcache, torch.tensor(pos, dtype=torch.int32), cfg, kind="cross")
        _close(got, want, **BLOCK_TOL)
        assert out is tcache
        for k in ("k", "v"):
            assert tcache[k].numpy().tobytes() == cache[k].tobytes() == np.asarray(wcache[k]).tobytes()


# ---------------------------------------------------------------------------
# the reduced encoder and VLM against repro.models
# ---------------------------------------------------------------------------

def _case(arch: str, batch: int = 4, seq: int = 32, perturb: bool = True):
    """Reference params and the reference's batch at step 0, as numpy. With
    ``perturb`` every leaf gets noise of 0.1 (the norm scales leave their
    constants), as in ``tests/test_torch_moe_ssm.py``'s loss cases; else the
    params are the reference's init at ``PRNGKey(1)``, as in
    ``tests/test_torch_server.py``'s decode cases."""
    jcfg = ref_get_config(arch).reduced()
    ref = ref_build_model(jcfg)
    rng = np.random.default_rng(23)
    params = jax.device_get(ref.init(jax.random.PRNGKey(0 if perturb else 1)))
    if perturb:
        params = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype), params)
    batch = {k: np.asarray(v) for k, v in ref_make_batch(jcfg, 0, 0, batch, seq).items()}
    return ref, params, batch, build_model(get_config(arch).reduced())


@pytest.mark.parametrize("arch", [HUBERT, VLM])
def test_loss_and_grads_match_reference(arch):
    """The encoder's masked prediction (frames through ``in_proj``, the loss
    over the 8% masked positions; the unused embedding's gradient zero) and
    the VLM's next-token loss over its cross slot."""
    ref, params, batch, model = _case(arch)
    if arch == HUBERT:
        assert set(batch) == {"frames", "labels", "mask"} and 0 < batch["mask"].sum() < batch["mask"].size
    fn = jax.jit(jax.value_and_grad(lambda p, b: ref.loss(p, b), has_aux=True))
    (want_loss, want_metrics), want_grads = fn(params, jax.tree.map(jnp.asarray, batch))

    paths, leaves = tree_flatten(state_from_numpy(params, device="cpu"))
    leaves = [x.requires_grad_() for x in leaves]
    loss, metrics = model.loss(tree_unflatten(paths, leaves), {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    assert float(metrics["tokens"]) == float(want_metrics["tokens"])
    want_paths, want = [], []
    for path, g in jax.tree_util.tree_flatten_with_path(jax.device_get(want_grads))[0]:
        want_paths.append(tuple(k.key for k in path))
        want.append(g)
    assert want_paths == paths
    for p, g, w in zip(paths, grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL, err_msg="/".join(p))
    if arch == HUBERT:
        assert not grads[paths.index(("embed",))].any()


def test_encoder_prefill_matches_reference():
    """Every position's logits, and no cache."""
    ref, params, batch, model = _case(HUBERT, batch=2, perturb=False)
    want, wcache = ref.prefill(params, frames=jnp.asarray(batch["frames"]))
    with torch.no_grad():
        got, cache = model.prefill(state_from_numpy(params, device="cpu"), frames=_t(batch["frames"]))
    assert cache is None and wcache is None
    assert tuple(got.shape) == (2, 32, model.cfg.padded_vocab)
    _close(got, want, **BLOCK_TOL)


def test_vlm_prefill_and_decode_steps_match_reference():
    """Prefill logits and cache (the cross slot's 16 vision rows), then three
    decode steps in the ``max_seq`` cache: logits against the reference's,
    the cross cache left as prefill filled it."""
    ref, params, batch, model = _case(VLM, batch=2, seq=12, perturb=False)
    toks, vision = batch["tokens"], batch["vision"]
    jl, jcache = jax.jit(lambda p, t, v: ref.prefill(p, tokens=t, vision=v))(params, jnp.asarray(toks),
                                                                           jnp.asarray(vision))
    tp = state_from_numpy(params, device="cpu")
    with torch.no_grad():
        logits, cache = model.prefill(tp, _t(toks), vision=_t(vision))
    _close(logits, jl, **DEEP_TOL)
    paths, leaves = tree_flatten(cache)
    for p, leaf in zip(paths, leaves):
        want = np.asarray(jcache[p[0]][p[1]])
        assert tuple(leaf.shape) == want.shape, p
        np.testing.assert_allclose(leaf.numpy(), want, **DEEP_TOL, err_msg="/".join(p))
    cross = [p for p in paths if model.cfg.layer_pattern[int(p[0][4:])] == "cross"]
    assert cross and all(cache[s][k].shape[2] == model.cfg.vision_tokens for s, k in cross)

    max_seq = 20
    full = model.init_cache(2, max_seq, "cpu")
    for f, part in zip(tree_leaves(full), leaves):
        f[tuple(slice(0, n) for n in part.shape)] = part
    jfull = jax.tree.map(lambda f, c: f.at[tuple(slice(0, s) for s in c.shape)].set(c),
                         ref.init_cache(2, max_seq), jcache)
    before = {p: cache[p[0]][p[1]].clone() for p in cross}
    step = jax.jit(ref.decode_step)
    tok, pos = np.argmax(np.asarray(jl), -1).astype(np.int32), toks.shape[1]
    for _ in range(3):
        jl, jfull = step(params, jfull, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, out = model.decode_step(tp, full, _t(tok), torch.tensor(pos, dtype=torch.int32))
        assert out is full
        _close(got, jl, **DEEP_TOL)
        tok, pos = np.argmax(np.asarray(jl), -1).astype(np.int32), pos + 1
    for s, k in cross:
        assert torch.equal(full[s][k], before[(s, k)])
    for p, leaf in zip(*tree_flatten(full)):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jfull[p[0]][p[1]]), **DEEP_TOL)


def test_encoder_is_bidirectional():
    """Changing the LAST frame changes the FIRST position's logits."""
    model = build_model(get_config(HUBERT).reduced())
    params = state_from_numpy(jax.device_get(ref_build_model(ref_get_config(HUBERT).reduced()).init(
        jax.random.PRNGKey(0))), device="cpu")
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 16, 32)).astype(np.float32))
    frames2 = frames.clone()
    frames2[:, 15] += 1.0
    with torch.no_grad():
        l1, _ = model.prefill(params, frames=frames)
        l2, _ = model.prefill(params, frames=frames2)
    assert not torch.allclose(l1[:, 0], l2[:, 0], atol=1e-7)


def test_encoder_has_no_decode_step():
    model = build_model(get_config(HUBERT).reduced())
    with pytest.raises(ValueError, match="no decode step"):
        model.decode_step({}, {}, torch.zeros(1, dtype=torch.int32), torch.tensor(0))


# ---------------------------------------------------------------------------
# make_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [HUBERT, VLM])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_make_batch_matches_reference(arch, reduced):
    """Integer and boolean draws byte-equal, normals within 3 ulp (the full
    configs' stub widths: 512-wide frames, 1600 x 1280 vision patches)."""
    cfg, jcfg = get_config(arch), ref_get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    seq = 32 if reduced else 8
    for step in (0, 5):
        got = make_batch(cfg, 7, step, 2, seq)
        want = {k: np.asarray(v) for k, v in ref_make_batch(jcfg, 7, step, 2, seq).items()}
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k].numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, k
            if w.dtype == np.float32:
                assert _ulps(g, w) <= 3, k
            else:
                assert g.tobytes() == w.tobytes(), k
