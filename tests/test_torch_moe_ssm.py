"""The port's MoE and Mamba-2 (SSD) modules against the JAX package's, on the
CPU, in f32, from the same numpy inputs (in-process: neither needs a mesh).

MoE: ``moe.apply`` for the swiglu (mixtral) and gelu (grok) experts, with
the reference's groups and with one group (decode's), and a decode-shaped
call of 16 tokens over 8 experts, whose capacity C = 5 drops tokens by
design. The routing (selected experts, capacity positions, the dropped
slots) must equal the reference's exactly: the reference computes it
inline in ``repro.models.moe.apply`` (lines 64-93), so the test evaluates
those lines in jnp on the same inputs. Tied probabilities route to the
lower expert index, as ``jax.lax.top_k`` gives them. ``out`` and ``aux``
within rtol 1e-5 / atol 1e-6.

SSD: ``ssm.apply`` at chunk 8 and 128 and ``ssm.decode`` against the
reference (out, ``conv`` and ``state`` within rtol 1e-5 / atol 1e-5);
the chunked dual form against the port's own token-by-token recurrence
(``tests/test_models.py``'s duality check, atol 2e-4 on out and 2e-3 on
the state); decode writes the cache tree in place. Where the reference's
gradient overflows to NaN (a long chunk with large dt), the port's stays
finite and its output equal.

Last, the reduced mixtral, mamba2, jamba and gemma2-2b loss and gradient
against ``repro.models`` (``tests/test_torch_models.py``'s tolerances:
loss rtol 1e-5, every gradient leaf rtol 1e-4 with atol 1e-6).
"""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.launch.steps import state_from_numpy
from repro_torch.models import build_model, moe, ssm
from repro_torch.sharding.spec import init_tree
from repro_torch.utils import threefry
from repro_torch.utils.pytree import tree_flatten, tree_unflatten

MOE_TOL = dict(rtol=1e-5, atol=1e-6)
SSM_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops run faster on one thread than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def test_expert_capacity_matches_reference():
    """tests/test_models.py's cases, and the full-width mixtral's prefill
    (512-token groups) and decode (one group of 16 sessions) capacities."""
    assert moe.expert_capacity(64, 4, 2, 1.25) == 40
    assert moe.expert_capacity(64, 4, 2, 100.0) == 64  # dropless cap
    assert moe.expert_capacity(512, 8, 2, 1.25) == 160
    assert moe.expert_capacity(16, 8, 2, 1.25) == 5
    for case in ((64, 4, 2, 1.25), (64, 4, 2, 100.0), (512, 8, 2, 1.25), (16, 8, 2, 1.25), (3, 8, 2, 1.25),
                 (1, 16, 2, 1.25), (100, 16, 2, 0.5)):
        assert moe.expert_capacity(*case) == ref_moe.expert_capacity(*case), case


def _ref_routing(params, x, cfg, num_groups):
    """``repro.models.moe.apply``'s routing lines in jnp: (sel, pos_in_expert,
    within_cap, C)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_tok
    T = B * S
    if num_groups is None:
        per_row = max(1, S // ref_moe.GROUP_TOKENS) if S % ref_moe.GROUP_TOKENS == 0 else 1
        G = B * per_row
    else:
        G = num_groups
    tg = T // G
    C = ref_moe.expert_capacity(tg, E, K, cfg.moe_capacity_factor)
    xt = jnp.asarray(x).reshape(G, tg, D)
    logits = jnp.einsum("gtd,de->gte", xt, jnp.asarray(params["router"]).astype(xt.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, sel = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(sel, E, dtype=jnp.int32)
    slot_flat = onehot.reshape(G, tg * K, E)
    pos = (jnp.cumsum(slot_flat, axis=1) * slot_flat - 1).reshape(G, tg, K, E)
    within = (pos >= 0) & (pos < C)
    return np.asarray(sel), np.asarray(pos), np.asarray(within), C


def _moe_params(jcfg, rng, router_scale: float = 1.0) -> dict:
    """Normal weights over the square root of their contracted dim (the
    router's times ``router_scale``)."""
    out = {}
    for k, s in ref_moe.abstract_params(jcfg).items():
        fan_in = s.shape[0] if k == "router" else s.shape[1]
        out[k] = (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
    out["router"] *= router_scale
    return out


# (arch, batch, seq, num_groups, num_experts or None): the reference's groups
# (one per batch row), one group, and decode's shape at 8 experts (C = 5)
MOE_CASES = {
    "mixtral-groups": ("mixtral-8x7b", 2, 32, None, None),
    "mixtral-one-group": ("mixtral-8x7b", 2, 32, 1, None),
    "mixtral-decode-8e": ("mixtral-8x7b", 16, 1, 1, 8),
    "grok-groups": ("grok-1-314b", 2, 32, None, None),
    "grok-one-group": ("grok-1-314b", 2, 32, 1, None),
    "grok-decode-8e": ("grok-1-314b", 16, 1, 1, 8),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference(case):
    arch, B, S, ng, experts = MOE_CASES[case]
    jcfg = ref_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if experts:
        jcfg, cfg = jcfg.with_(num_experts=experts), replace(cfg, num_experts=experts)
    rng = np.random.default_rng(10)
    params = _moe_params(jcfg, rng, router_scale=4.0)
    # a direction common to every token that expert 0's router column
    # favours: the load skews onto expert 0 and capacity drops tokens
    u = rng.standard_normal(cfg.d_model).astype(np.float32)
    x = (rng.standard_normal((B, S, cfg.d_model)) + u).astype(np.float32)
    params["router"][:, 0] += 2.0 * u / np.linalg.norm(u)
    tp = {k: _t(v) for k, v in params.items()}

    r = moe.route(tp, _t(x), cfg, ng)
    sel, pos, within, C = _ref_routing(params, x, jcfg, ng)
    assert r.C == C
    np.testing.assert_array_equal(r.sel.numpy(), sel)
    np.testing.assert_array_equal(r.pos_in_expert.numpy(), pos)
    np.testing.assert_array_equal(r.within_cap.numpy(), within)
    routed = r.onehot.numpy().astype(bool)
    assert (routed & ~within).any(), "the case should drop tokens"

    out, aux = moe.apply(tp, _t(x), cfg, num_groups=ng)
    want_out, want_aux = ref_moe.apply(_j(params), jnp.asarray(x), jcfg, num_groups=ng)
    _close(out, want_out, **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MOE_TOL)


def test_moe_ties_route_to_the_lower_index():
    """A zero router gives every expert the same probability: both top-2
    slots go to experts 0 and 1, in that order, as jax.lax.top_k gives
    them; a router whose columns 1 and 3 are equal and largest picks 1
    before 3."""
    jcfg = ref_get_config("mixtral-8x7b").reduced()
    cfg = get_config("mixtral-8x7b").reduced()
    rng = np.random.default_rng(11)
    params = _moe_params(jcfg, rng)
    x = np.abs(rng.standard_normal((2, 8, cfg.d_model))).astype(np.float32)
    params["router"][:] = 0.0
    r = moe.route({k: _t(v) for k, v in params.items()}, _t(x), cfg)
    assert (r.sel.numpy() == np.array([0, 1])).all()
    np.testing.assert_array_equal(r.sel.numpy(), _ref_routing(params, x, jcfg, None)[0])
    params["router"][:, 1] = params["router"][:, 3] = 1.0
    r = moe.route({k: _t(v) for k, v in params.items()}, _t(x), cfg)
    assert (r.sel.numpy() == np.array([1, 3])).all()
    np.testing.assert_array_equal(r.sel.numpy(), _ref_routing(params, x, jcfg, None)[0])
    out, _ = moe.apply({k: _t(v) for k, v in params.items()}, _t(x), cfg)
    want, _ = ref_moe.apply(_j(params), jnp.asarray(x), jcfg)
    _close(out, want, **MOE_TOL)


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

def _ssm_params(jcfg, rng) -> dict:
    """Matrices normal over the square root of their fan-in; the vectors
    (A_log, dt_bias, D, norm, conv_b, zeros or ones at init) perturbed so
    that each takes part."""
    out = {}
    for k, s in ref_ssm.abstract_params(jcfg).items():
        if len(s.shape) == 1:
            out[k] = (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
        elif k == "conv_w":
            out[k] = (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ssm_case():
    jcfg = ref_get_config("mamba2-780m").reduced()
    cfg = get_config("mamba2-780m").reduced()
    return jcfg, cfg, _ssm_params(jcfg, np.random.default_rng(12))


@pytest.mark.parametrize("seq,chunk", [(32, 8), (256, 128)])
def test_ssd_apply_matches_reference(ssm_case, seq, chunk):
    jcfg, cfg, params = ssm_case
    x = (0.5 * np.random.default_rng(13).standard_normal((2, seq, cfg.d_model))).astype(np.float32)
    out, cache = ssm.apply({k: _t(v) for k, v in params.items()}, _t(x), cfg, chunk=chunk)
    want, want_cache = ref_ssm.apply(_j(params), jnp.asarray(x), jcfg, chunk=chunk)
    _close(out, want, **SSM_TOL)
    for k in ("conv", "state"):
        _close(cache[k], want_cache[k], **SSM_TOL)


def test_ssd_decode_matches_reference_in_place(ssm_case):
    """Three decode steps from a random cache: out, conv and state equal the
    reference's; the port's cache tree holds the same tensors throughout."""
    jcfg, cfg, params = ssm_case
    rng = np.random.default_rng(14)
    B = 3
    conv = rng.standard_normal((B, cfg.ssm_conv - 1, ssm.conv_dim(cfg))).astype(np.float32)
    state = (0.5 * rng.standard_normal((B, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state))).astype(np.float32)
    cache = {"conv": _t(conv), "state": _t(state)}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    jcache = {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}
    tp = {k: _t(v) for k, v in params.items()}
    for _ in range(3):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        out, got = ssm.decode(tp, _t(x), cache, cfg)
        want, jcache = ref_ssm.decode(_j(params), jnp.asarray(x), jcache, jcfg)
        assert got is cache and {k: v.data_ptr() for k, v in got.items()} == ptrs
        _close(out, want, **SSM_TOL)
        for k in ("conv", "state"):
            _close(cache[k], jcache[k], **SSM_TOL)


def test_ssd_gradient_stays_finite_where_the_reference_overflows(ssm_case):
    """The port masks the decay exponent before the ``exp``; the reference
    masks after it. With dt near 3 a chunk of 32 sums the exponent above the
    diagonal past f32's ``exp`` range: the outputs still agree, the
    reference's gradient is NaN (``0·inf``), the port's is finite."""
    jcfg, cfg, params = ssm_case
    params = {**params, "dt_bias": np.full_like(params["dt_bias"], 3.0), "A_log": np.zeros_like(params["A_log"])}
    x = (0.5 * np.random.default_rng(17).standard_normal((2, 32, cfg.d_model))).astype(np.float32)
    fwd = jax.jit(lambda p, x: ref_ssm.apply(p, x, jcfg)[0])
    want = fwd(_j(params), jnp.asarray(x))
    want_grad = jax.jit(jax.grad(lambda p, x: fwd(p, x).sum(), argnums=1))(_j(params), jnp.asarray(x))
    assert not np.isfinite(np.asarray(want_grad)).all()
    xt = _t(x).requires_grad_()
    out, _ = ssm.apply({k: _t(v) for k, v in params.items()}, xt, cfg)
    (grad,) = torch.autograd.grad(out.sum(), xt)
    _close(out, want, **SSM_TOL)
    assert torch.isfinite(grad).all()


def test_ssd_chunked_matches_sequential(ssm_case):
    """The chunked SSD dual form equals the token-by-token recurrence (the
    state-space duality itself)."""
    _, cfg, _ = ssm_case
    params = init_tree(threefry.PRNGKey(0), ssm.abstract_params(cfg), "cpu")
    x = 0.3 * torch.from_numpy(np.random.default_rng(15).standard_normal((2, 32, cfg.d_model)).astype(np.float32))
    out_chunk, cache = ssm.apply(params, x, cfg, chunk=8)
    c = {"conv": torch.zeros((2, cfg.ssm_conv - 1, ssm.conv_dim(cfg))),
         "state": torch.zeros((2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state))}
    outs = [ssm.decode(params, x[:, t : t + 1], c, cfg)[0] for t in range(32)]
    out_seq = torch.cat(outs, dim=1)
    np.testing.assert_allclose(out_chunk.numpy(), out_seq.numpy(), rtol=0, atol=2e-4)
    np.testing.assert_allclose(cache["state"].numpy(), c["state"].numpy(), rtol=0, atol=2e-3)


def test_mamba_decode_step_writes_the_stacked_cache_in_place():
    """``lm.decode_step`` on a two-period Mamba stack: every cache leaf is
    the same tensor after the step, its bytes changed, and the step equals
    one from a copy of the cache."""
    cfg = replace(get_config("mamba2-780m").reduced(), num_layers=2)
    model = build_model(cfg)
    params = model.init(threefry.PRNGKey(0), "cpu")
    cache = model.init_cache(2, 8, "cpu")
    leaves = tree_flatten(cache)[1]
    before = [x.clone() for x in leaves]
    tok = torch.tensor([3, 5])
    with torch.no_grad():
        logits, out = model.decode_step(params, cache, tok, torch.tensor(0))
        copy = tree_unflatten(tree_flatten(cache)[0], [x.clone() for x in before])
        logits2, _ = model.decode_step(params, copy, tok, torch.tensor(0))
    assert out is cache
    assert all(a is b for a, b in zip(tree_flatten(out)[1], leaves))
    assert all(not torch.equal(a, b) for a, b in zip(leaves, before))
    assert torch.equal(logits, logits2)
    for a, b in zip(tree_flatten(copy)[1], leaves):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the reduced models' loss and gradient
# ---------------------------------------------------------------------------

LOSS_ARCHS = ("gemma2-2b", "jamba-1.5-large-398b", "mamba2-780m", "mixtral-8x7b")


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Reduced params (norm scales and the SSM's vectors perturbed off their
    constants), a batch of 8 x 32 tokens: the loss, the MoE aux loss and
    every gradient leaf against the reference's. (At 64 tokens a chunk is
    64 long and the reference's gradient of the jamba stack overflows to
    NaN: see the test above.)"""
    jcfg = ref_get_config(arch).reduced()
    ref = ref_build_model(jcfg)
    rng = np.random.default_rng(16)
    params = jax.device_get(ref.init(jax.random.PRNGKey(0)))
    params = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype), params)
    tokens = rng.integers(0, jcfg.vocab_size, (8, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    fn = jax.jit(jax.value_and_grad(lambda p, b: ref.loss(p, b), has_aux=True))
    (want_loss, want_metrics), want_grads = fn(params, _j(batch))

    model = build_model(get_config(arch).reduced())
    paths, leaves = tree_flatten(state_from_numpy(params, device="cpu"))
    leaves = [x.requires_grad_() for x in leaves]
    loss, metrics = model.loss(tree_unflatten(paths, leaves), {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["moe_aux"].detach()), float(want_metrics["moe_aux"]), rtol=1e-5)
    assert (float(metrics["moe_aux"].detach()) > 0) == model.cfg.has_moe
    want_paths, want = [], []
    for path, g in jax.tree_util.tree_flatten_with_path(jax.device_get(want_grads))[0]:
        want_paths.append(tuple(k.key for k in path))
        want.append(g)
    assert want_paths == paths
    for p, g, w in zip(paths, grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6, err_msg="/".join(p))
