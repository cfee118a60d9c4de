"""The port's model zoo on the CPU: every config against the JAX package's,
and the twins of ``tests/test_models.py`` for all ten archs (dense, MoE,
Mamba-2, the hybrid, the encoder and the VLM) at their reduced size.

* Configs: all ten registered, every field equal to the reference's (dtypes
  by name), their derived properties and reduced forms too; the input
  shapes and the (arch x shape) applicability matrix.
* Declarations: ``abstract_params`` of every reduced config equal to the
  reference's (paths, shapes, logical dims, init rules, dtypes). At full
  width, the parameter and active-parameter counts equal the reference's.
* ``tests/test_models.py``'s smoke train step and forward shapes (all ten),
  decode against prefill (the nine decoding archs; err < 5e-4; MoE
  dropless), the sliding window (mixtral), vocab padding (granite) and the
  MoE aux loss. The encoder's inputs are frames (and its loss masked
  prediction), the VLM's tokens and a vision stub.
* ``launch/train.py`` on the reduced mixtral through a kill against its
  clean run (and the reference's CLI), and
  ``examples/fault_tolerance_demo_torch.py --device cpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import fields, replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as REF_CONFIGS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import applicability as ref_applicability
from repro.configs import runnable_cells as ref_runnable_cells
from repro.models import build_model as ref_build_model
from repro.models import lm as ref_lm
from repro_torch.configs import CONFIGS, SHAPES, applicability, list_archs, runnable_cells
from repro_torch.models import build_model, lm
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.utils import threefry
from repro_torch.utils.pytree import tree_flatten, tree_leaves, tree_unflatten

ARCHS = list_archs()
DECODING = [a for a in ARCHS if not CONFIGS[a].is_encoder]  # all but the encoder


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops run faster on one thread than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _value(v):
    """A field's value, dtypes by name (jnp.bfloat16 and torch.bfloat16 alike)."""
    if isinstance(v, torch.dtype):
        return str(v).split(".")[-1]
    if isinstance(v, type) and hasattr(v, "dtype"):
        return np.dtype(v).name
    return v


def _fields(cfg) -> dict:
    return {f.name: _value(getattr(cfg, f.name)) for f in fields(cfg)}


def test_every_reference_config_is_registered():
    assert list_archs() == sorted(REF_CONFIGS) and len(CONFIGS) == 10
    assert [a for a in ARCHS if a not in DECODING] == ["hubert-xlarge"]


@pytest.mark.parametrize("arch", sorted(REF_CONFIGS))
def test_config_matches_reference(arch):
    for cfg, ref in ((CONFIGS[arch], REF_CONFIGS[arch]), (CONFIGS[arch].reduced(), REF_CONFIGS[arch].reduced())):
        assert _fields(cfg) == _fields(ref)
        for prop in ("resolved_head_dim", "padded_vocab", "period", "num_periods", "attention_free",
                     "subquadratic", "has_moe", "d_inner", "ssm_heads"):
            assert getattr(cfg, prop) == getattr(ref, prop), prop
    assert _fields(CONFIGS[arch].with_(moe_mode="ep", sliding_window=7)) == _fields(
        REF_CONFIGS[arch].with_(moe_mode="ep", sliding_window=7))


def test_shapes_and_applicability_match_reference():
    assert {k: vars(v) for k, v in SHAPES.items()} == {k: vars(v) for k, v in REF_SHAPES.items()}
    for arch in list_archs():
        for name in SHAPES:
            assert applicability(CONFIGS[arch], SHAPES[name]) == ref_applicability(REF_CONFIGS[arch],
                                                                                 REF_SHAPES[name]), (arch, name)
    assert runnable_cells(CONFIGS) == ref_runnable_cells(REF_CONFIGS)
    assert SHAPES["train_4k"].tokens == 4_096 * 256


def _ref_specs(tree):
    out = []
    for path, s in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda s: hasattr(s, "dims"))[0]:
        out.append((tuple(k.key for k in path), s))
    return out


@pytest.mark.parametrize("arch", sorted(REF_CONFIGS))
def test_abstract_params_match_reference(arch):
    ref = ref_lm.abstract_params(REF_CONFIGS[arch].reduced())
    paths, specs = tree_flatten(lm.abstract_params(CONFIGS[arch].reduced()))
    want = _ref_specs(ref)
    assert paths == [p for p, _ in want]
    for p, a, (_, b) in zip(paths, specs, want):
        assert (a.shape, a.dims, a.init, a.scale) == (b.shape, b.dims, b.init, b.scale), p
        assert str(a.dtype).split(".")[-1] == np.dtype(b.dtype).name, p


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_counts_match_reference(arch):
    model, ref = build_model(CONFIGS[arch]), ref_build_model(REF_CONFIGS[arch])
    assert model.n_params == ref.n_params == lm.param_count(CONFIGS[arch])
    assert model.n_active_params == ref.n_active_params
    assert (model.n_active_params < model.n_params) == CONFIGS[arch].has_moe


def _params(cfg, seed: int = 0):
    return build_model(cfg).init(threefry.PRNGKey(seed), "cpu")


def _tokens(cfg, B: int, S: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))


def _inputs(cfg, B: int, S: int, seed: int = 0) -> dict:
    """The model's inputs, as ``tests/test_models.py`` makes them: frames for
    the encoder, tokens (and a vision stub for the VLM) for the others."""
    rng = np.random.default_rng(seed + 100)
    if cfg.is_encoder:
        return {"frames": torch.from_numpy(rng.standard_normal((B, S, cfg.frontend_stub_dim)).astype(np.float32))}
    out = {"tokens": _tokens(cfg, B, S, seed)}
    if cfg.vision_tokens:
        out["vision"] = torch.from_numpy(
            rng.standard_normal((B, cfg.vision_tokens, cfg.frontend_stub_dim)).astype(np.float32))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    """One forward + backward + AdamW step on the reduced config (the
    encoder's masked prediction over every position)."""
    cfg = CONFIGS[arch].reduced()
    model = build_model(cfg)
    params = _params(cfg)
    batch = {**_inputs(cfg, 2, 32), "labels": _tokens(cfg, 2, 32, seed=1)}
    if cfg.is_encoder:
        batch["mask"] = torch.ones((2, 32), dtype=torch.bool)
    paths, live = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in live]
    loss, _ = model.loss(tree_unflatten(paths, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    before = [p.clone() for p in live]
    opt = init_opt_state(params)
    adamw_update(tree_unflatten(paths, list(grads)), params, opt, torch.zeros((), dtype=torch.int32),
                 AdamWConfig(lr=1e-3))
    assert torch.isfinite(loss) and float(loss.detach()) > 0, arch
    for old, new in zip(before, tree_leaves(params)):
        assert old.shape == new.shape and not torch.isnan(new).any()
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_shapes(arch):
    cfg = CONFIGS[arch].reduced()
    with torch.no_grad():
        logits, cache = build_model(cfg).prefill(_params(cfg), **_inputs(cfg, 2, 32))
    assert not torch.isnan(logits).any()
    if cfg.is_encoder:  # every position's logits, no cache
        assert tuple(logits.shape) == (2, 32, cfg.padded_vocab) and cache is None
        return
    assert tuple(logits.shape) == (2, cfg.padded_vocab)
    assert cache is not None and set(cache) == {f"slot{j}" for j in range(cfg.period)}
    for j, kind in enumerate(cfg.layer_pattern):
        assert set(cache[f"slot{j}"]) == ({"conv", "state"} if kind == "mamba" else {"k", "v"})
        if kind == "cross":
            assert cache[f"slot{j}"]["k"].shape[2] == cfg.vision_tokens


@pytest.mark.parametrize("arch", DECODING)
def test_decode_matches_prefill(arch):
    """The decode step at position S-1 reproduces prefill's logits."""
    cfg = CONFIGS[arch].reduced()
    if cfg.has_moe:
        cfg = cfg.with_(moe_capacity_factor=100.0)  # dropless for exactness
    model = build_model(cfg)
    params = _params(cfg)
    B, S = 2, 32
    inputs = _inputs(cfg, B, S)
    toks = inputs.pop("tokens")
    with torch.no_grad():
        logits_full, _ = model.prefill(params, toks, **inputs)
        _, prefix = model.prefill(params, toks[:, : S - 1], **inputs)
        cache = model.init_cache(B, S, "cpu")
        for full, part in zip(tree_leaves(cache), tree_leaves(prefix)):
            full[tuple(slice(0, n) for n in part.shape)] = part
        logits_dec, _ = model.decode_step(params, cache, toks[:, S - 1], torch.tensor(S - 1))
    err = float((logits_dec - logits_full).abs().max())
    assert err < 5e-4, (arch, err)


def test_sliding_window_restricts_attention():
    """A token beyond the window does not influence a local-attention layer."""
    cfg = CONFIGS["mixtral-8x7b"].reduced().with_(
        sliding_window=4, num_layers=1, layer_pattern=("local",), num_experts=0, experts_per_tok=0, d_ff=64)
    model, params = build_model(cfg), _params(cfg)
    toks = _tokens(cfg, 1, 16)
    toks2 = toks.clone()
    toks2[:, 0] = (toks[:, 0] + 1) % cfg.vocab_size  # a distant change
    with torch.no_grad():
        l1, _ = model.prefill(params, toks)
        l2, _ = model.prefill(params, toks2)
        # with a global window the same change shows at the last position
        glob = cfg.with_(layer_pattern=("attn",))
        g1, _ = build_model(glob).prefill(params, toks)
        g2, _ = build_model(glob).prefill(params, toks2)
    # the last position attends only to [12..15]: the logits are identical
    assert torch.allclose(l1, l2, atol=1e-5)
    assert not torch.allclose(g1, g2, atol=1e-6)


def test_vocab_padding_masked():
    cfg = CONFIGS["granite-3-8b"].reduced().with_(vocab_size=200)  # padded to 256
    with torch.no_grad():
        logits, _ = build_model(cfg).prefill(_params(cfg), _tokens(cfg, 1, 8))
    assert logits.shape[-1] == 256
    assert (logits[..., 200:] < -1e29).all()


def test_moe_aux_loss():
    """The reduced mixtral's load-balance loss is positive and enters the
    loss with weight 0.01, averaged over the layers."""
    cfg = CONFIGS["mixtral-8x7b"].reduced()
    model, params = build_model(cfg), _params(cfg)
    batch = {"tokens": _tokens(cfg, 2, 32), "labels": _tokens(cfg, 2, 32, seed=1)}
    with torch.no_grad():
        loss, metrics = model.loss(params, batch)
    assert float(metrics["moe_aux"]) > 0.0
    torch.testing.assert_close(loss, metrics["ce_loss"] + 0.01 * metrics["moe_aux"], rtol=0, atol=0)
    dense = replace(cfg, num_experts=0, experts_per_tok=0)
    assert lm.active_param_count(dense) == lm.param_count(dense)


# ---------------------------------------------------------------------------
# the train CLI and the fault-tolerance demo
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]
# launch/train.py's defaults but a fixed period (the Daly-optimal one of the
# defaults takes no checkpoint within 12 steps)
CLI = ["--arch", "mixtral-8x7b", "--reduced", "--steps", "12", "--period", "4"]


def _run(args: list[str], env_extra: dict | None = None) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1", **(env_extra or {})}
    proc = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_train_cli_recovers_to_the_clean_run(tmp_path):
    """``python -m repro_torch.launch.train ... --kill-at 6:2``: one
    recovery, steps 4 and 5 replayed, every loss and the final state equal
    to a clean run's (``main`` in-process); the reference's CLI on the same
    arguments gives the clean run's losses within rtol 1e-3. (Not the 1e-4
    of the dense trajectories: capacity drops a few hundred of the 2,048
    routed slots per step, AdamW turns the two packages' rounding of
    near-zero gradients into updates of up to lr/4 in a few expert weights,
    and from step 5 on the losses differ by up to 2e-4 relative.)"""
    from repro_torch.launch import train

    out = tmp_path / "H.json"
    _run(["-m", "repro_torch.launch.train", *CLI, "--device", "cpu", "--kill-at", "6:2", "--out", str(out)])
    killed = json.loads(out.read_text())
    clean = train.main([*CLI, "--device", "cpu"])
    assert killed["n_recoveries"] == 1 and clean["n_recoveries"] == 0
    assert [h["step"] for h in killed["history"]] == [0, 1, 2, 3, 4, 5, 4, 5, *range(6, 12)]
    by_step = {h["step"]: h["loss"] for h in clean["history"]}
    assert all(h["loss"] == by_step[h["step"]] for h in killed["history"])
    assert all(h["moe_aux"] > 0 for h in killed["history"])
    assert killed["state_sha256"] == clean["state_sha256"]

    ref_out = tmp_path / "ref.json"
    _run(["-m", "repro.launch.train", *CLI, "--out", str(ref_out)], {"JAX_PLATFORMS": "cpu"})
    ref = json.loads(ref_out.read_text())["history"]
    assert [h["step"] for h in ref] == list(range(12))
    np.testing.assert_allclose([by_step[h["step"]] for h in ref], [h["loss"] for h in ref], rtol=1e-3)


def test_fault_tolerance_demo_runs_on_the_cpu():
    proc = _run([str(ROOT / "examples" / "fault_tolerance_demo_torch.py"), "--device", "cpu"])
    assert "final state bitwise-identical to fault-free run: True" in proc.stdout
    assert proc.stdout.rstrip().endswith("OK")
