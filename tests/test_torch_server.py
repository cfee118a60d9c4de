"""The port's serving path against the JAX package's, on the CPU, in f32.

Reduced llama3.2-1b: the reference's params (``PRNGKey(1)``) carried across
with ``state_from_numpy``, the same prompts. First the model's decode path:
prefill logits and cache and three ``decode_step`` logits against
``repro.models`` at the blocks' tolerance (rtol 1e-5, atol 1e-6), the
attention decode layer alone (global and sliding-window), and the session
``ShardPlan`` against the reference server's. Then each case of
tests/test_server.py on the port's ``Server``: the generated tokens must
equal both the port's fault-free run and the reference ``Server``'s tokens
(run in-process, fault-free, once); its encoder case, a ``Server`` on the
reduced hubert-xlarge refused (the port raises ``ValueError`` where the
reference asserts), and the serve CLI's exit on it. Then the elastic policy 4 -> 3 -> 2, the metrics endpoint against the engine's stats
(tests/test_obs.py), and the serve CLI.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from dataclasses import astuple, replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.core import storage
from repro_torch.core.checkpoint import EngineConfig
from repro_torch.launch import serve
from repro_torch.launch.steps import state_from_numpy, state_to_numpy
from repro_torch.models import attention, build_model
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.utils.pytree import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
BLOCK_TOL = dict(rtol=1e-5, atol=1e-6)
SERVE = dict(batch=4, max_seq=40, checkpoint_every_tokens=6)  # tests/test_server.py's
GEN = 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops run faster on one thread than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = ref_get_config("llama3.2-1b").reduced()
    ref_model = ref_build_model(jcfg)
    params = jax.device_get(ref_model.init(jax.random.PRNGKey(1)))
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 8), dtype=np.int32)
    model = build_model(get_config("llama3.2-1b").reduced())
    return ref_model, params, model, prompts


@pytest.fixture(scope="module")
def ref_tokens(setup):
    """The reference Server's fault-free tokens."""
    from repro.runtime.server import Server as RefServer, ServerConfig as RefServerConfig

    ref_model, params, _, prompts = setup
    srv = RefServer(ref_model, RefServerConfig(**SERVE), params=params)
    out = np.asarray(srv.prefill_and_decode(prompts, GEN))
    srv.engine.close()
    return out


def _serve(setup, injector=None, **cfg_kw):
    _, params, model, prompts = setup
    s = Server(model, ServerConfig(**{**SERVE, **cfg_kw}), params=state_from_numpy(params, device="cpu"),
               injector=injector, device="cpu")
    out = s.prefill_and_decode(prompts, GEN)
    s.close()
    return s, out


@pytest.fixture(scope="module")
def clean(setup, ref_tokens):
    _, out = _serve(setup)
    assert np.array_equal(out, ref_tokens)
    return out


# ---------------------------------------------------------------------------
# the model's decode path
# ---------------------------------------------------------------------------

def test_prefill_and_decode_steps_match_reference(setup):
    ref_model, params, model, prompts = setup
    jl, jcache = jax.jit(lambda p, t: ref_model.prefill(p, tokens=t))(params, jnp.asarray(prompts))
    tp = state_from_numpy(params, device="cpu")
    with torch.no_grad():
        logits, cache = model.prefill(tp, torch.from_numpy(prompts))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **BLOCK_TOL)
    paths, leaves = tree_flatten(cache)
    for p, leaf in zip(paths, leaves):
        want = np.asarray(jcache[p[0]][p[1]])
        assert tuple(leaf.shape) == want.shape
        np.testing.assert_allclose(leaf.numpy(), want, **BLOCK_TOL, err_msg="/".join(p))

    max_seq = 16
    full = model.init_cache(4, max_seq, "cpu")
    for f, part in zip(tree_flatten(full)[1], leaves):
        f[:, :, : part.shape[2]] = part
    jfull = jax.tree.map(lambda f, c: f.at[tuple(slice(0, s) for s in c.shape)].set(c),
                         ref_model.init_cache(4, max_seq), jcache)
    step = jax.jit(ref_model.decode_step)
    tok, pos = np.argmax(np.asarray(jl), -1).astype(np.int32), prompts.shape[1]
    for _ in range(3):
        jl, jfull = step(params, jfull, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            logits, out = model.decode_step(tp, full, torch.from_numpy(tok), torch.tensor(pos, dtype=torch.int32))
        assert out is full  # written in place
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **BLOCK_TOL)
        tok, pos = np.argmax(np.asarray(jl), -1).astype(np.int32), pos + 1
    for p, leaf in zip(*tree_flatten(full)):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jfull[p[0]][p[1]]), **BLOCK_TOL)
        assert not leaf[:, :, pos:].any()  # nothing written past the last token


@pytest.mark.parametrize("kind", ["attn", "local"])
def test_attention_decode_matches_reference(kind):
    """One layer's decode over a half-filled cache of 48 with a window of 8
    (so the local layer masks most of it), at two positions."""
    jcfg = ref_get_config("llama3.2-1b").reduced().with_(sliding_window=8)
    cfg = replace(get_config("llama3.2-1b").reduced(), sliding_window=8)
    rng = np.random.default_rng(7)
    specs = ref_attention.abstract_params(jcfg)
    params = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32) for k, s in specs.items()}
    B, S, KV, D = 2, 48, cfg.num_kv_heads, cfg.resolved_head_dim
    k = np.zeros((B, S, KV, D), np.float32)
    v = np.zeros((B, S, KV, D), np.float32)
    k[:, :24] = rng.standard_normal((B, 24, KV, D))
    v[:, :24] = rng.standard_normal((B, 24, KV, D))
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    tparams = {n: torch.from_numpy(a) for n, a in params.items()}
    for pos in (24, 25):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jcache = ref_attention.decode(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcache,
                                            jnp.asarray(pos, jnp.int32), jcfg, kind=kind)
        got, cache = attention.decode(tparams, torch.from_numpy(x), cache, torch.tensor(pos, dtype=torch.int32),
                                      cfg, kind=kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]), **BLOCK_TOL)


@pytest.mark.parametrize("batch", [4, 16])
def test_session_plan_matches_reference(setup, batch):
    """The session ShardPlan from the production decode rules: split dims,
    shapes and every rank's shard coordinates equal the reference
    server's, over 4 ranks and over 3 (which 16 does not divide)."""
    from repro.runtime.server import Server as RefServer, ServerConfig as RefServerConfig

    ref_model, params, model, _ = setup
    scfg = dict(batch=batch, max_seq=32)
    ref = RefServer(ref_model, RefServerConfig(**scfg), params=params)
    port = Server(model, ServerConfig(**scfg), params=state_from_numpy(params, device="cpu"), device="cpu")
    assert port.plan.dims == ref.plan.dims and port.plan.shapes == ref.plan.shapes
    assert port.plan.dims[0] == (1 if batch == 16 else None)  # the cache's batch dim over "data"
    for n in (4, 3):
        assert [[astuple(c) for c in rank] for rank in port.plan.shard_coords(n)] == [
            [astuple(c) for c in rank] for rank in ref.plan.shard_coords(n)], n
        assert [port.plan.split_dim(i, n) for i in range(len(port.plan.dims))] == [
            ref.plan.split_dim(i, n) for i in range(len(ref.plan.dims))]
    ref.engine.close()
    port.close()


# ---------------------------------------------------------------------------
# tests/test_server.py on the port
# ---------------------------------------------------------------------------

def test_encoder_arch_rejected():
    model = build_model(get_config("hubert-xlarge").reduced())
    with pytest.raises(ValueError, match="encoder"):
        Server(model, ServerConfig(batch=2, max_seq=16), device="cpu")
    with pytest.raises(SystemExit, match="hubert-xlarge-reduced is encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])


def test_fault_free_run_matches_reference_server(clean, ref_tokens):
    assert clean.dtype == np.int32 and clean.shape == (4, SERVE["max_seq"])
    assert np.array_equal(clean, ref_tokens)


def test_generation_identical_after_faults(setup, clean):
    s, out = _serve(setup, FailureInjector(4, schedule={9: [2], 17: [0]}))
    assert s.n_recoveries == 2
    assert np.array_equal(out, clean)


def test_sessions_survive_failure_burst(setup, clean):
    s, out = _serve(setup, FailureInjector(4, schedule={10: [1], 11: [2]}))
    assert np.array_equal(out, clean)


def test_async_checkpoint_mode_identical(setup, clean):
    s, out = _serve(setup, checkpoint_mode="async")
    assert np.array_equal(out, clean)
    assert s.engine.stats.created >= 1
    s, out = _serve(setup, FailureInjector(4, schedule={9: [2]}), checkpoint_mode="async")
    assert s.n_recoveries == 1
    assert np.array_equal(out, clean)


def test_whole_job_loss_escalates_to_tier_ladder(setup, clean, tmp_path):
    s, out = _serve(setup, FailureInjector(4, schedule={9: [0, 1, 2, 3]}),
                    engine=EngineConfig(tiers=(storage.disk(str(tmp_path / "tier"), every=1),)))
    assert s.n_recoveries >= 1
    assert s.engine.stats.tier_escalations >= 1
    assert np.array_equal(out, clean)


def test_elastic_serving_shrinks_and_spares_run_dry(setup, clean):
    """recovery_policy="elastic" with no spares: 4 -> 3 -> 2, the sessions
    repartitioned onto the survivors at each kill; and the spare policy with
    one spare falls back to the elastic shrink at the second kill."""
    s, out = _serve(setup, FailureInjector(4, schedule={5: [3], 13: [0]}), recovery_policy="elastic", n_spares=0)
    assert np.array_equal(out, clean)
    assert s.n_recoveries == 2 and s.cluster.n_ranks == s.engine.n_ranks == 2
    assert [e["n_new"] for e in s.engine.journal.events("resize")] == [3, 2]
    s, out = _serve(setup, FailureInjector(4, schedule={5: [3], 13: [0]}), n_spares=1)
    assert np.array_equal(out, clean)
    assert s.n_recoveries == 2 and s.engine.n_ranks == 3


def test_metrics_endpoint_agrees_with_stats(setup):
    """tests/test_obs.py's endpoint case on the port: /metrics and
    /metrics.json render the live engine's registry; other paths 404."""
    s, _ = _serve(setup, FailureInjector(4, schedule={9: [2]}))
    srv = s.start_metrics_server(port=0)
    try:
        assert s.start_metrics_server() is srv
        with urllib.request.urlopen(srv.url) as r:
            assert r.status == 200
            text = r.read().decode()
        assert f"ckpt_created_total {s.engine.stats.created}" in text
        assert f"restore_total {s.engine.stats.restored}" in text
        assert "# TYPE ckpt_stage_seconds histogram" in text
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics.json") as r:
            snap = json.load(r)
        assert snap["ckpt_created_total"] == s.engine.stats.created
        assert snap == s.engine.registry.snapshot()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope")
        assert e.value.code == 404
    finally:
        s.stop_metrics_server()
    assert s._metrics_server is None


def test_serve_cli_recovers_bitwise():
    """``repro_torch.launch.serve --device cpu --reduced --kill-at 10:2``
    gives the fault-free run's tokens; ``python -m`` runs it too."""
    args = ["--device", "cpu", "--reduced", "--gen", "20"]
    clean = serve.main(args)
    faulted = serve.main(args + ["--kill-at", "10:2", "--checkpoint-mode", "async"])
    assert np.array_equal(clean, faulted)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args, "--kill-at", "10:2"],
                          capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "1 recoveries" in proc.stderr


def test_elastic_serving_example():
    """examples/elastic_serving_torch.py on the CPU: spare substitution, then
    the elastic shrink 4 -> 3 -> 2, both bit-identical to the clean run."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "elastic_serving_torch.py"), "--device", "cpu",
                           "--reduced"], capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "final world size: 2" in proc.stdout and proc.stdout.rstrip().endswith("OK")


def test_serving_on_cuda_without_a_card_raises(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, model, _ = setup
    with pytest.raises(RuntimeError):
        Server(model, ServerConfig(**SERVE))


def test_tokens_cross_back_unchanged(setup, clean):
    """The returned tokens are the session tensor's bytes (int32), in a copy:
    later writes to the live sessions leave them as they were."""
    s, out = _serve(setup)
    assert np.array_equal(state_to_numpy(s.sessions["tokens"]), out)
    assert int(s.sessions["pos"]) == 8 + GEN
    s.sessions["tokens"].fill_(-1)
    assert np.array_equal(out, clean)
