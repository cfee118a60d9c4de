"""The port's fault-tolerant Trainer and Server on the encoder and VLM
families (reduced, f32, on the CPU), both CLIs, and ``compressed_psum``.

* hubert-xlarge's ``Trainer`` (masked prediction over frame embeddings)
  through a kill: one recovery, every loss and the final state bit-equal to
  the clean run's. The reference's ``Trainer`` runs the same case
  in-process from the same seed: the port's batches equal its batches
  (labels and mask byte for byte, frames within 3 ulp), its initial state
  within 4 ulp, the shard plan equal; losses within rtol 1e-4.
* llama-3.2-vision-90b's ``Server`` on the reference's params and the same
  vision array: its tokens equal the reference ``Server``'s, clean and
  through a kill, and the killed run's sessions (the cross cache included)
  end bit-equal to the clean run's; the session plan equals the
  reference server's.
* The train CLI on ``hubert-xlarge --reduced`` through a kill against its
  clean run and the reference's CLI (losses within rtol 1e-4); the serve
  CLI on ``llama-3.2-vision-90b --reduced`` through a kill against the
  reference's CLI: the vision stubs both draw from ``PRNGKey(0)`` within
  3 ulp, the logged tokens equal.
* ``compressed_psum`` over a 4-process gloo group against the reference's
  under ``shard_map`` over 4 CPU devices (``_torch_jax_oracle.py psum``):
  f32 and bf16 shards whose sizes are multiples of 8192. The two
  all-reduces may add the four ranks in different orders, so each element
  is held within 4 f32 ulp of the sum of the ranks' magnitudes there (the
  bf16 result within one bf16 ulp more); a ragged shard raises in both.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from dataclasses import astuple
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_jax_oracle as oracle
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.launch.steps import state_from_numpy, state_to_numpy
from repro_torch.models import build_model
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.utils import threefry
from repro_torch.utils.pytree import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
HUBERT, VLM = "hubert-xlarge", "llama-3.2-vision-90b"
STEPS = 12
CASE = dict(batch=4, seq=32, total_steps=STEPS, checkpoint_period=4, n_virtual_hosts=4)
KILLS = {6: [2]}
SERVE = dict(batch=4, max_seq=40, checkpoint_every_tokens=6)  # tests/test_server.py's
GEN = 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops run faster on one thread than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bitwise(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[1], tree_flatten(b)[1]))


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-(2**31)) - ia, ia)  # sign-magnitude to a monotone line
    ib = np.where(ib < 0, np.int64(-(2**31)) - ib, ib)
    return int(np.abs(ia - ib).max())


def _same_plan(port, ref, worlds=(4, 3, 8)) -> None:
    """Split dims, shapes and every rank's shard coordinates equal."""
    assert port.dims == ref.dims and port.shapes == ref.shapes
    for n in worlds:
        assert [[astuple(c) for c in rank] for rank in port.shard_coords(n)] == [
            [astuple(c) for c in rank] for rank in ref.shard_coords(n)], n


# ---------------------------------------------------------------------------
# the encoder's Trainer
# ---------------------------------------------------------------------------

def _train(kills: dict | None, **kw) -> Trainer:
    model = build_model(get_config(HUBERT).reduced())
    inj = FailureInjector(4, schedule=kills) if kills else None
    t = Trainer(model, TrainerConfig(**{**CASE, **kw}), injector=inj, device="cpu")
    t.run(STEPS)
    t.engine.close()
    return t


@pytest.fixture(scope="module")
def hubert_runs():
    return _train(None), _train(KILLS, n_spares=2)


def test_hubert_trainer_recovers_bitwise(hubert_runs):
    clean, killed = hubert_runs
    assert killed.n_recoveries == 1 and clean.n_recoveries == 0
    assert [h["step"] for h in killed.history] == [0, 1, 2, 3, 4, 5, 4, 5, *range(6, STEPS)]
    assert _bitwise(killed.state, clean.state)
    by_step = {h["step"]: h["loss"] for h in clean.history}
    assert all(h["loss"] == by_step[h["step"]] for h in killed.history)


def test_hubert_trainer_matches_reference(hubert_runs):
    from repro.runtime.failures import FailureInjector as RefInjector
    from repro.runtime.trainer import Trainer as RefTrainer, TrainerConfig as RefTrainerConfig

    _, port = hubert_runs
    ref = RefTrainer(ref_build_model(ref_get_config(HUBERT).reduced()), RefTrainerConfig(**CASE, n_spares=2),
                     injector=RefInjector(4, schedule=KILLS))
    init = {tuple(str(k.key) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jax.device_get(ref.state))[0]}
    fresh = Trainer(build_model(get_config(HUBERT).reduced()), TrainerConfig(**CASE), device="cpu")
    for step in range(STEPS):
        got, want = fresh.data.peek(step), ref.data.peek(step)
        assert set(got) == set(want) == {"frames", "labels", "mask"}
        assert _ulps(got["frames"].numpy(), np.asarray(want["frames"])) <= 3, step
        for k in ("labels", "mask"):
            assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes(), (step, k)
    for p, x in zip(*tree_flatten(state_to_numpy(fresh.state))):
        want = init[p]
        assert x.dtype == want.dtype and x.shape == want.shape, p
        if x.dtype == np.float32:
            assert np.abs(x.view(np.int32).astype(np.int64) - want.view(np.int32)).max() <= 4, p
        else:
            assert x.tobytes() == want.tobytes(), p
    _same_plan(fresh.plan, ref.plan)
    fresh.engine.close()
    hist = ref.run(STEPS)
    ref.engine.close()
    assert [h["step"] for h in port.history] == [h["step"] for h in hist]
    np.testing.assert_allclose([h["loss"] for h in port.history], [h["loss"] for h in hist], rtol=1e-4)
    assert port.n_recoveries == ref.n_recoveries == 1


# ---------------------------------------------------------------------------
# the VLM's Server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm_case():
    ref_model = ref_build_model(ref_get_config(VLM).reduced())
    params = jax.device_get(ref_model.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, ref_model.cfg.vocab_size, (4, 8), dtype=np.int32)
    vision = rng.standard_normal((4, ref_model.cfg.vision_tokens, ref_model.cfg.frontend_stub_dim)).astype(np.float32)
    return ref_model, params, prompts, vision


@pytest.mark.parametrize("batch", [4, 16])
def test_vlm_session_plan_matches_reference(vlm_case, batch):
    """The session ShardPlan, the cross slots' ``vision_tokens``-row cache
    among its leaves, equals the reference server's."""
    from repro.runtime.server import Server as RefServer, ServerConfig as RefServerConfig

    ref_model, params, _, _ = vlm_case
    ref = RefServer(ref_model, RefServerConfig(batch=batch, max_seq=32), params=params)
    port = Server(build_model(get_config(VLM).reduced()), ServerConfig(batch=batch, max_seq=32),
                  params=state_from_numpy(params, device="cpu"), device="cpu")
    _same_plan(port.plan, ref.plan)
    assert (batch, 16, 2, 16) in [s[1:] for s in port.plan.shapes]  # (periods, B, vision_tokens, KV, D)
    ref.engine.close()
    port.close()


def test_vlm_server_matches_reference_through_a_kill(vlm_case):
    from repro.runtime.server import Server as RefServer, ServerConfig as RefServerConfig

    ref_model, params, prompts, vision = vlm_case
    srv = RefServer(ref_model, RefServerConfig(**SERVE), params=params)
    want = np.asarray(srv.prefill_and_decode(prompts, GEN, vision=vision))
    srv.engine.close()

    model = build_model(get_config(VLM).reduced())
    outs, sessions = [], []
    for kills in ({}, {10: [2]}):
        s = Server(model, ServerConfig(**SERVE), params=state_from_numpy(params, device="cpu"),
                   injector=FailureInjector(4, schedule=kills), device="cpu")
        outs.append(s.prefill_and_decode(prompts, GEN, vision=vision))
        sessions.append(s.sessions)
        s.close()
        assert s.n_recoveries == len(kills)
    np.testing.assert_array_equal(outs[0], want)
    np.testing.assert_array_equal(outs[1], want)
    assert _bitwise(sessions[1], sessions[0])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

TRAIN_CLI = ["--arch", HUBERT, "--reduced", "--steps", "12", "--period", "4"]
SERVE_CLI = ["--arch", VLM, "--reduced", "--gen", "16"]


def _env(extra: dict | None = None) -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1", **(extra or {})}


def _start(args: list[str], env_extra: dict | None = None) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=_env(env_extra), cwd=ROOT)


def _wait(proc: subprocess.Popen) -> str:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return out + err


def test_train_cli_on_the_encoder(tmp_path):
    """``python -m repro_torch.launch.train --arch hubert-xlarge --reduced
    ... --kill-at 6:2``: one recovery, every loss and the final state equal
    to a clean run's (``main`` in-process); the reference's CLI on the same
    arguments gives the clean run's losses within rtol 1e-4."""
    from repro_torch.launch import train

    out, ref_out = tmp_path / "H.json", tmp_path / "ref.json"
    port = _start(["-m", "repro_torch.launch.train", *TRAIN_CLI, "--device", "cpu", "--kill-at", "6:2",
                   "--out", str(out)])
    ref = _start(["-m", "repro.launch.train", *TRAIN_CLI, "--out", str(ref_out)], {"JAX_PLATFORMS": "cpu"})
    clean = train.main([*TRAIN_CLI, "--device", "cpu"])
    _wait(port)
    _wait(ref)
    killed = json.loads(out.read_text())
    assert killed["n_recoveries"] == 1 and clean["n_recoveries"] == 0
    assert [h["step"] for h in killed["history"]] == [0, 1, 2, 3, 4, 5, 4, 5, *range(6, 12)]
    by_step = {h["step"]: h["loss"] for h in clean["history"]}
    assert all(h["loss"] == by_step[h["step"]] for h in killed["history"])
    assert killed["state_sha256"] == clean["state_sha256"]
    hist = json.loads(ref_out.read_text())["history"]
    assert [h["step"] for h in hist] == list(range(12))
    np.testing.assert_allclose([by_step[h["step"]] for h in hist], [h["loss"] for h in hist], rtol=1e-4)


def _sessions(log: str) -> dict[int, list[int]]:
    return {int(m[1]): json.loads(m[2]) for m in re.finditer(r"session (\d+): (\[[\d, ]*\])", log)}


def test_serve_cli_on_the_vlm():
    """The port's serve CLI through a kill and the reference's, on the
    reduced VLM: the same logged tokens for sessions 0 and 1; the vision
    stub each draws from ``PRNGKey(0)`` within 3 ulp of the other's."""
    port = _start(["-m", "repro_torch.launch.serve", *SERVE_CLI, "--device", "cpu", "--kill-at", "10:2"])
    ref = _start(["-m", "repro.launch.serve", *SERVE_CLI], {"JAX_PLATFORMS": "cpu"})
    cfg = get_config(VLM).reduced()
    shape = (4, cfg.vision_tokens, cfg.frontend_stub_dim)
    assert _ulps(threefry.normal(threefry.PRNGKey(0), shape).numpy(),
                 np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape))) <= 3
    got, want = _sessions(_wait(port)), _sessions(_wait(ref))
    assert sorted(got) == [0, 1] and got == want
    assert all(len(t) == 8 + 16 for t in got.values())


def test_serve_cli_refuses_the_encoder():
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", HUBERT, "--reduced",
                           "--device", "cpu"], capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=120)
    assert proc.returncode == 1 and "hubert-xlarge-reduced is encoder-only (no decode step)" in proc.stderr


# ---------------------------------------------------------------------------
# compressed_psum over gloo
# ---------------------------------------------------------------------------

PSUM_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.optim.grad_compress import compressed_psum

rank, world, rdv, src, dst = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method="file://" + rdv, world_size=world, rank=rank)
out = {}
with np.load(src) as z:
    for name in z.files:
        x = torch.from_numpy(z[name][rank])
        if name.endswith("#bf16"):
            x = x.view(torch.bfloat16)
        try:
            y = compressed_psum(x)
        except ValueError as e:
            out[name + "#raised"] = np.array(str(e))
            continue
        out[name] = (y.view(torch.uint16) if y.dtype == torch.bfloat16 else y).numpy()
np.savez(dst, **out)
dist.destroy_process_group()
"""


def test_compressed_psum_matches_reference_over_gloo(tmp_path):
    inputs = oracle.psum_inputs()
    env = {**_env(), "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    jx = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_jax_oracle.py"), "psum",
                           str(tmp_path / "ref.npz")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                          env=env, cwd=ROOT)
    src = tmp_path / "in.npz"
    np.savez(src, **{(k + "#bf16" if v.dtype.name == "bfloat16" else k): (v.view(np.uint16) if v.dtype.name ==
                                                                        "bfloat16" else v)
                     for k, v in inputs.items()})
    w = oracle.PSUM_WORLD
    workers = [subprocess.Popen([sys.executable, "-c", PSUM_WORKER, str(r), str(w), str(tmp_path / "rdv"), str(src),
                                 str(tmp_path / f"out{r}.npz")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, env=_env(), cwd=ROOT) for r in range(w)]
    for p in [jx, *workers]:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    want, meta = oracle.load(str(tmp_path / "ref.npz"))
    assert meta == {"f32": "ok", "f32_2d": "ok", "bf16": "ok", "ragged": meta["ragged"]}
    assert meta["ragged"] != "ok"  # the reference fails to reshape the padded codes
    for r in range(w):
        with np.load(tmp_path / f"out{r}.npz") as z:
            got = dict(z)
        assert "8192" in str(got.pop("ragged#raised"))
        for name in ("f32", "f32_2d", "bf16"):
            ref = want[name][r]
            g = got[name + "#bf16"].view(ref.dtype) if name == "bf16" else got[name]
            assert g.shape == ref.shape and g.dtype == ref.dtype
            g, ref = g.astype(np.float32), ref.astype(np.float32)
            tol = 4 * np.finfo(np.float32).eps * np.abs(inputs[name].astype(np.float32)).sum(0)
            if name == "bf16":
                tol = tol + np.abs(ref) * 2.0**-7
            bad = np.abs(g - ref) > tol
            assert not bad.any(), (name, r, int(bad.sum()), float(np.abs(g - ref).max()))
