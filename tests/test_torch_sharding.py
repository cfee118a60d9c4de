"""The port's sharding rules against the reference's own cases
(``tests/test_sharding.py``), function for function, on both packages.

* The rule cases: each builds the same ``ParamSpec`` in both packages and
  holds the port's spec tuple equal to the reference's ``PartitionSpec`` as
  a tuple (and the reference's to the value its own test asserts).
* ``test_ep_rules_on_model``: expert parallelism (``moe_mode="ep"``) shards
  the experts' dim over ``data`` in both packages' ``Model.rules``, and the
  port's train-state layout follows it.
* A sweep of every config's params and ZeRO-1 optimizer leaves over the
  (8,1), (16,16) and (2,16,16) meshes, under both presets and both
  ``moe_mode``s, against the reference's ``tree_pspecs`` and
  ``tree_zero1_pspecs``; ``train_state_layout`` gives the same specs.
* ``test_hlo_while_trip_weighting`` on the reference's HLO text, through
  the port's carried-over ``utils/hlo.py``.
* The reduced mixtral ``Trainer`` with 16 experts and ``moe_mode="ep"``:
  its shard plan and the committed stores of one checkpoint of the
  reference's initial state equal the reference ``Trainer``'s
  (``_torch_jax_oracle.py trainer_ep``, one child process).

The reference's ``test_hlo_parser_on_real_module`` and
``test_small_mesh_compile_reduced`` need an XLA compile and are red on the
reference itself; they have no twin here (the dry run's accounting is
``tests/test_torch_dryrun.py``).
"""

from __future__ import annotations

import dataclasses
import textwrap

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_jax_oracle as oracle
import repro.sharding.axes as rax
import repro.sharding.spec as rspec
from repro.sharding.mesh import abstract_mesh
from repro_torch.configs import CONFIGS, get_config
from repro_torch.launch.steps import state_from_numpy, train_state_layout
from repro_torch.models import build_model
from repro_torch.optim.adamw import abstract_opt_state
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.sharding import axes as tax
from repro_torch.sharding import spec as tspec
from repro_torch.sharding.mesh import make_mesh
from repro_torch.utils.pytree import tree_flatten
from test_torch_device_tier import run_oracle

MESHES = {
    "8x1": ((8, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _meshes(name: str):
    sizes, names = MESHES[name]
    return abstract_mesh(*zip(names, sizes)), make_mesh(sizes, names, device="meta")


MESH, T_MESH = _meshes("16x16")
POD_MESH, T_POD_MESH = _meshes("2x16x16")


def _specs(shape, dims):
    return rspec.ParamSpec(shape, dims), tspec.ParamSpec(shape, dims)


def _same(ref_pspec, port_spec) -> None:
    assert port_spec == tuple(ref_pspec), (port_spec, ref_pspec)


# ---------------------------------------------------------------------------
# the reference's rule cases
# ---------------------------------------------------------------------------

def test_tp_param_spec():
    r, t = _specs((4096, 16384), ("embed", "mlp"))
    want = rax.spec_to_pspec(r, rax.TP_RULES, MESH)
    assert want == P(None, "model")
    _same(want, tax.spec_to_pspec(t, tax.TP_RULES, T_MESH))


def test_fsdp_param_spec():
    r, t = _specs((4096, 16384), ("embed", "mlp"))
    assert rax.spec_to_pspec(r, rax.FSDP_RULES, MESH) == P("data", "model")
    assert rax.spec_to_pspec(r, rax.FSDP_RULES, POD_MESH) == P(("pod", "data"), "model")
    _same(rax.spec_to_pspec(r, rax.FSDP_RULES, MESH), tax.spec_to_pspec(t, tax.FSDP_RULES, T_MESH))
    _same(rax.spec_to_pspec(r, rax.FSDP_RULES, POD_MESH), tax.spec_to_pspec(t, tax.FSDP_RULES, T_POD_MESH))


def test_uneven_dims_stay_replicated():
    # 8 kv heads cannot shard 16 ways -> replicated, not uneven
    r, t = _specs((2048, 8, 64), ("embed", "kv_heads", "head_dim"))
    assert rax.spec_to_pspec(r, rax.TP_RULES, MESH) == P()
    _same(P(), tax.spec_to_pspec(t, tax.TP_RULES, T_MESH))


def test_zero1_shards_largest_replicated_dim():
    r, t = _specs((4096, 16384), ("embed", "mlp"))
    assert rax.zero1_pspec(r, rax.TP_RULES, MESH) == P("data", "model")
    _same(P("data", "model"), tax.zero1_pspec(t, tax.TP_RULES, T_MESH))


def test_zero1_respects_divisibility():
    # the stacked dim 9 (jamba's periods) does not divide by 16
    r, t = _specs((9, 256), ("layers", "ssm_heads"))
    want = rax.zero1_pspec(r, rax.TP_RULES, MESH)
    assert want in (P(None, "model"), P())
    _same(want, tax.zero1_pspec(t, tax.TP_RULES, T_MESH))
    r2, t2 = _specs((9, 48), ("layers", None))
    assert rax.zero1_pspec(r2, rax.TP_RULES, MESH) == P(None, "data")  # 48 % 16 == 0
    _same(P(None, "data"), tax.zero1_pspec(t2, tax.TP_RULES, T_MESH))


def test_zero1_never_duplicates_axes():
    r, t = _specs((4096, 8, 128), ("embed", "kv_heads", "head_dim"))
    want = rax.zero1_pspec(r, rax.FSDP_RULES, POD_MESH)
    got = tax.zero1_pspec(t, tax.FSDP_RULES, T_POD_MESH)
    _same(want, got)
    used = [a for e in got if e is not None for a in ((e,) if isinstance(e, str) else e)]
    assert len(used) == len(set(used))


def test_decode_rules_no_duplicate_model_axis():
    r, t = _specs((128, 32768, 16, 256), ("batch", "kv_seq", "kv_heads", None))
    want = rax.spec_to_pspec(r, rax.rules_for_shape(rax.TP_RULES, "decode", 128), MESH)
    assert want == P("data", "model")
    _same(want, tax.spec_to_pspec(t, tax.rules_for_shape(tax.TP_RULES, "decode", 128), T_MESH))


def test_long_decode_rules():
    r, t = _specs((1, 524288, 8, 128), ("batch", "kv_seq", "kv_heads", None))
    want = rax.spec_to_pspec(r, rax.rules_for_shape(rax.TP_RULES, "decode", 1), MESH)
    assert want == P(None, ("data", "model"))
    _same(want, tax.spec_to_pspec(t, tax.rules_for_shape(tax.TP_RULES, "decode", 1), T_MESH))


def test_spec_dedupe_across_dims():
    """A mesh axis claimed by an earlier dim is dropped from later dims."""
    r, t = _specs((16, 8192, 24576), ("experts", "embed", "mlp"))
    want = rax.spec_to_pspec(r, rax.FSDP_RULES.override(experts="data"), MESH)
    assert want == P("data", None, "model")  # embed's ("pod", "data") deduped
    _same(want, tax.spec_to_pspec(t, tax.FSDP_RULES.override(experts="data"), T_MESH))


def test_ep_rules_on_model():
    from repro.configs import CONFIGS as R_CONFIGS
    from repro.models import build_model as r_build_model

    for name in ("jamba-1.5-large-398b", "mixtral-8x7b"):
        assert r_build_model(R_CONFIGS[name].with_(moe_mode="ep")).rules.get("experts") == "data"
        assert r_build_model(R_CONFIGS[name]).rules.get("experts") is None
        assert build_model(CONFIGS[name].with_(moe_mode="ep")).rules.get("experts") == "data"
        assert build_model(CONFIGS[name]).rules.get("experts") is None
    # the train state follows: mixtral-8x7b's expert weights on (8, 1)
    mesh = make_mesh((8, 1), ("data", "model"), device="meta")
    ffn = train_state_layout(CONFIGS["mixtral-8x7b"].with_(moe_mode="ep"), mesh).pspecs["params"]["layers"]["slot0"]["ffn"]
    assert ffn["w_up"] == ffn["w_gate"] == (None, "data", None, "model")
    assert ffn["w_down"] == (None, "data", "model")
    # a dense config has no experts to place: "ep" changes nothing
    dense = CONFIGS["llama3.2-1b"]
    assert build_model(dense.with_(moe_mode="ep")).rules == build_model(dense).rules


# ---------------------------------------------------------------------------
# every config's params and ZeRO-1 leaves over three meshes
# ---------------------------------------------------------------------------

def _flat_pspecs(tree) -> dict:
    """A nested dict of PartitionSpecs (or spec tuples) as {path: tuple}."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            out[path] = tuple(node)

    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_config_param_and_zero1_specs_match_reference(arch):
    from repro.configs import CONFIGS as R_CONFIGS
    from repro.models import build_model as r_build_model
    from repro.optim.adamw import abstract_opt_state as r_abstract_opt_state

    n = 0
    for mesh_name in MESHES:
        r_mesh, t_mesh = _meshes(mesh_name)
        for preset in ("tp", "fsdp"):
            for mode in ("tp", "ep"):
                kw = dict(sharding_preset=preset, moe_mode=mode)
                r_model = r_build_model(R_CONFIGS[arch].with_(**kw))
                t_cfg = CONFIGS[arch].with_(**kw)
                t_model = build_model(t_cfg)
                r_rules = rax.rules_for_shape(r_model.rules, "train", 256)
                t_rules = tax.rules_for_shape(t_model.rules, "train", 256)
                assert t_rules.rules == r_rules.rules
                want = _flat_pspecs(rax.tree_pspecs(r_model.abstract_params, r_rules, r_mesh))
                got = _flat_pspecs(tax.tree_pspecs(t_model.abstract_params, t_rules, t_mesh))
                assert got == want, (mesh_name, preset, mode)
                r_opt = r_abstract_opt_state(r_model.abstract_params)["m"]
                t_opt = abstract_opt_state(t_model.abstract_params)["m"]
                want_z = _flat_pspecs(rax.tree_zero1_pspecs(r_opt, r_rules, r_mesh))
                got_z = _flat_pspecs(tax.tree_zero1_pspecs(t_opt, t_rules, t_mesh))
                assert got_z == want_z, (mesh_name, preset, mode)
                layout = train_state_layout(t_cfg, t_mesh).pspecs
                assert _flat_pspecs(layout["params"]) == want
                for k in ("master", "m", "v"):
                    assert _flat_pspecs(layout["opt"][k]) == want_z
                n += len(want) + len(want_z)
    assert n > 0


# ---------------------------------------------------------------------------
# HLO collective analysis (the carried-over parser)
# ---------------------------------------------------------------------------

def test_hlo_while_trip_weighting():
    hlo = textwrap.dedent(
        """
        HloModule test
        %body.1 (p: (s32[], f32[8])) -> (s32[], f32[8]) {
          %ar = f32[8]{0} all-reduce(%x), replica_groups={}, to_apply=%add
        }
        %cond.1 (p: (s32[], f32[8])) -> pred[] {
          %lt = pred[] compare(%a, %b), direction=LT
        }
        ENTRY %main (p0: f32[8]) -> f32[8] {
          %w = (s32[], f32[8]) while(%init), condition=%cond.1, body=%body.1
          %ar2 = f32[8]{0} all-reduce(%p0), replica_groups={}, to_apply=%add
        }
        """
    )
    from repro.utils.hlo import analyze_hlo_collectives as r_analyze
    from repro.utils.hlo import estimate_hlo_costs as r_estimate
    from repro_torch.utils.hlo import analyze_hlo_collectives, estimate_hlo_costs

    stats = analyze_hlo_collectives(hlo, while_trip=10)
    # in-loop all-reduce weighted 10x, entry one 1x: 32 * 10 + 32
    assert stats.bytes_by_kind["all-reduce"] == 32 * 10 + 32
    assert stats.static_bytes_by_kind["all-reduce"] == 64
    assert stats.n_while == 1
    assert dataclasses.asdict(stats) == dataclasses.asdict(r_analyze(hlo, while_trip=10))
    assert dataclasses.asdict(estimate_hlo_costs(hlo, while_trip=10)) == \
        dataclasses.asdict(r_estimate(hlo, while_trip=10))


# ---------------------------------------------------------------------------
# the Trainer under expert parallelism against the reference Trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jx_ep(tmp_path_factory):
    return run_oracle("trainer_ep", tmp_path_factory.mktemp("oracle") / "trainer_ep.npz")


@pytest.fixture(scope="module")
def port_ep(jx_ep):
    """The port's Trainer on the same config, its state set to the
    reference's initial state (the two draws agree to a few ulp only), and
    one checkpoint of it."""
    arrays, _ = jx_ep
    t = Trainer(build_model(oracle.trainer_ep_config(get_config)), TrainerConfig(**oracle.TRAINER_EP_CASE),
                device="cpu")
    paths, leaves = tree_flatten(t.state)
    for p, x in zip(paths, leaves):
        x.copy_(state_from_numpy(arrays["init/" + "/".join(p)], device="cpu"))
    assert t.engine.checkpoint({"step": 0})
    yield t
    t.engine.close()


def test_ep_trainer_plan_matches_reference(jx_ep, port_ep):
    _, meta = jx_ep
    plan = port_ep.plan
    assert list(plan.dims) == meta["plan"]["dims"]
    assert [list(s) for s in plan.shapes] == meta["plan"]["shapes"]
    # expert parallelism moved leaves: the "tp" plan of the same config differs
    tp = Trainer(build_model(oracle.trainer_ep_config(get_config).with_(moe_mode="tp")),
                 TrainerConfig(**oracle.TRAINER_EP_CASE), device="cpu")
    try:
        assert list(tp.plan.dims) != list(plan.dims)
    finally:
        tp.engine.close()


@pytest.mark.parametrize("entity", ["train_state", "data_pipeline"])
def test_ep_trainer_commits_the_reference_stores(jx_ep, port_ep, entity):
    """Every rank's committed arena of the entity (bytes), its manifests,
    the handshake checksums and the replicated manifest table equal the
    reference's. (The timers entity holds wall-clock times.)"""
    arrays, meta = jx_ep
    got_arrays, got = oracle.dump_engine(port_ep.engine, lambda t: t.numpy())
    assert sorted(got["stores"]) == sorted(meta["stores"])
    for r, want in meta["stores"].items():
        have = got["stores"][r]
        assert have["step"] == want["step"]
        assert have["own"][entity] == want["own"][entity]
        assert have["checksums"][entity] == want["checksums"][entity]
        assert [m for m in have["manifests"] if m[1] == entity] == [m for m in want["manifests"] if m[1] == entity]
        key = f"{r}/own/{entity}"
        assert np.asarray(got_arrays[key]).tobytes() == arrays["store/" + key].tobytes(), key

