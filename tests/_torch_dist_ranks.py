"""Per-process bodies for the port's tests over processes: the device tier
(``tests/test_torch_device_tier_dist.py``, ``tests/test_torch_import.py``)
and the sharded ``Trainer`` (``tests/test_torch_trainer_mesh*.py``).

They run in processes started by ``repro_torch.launch.mesh.spawn``, so this
module imports ``torch``, ``numpy`` and the port only: never ``jax`` or the
JAX package, which the parent test process loads. Results go back as plain
data: a tensor as ``(dtype name, shape, bytes)``.
"""

from __future__ import annotations

import itertools
import math
import sys

import numpy as np
import torch


def raw(t: torch.Tensor) -> tuple[str, tuple[int, ...], bytes]:
    from repro_torch.core.serialization import dtype_name

    t = t.detach().to("cpu").contiguous()
    return dtype_name(t.dtype), tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _raw_tree(tree):
    from repro_torch.utils.pytree import tree_map

    return tree_map(raw, tree)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return raw(a) == raw(b)


def _u32(values) -> torch.Tensor:
    from repro_torch.kernels.ref import u32_from_i64

    return u32_from_i64(torch.tensor(values, dtype=torch.int64))


def _bucket_info(prog) -> list:
    return [(b.tag, b.axis, b.axes, b.words) for b in prog.buckets]


def transport_cases(m42, m81) -> dict:
    """ppermute with coordinates no pair reaches, a self pair, psum_u32
    wrapping mod 2^32, all_gather in axis order, and gloo's host staging."""
    from repro_torch.core.transport import Transport

    rank, tp = m42.rank, m42.transport
    out = {}
    x = torch.arange(3, dtype=torch.int32) + 100 * (rank + 1)
    out["ppermute"] = tp.ppermute(x, [(0, 1), (2, 2)], "data").tolist()
    out["psum"] = raw(tp.psum_u32(_u32([0xFFFFFFF0 + rank, 7 * rank]), ("data", "model")))
    out["psum_data"] = raw(tp.psum_u32(_u32([0xFFFFFFF0 + rank, 7 * rank]), ("data",)))
    out["all_gather"] = tp.all_gather(torch.tensor([rank, -rank]), "data").tolist()
    out["all_gather_both"] = tp.all_gather(torch.tensor([rank]), ("data", "model")).tolist()
    staged = Transport(m81)
    staged.staged = True  # the card's path through host memory, here on the CPU
    staged.chunk_bytes = 16  # three chunks of a 40-byte tensor, pipelined
    y = torch.arange(5, dtype=torch.int64) * (rank + 1)
    ring = [(i, (i + 1) % 8) for i in range(8)]
    a, b = staged.ppermute(y, ring, "data"), m81.transport.ppermute(y, ring, "data")
    out["staged"] = (str(a.device), torch.equal(a, b), staged.sent_bytes, staged.recv_bytes)
    return out


def payload_cases(mesh, state, specs, cases, full_cases) -> dict:
    """Each case's snapshot on this process: payload, accounting, bytes sent."""
    from repro_torch.core import device_tier as dt

    tp = mesh.transport
    loc = dt.local_shards(mesh, state, specs)
    out = {}
    for name, codec, g, m in cases:
        prog = dt.build_snapshot_program(mesh, state, specs, codec=codec, parity_group=g, rs_parity=m)
        tp.reset_counts()
        pay = prog.snapshot_fn(loc)
        out[name] = dict(payload=_raw_tree(pay), sent=tp.sent_bytes, recv=tp.recv_bytes, prog_sent=prog.sent_bytes,
                         own_bytes=prog.own_bytes, exchanged=prog.exchanged_bytes, pcie=prog.pcie_bytes,
                         buckets=_bucket_info(prog))
        if name == "xor2":
            for db in (True, False):
                staged = dt.staged_snapshot_fetch(prog, loc, double_buffer=db)
                out[name][f"staged{int(db)}"] = _raw_tree(staged)
    prog = dt.build_snapshot_program(mesh, state, specs, compress=True)
    tp.reset_counts()
    pay = prog.snapshot_fn(loc)
    sent = tp.sent_bytes
    staged = dt.staged_snapshot_fetch(prog, loc)
    out["compressed"] = dict(payload=_raw_tree(pay), staged=_raw_tree(staged), sent=sent,
                             prog_sent=prog.sent_bytes, exchanged=prog.exchanged_bytes, pcie=prog.pcie_bytes)
    for name, codec, g, m in full_cases:
        prog = dt.build_snapshot_program(mesh, state, specs, codec=codec, parity_group=g, rs_parity=m,
                                         emit_full_blobs=True)
        tp.reset_counts()
        pay = prog.snapshot_fn(loc)
        out[f"full/{name}"] = dict(payload=_raw_tree(pay), sent=tp.sent_bytes, prog_sent=prog.sent_bytes,
                                   exchanged=prog.exchanged_bytes, pcie=prog.pcie_bytes)
    return out


def copy_cases(mesh, copy_states) -> dict:
    """The copy codec's restore_fn on each copy case, and the mirror program
    on the first."""
    from repro_torch.core import device_tier as dt

    tp = mesh.transport
    out = {}
    for name, (st, sp) in copy_states.items():
        loc = dt.local_shards(mesh, st, sp)
        prog = dt.build_snapshot_program(mesh, st, sp, include_own_copy=name == "roll")
        pay = prog.snapshot_fn(loc)
        rest = prog.restore_fn(pay)
        _, leaves = dt.tree_flatten(loc)
        out[name] = dict(payload=_raw_tree(pay), restored={k: _same(v, leaves[int(k)]) for k, v in rest.items()},
                         buckets=_bucket_info(prog))
        if name == "roll":
            mprog = dt.build_mirror_program(mesh, st, sp)
            tp.reset_counts()
            mpay = mprog.snapshot_fn(loc)
            sent = tp.sent_bytes
            rest = mprog.restore_fn({"partner": mpay["mirror"]})
            out["mirror"] = dict(payload=_raw_tree(mpay), sent=sent, prog_sent=mprog.sent_bytes,
                                 exchanged=mprog.exchanged_bytes, pcie=mprog.pcie_bytes,
                                 restored={k: _same(v, leaves[int(k)]) for k, v in rest.items()})
    return out


def restore_cases(mesh, state, specs, cases) -> dict:
    """Every failure combination up to each codec's tolerance: the failed
    coordinates' shards overwritten (and their own stripes with them), the
    restore run on every process, the shards held against the originals."""
    from repro_torch.core import device_tier as dt

    A = mesh.shape["data"]
    loc = dt.local_shards(mesh, state, specs)
    _, orig = dt.tree_flatten(loc)
    out = {}
    for name, codec, g, m in cases:
        prog = dt.build_snapshot_program(mesh, state, specs, codec=codec, parity_group=g, rs_parity=m,
                                         include_own_copy=False, validate=False)
        parity = prog.snapshot_fn(loc)["parity"]
        rest = dt.build_striped_restore_program(mesh, state, specs, codec=codec, parity_group=g, rs_parity=m)
        combos = []
        for nfail in range((1 if codec == "xor" else m) + 1):
            for failed in itertools.combinations(range(A), nfail):
                tag = "-".join(map(str, failed)) or "none"
                try:
                    rows, mask = dt.striped_decode_rows(A, g, codec, m, set(failed))
                except ValueError:
                    combos.append((tag, False, None))
                    continue
                bad = dt.tree_map(lambda x: x.clone(), loc)
                dt.overwrite_shards(mesh, bad, specs, "data", failed)
                mine = {k: v.clone() for k, v in parity.items()}
                if mesh.coords["data"] in failed:  # a killed process's stripes are gone too
                    for v in mine.values():
                        v.view(torch.int32).fill_(0x63636363)
                got = rest.restore_fn(bad, mine, {"data": rows}, {"data": mask})
                _, now = dt.tree_flatten(bad)
                ok = all(_same(v, orig[int(k)]) for k, v in got.items())
                ok = ok and all(_same(a, b) for a, b in zip(now, orig))
                combos.append((tag, True, ok))
        out[name] = combos
    return out


def device_tier_rank(rank, world, init_method, state, specs, copy_states, cases, full_cases, restore42,
                     cases81, restore81) -> dict:
    """Every case of the test file on one process of the (4, 2) and the
    (8, 1) mesh over the same 8 gloo processes on the CPU."""
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.sharding.mesh import make_process_mesh

    torch.set_num_threads(1)
    m42 = init_process_mesh((4, 2), ("data", "model"), "gloo", rank=rank, world_size=world,
                            init_method=init_method, device="cpu")
    m81 = make_process_mesh((8, 1), ("data", "model"), "cpu")
    return {
        "coords42": m42.coords, "coords81": m81.coords,
        "transport": transport_cases(m42, m81),
        "m42": payload_cases(m42, state, specs, cases, full_cases),
        "copy": copy_cases(m42, copy_states),
        "m81": payload_cases(m81, state, specs, cases81, ()),
        "restore42": restore_cases(m42, state, specs, restore42),
        "restore81": restore_cases(m81, state, specs, restore81),
        "modules": loaded_reference_modules(),
    }


def loaded_reference_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def import_guard_rank(rank, world, init_method) -> list[str]:
    """Build and run a snapshot program and a striped restore on a (2, 1)
    mesh; return the reference modules this process then holds."""
    from repro_torch.core import device_tier as dt
    from repro_torch.launch.mesh import init_process_mesh

    mesh = init_process_mesh((2, 1), ("data", "model"), "gloo", rank=rank, world_size=world,
                             init_method=init_method, device="cpu")
    state = {"w": torch.arange(8, dtype=torch.float32).reshape(4, 2)}
    specs = {"w": ("data", None)}
    loc = dt.local_shards(mesh, state, specs)
    pay = dt.build_snapshot_program(mesh, state, specs, codec="xor", parity_group=2).snapshot_fn(loc)
    rows, mask = dt.striped_decode_rows(2, 2, "xor", 1, set())
    dt.build_striped_restore_program(mesh, state, specs, codec="xor", parity_group=2).restore_fn(
        loc, pay["parity"], {"data": rows}, {"data": mask})
    np.asarray(pay["checksum"].view(torch.int32))
    return loaded_reference_modules()


def failing_rank(rank, world, init_method) -> None:
    """Rank 1 raises after joining; rank 0 waits on a barrier it will never
    pass (``spawn`` must report rank 1's error and end rank 0)."""
    import torch.distributed as tdist

    from repro_torch.launch.mesh import init_process_mesh

    init_process_mesh((world,), ("data",), "gloo", rank=rank, world_size=world, init_method=init_method,
                      device="cpu")
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    tdist.barrier()


# ---------------------------------------------------------------------------
# the sharded Trainer (tests/test_torch_trainer_mesh.py)
# ---------------------------------------------------------------------------

def _gathered(t, mesh):
    """The trainer's live state gathered to rank 0, as numpy (None
    elsewhere)."""
    from repro_torch.launch.steps import state_to_numpy
    from repro_torch.runtime.state import gather_state

    gather_state(t.state, mesh, t.pspecs, t.global_state)
    return state_to_numpy(t.global_state) if mesh.rank == 0 else None


def _man_json(man) -> dict:
    """``_torch_jax_oracle.man_json`` (that module imports jax)."""
    if isinstance(man, tuple):
        return {"tag": man[0], **_man_json(man[1])}
    coords = None if man.coords is None else [[list(c.global_shape), c.axis, c.start, c.stop] for c in man.coords]
    return {"names": list(man.names), "shapes": [list(x) for x in man.shapes], "dtypes": list(man.dtypes),
            "offsets": list(man.offsets), "total": int(man.total), "coords": coords}


def committed_manifests(eng) -> dict:
    """Each committed store's own and replicated manifests and step, as
    ``_torch_jax_oracle.dump_engine`` gives them."""
    out = {}
    for r, st in sorted(eng.stores.items()):
        ro = st.buffer.read_only
        if ro is None:
            continue
        out[str(r)] = {"own": {name: _man_json(man) for name, (_, man) in sorted(ro.own.items())},
                       "manifests": sorted([o, n, _man_json(m)] for (o, n), m in ro.meta["manifests"].items()),
                       "step": ro.meta.get("step")}
    return out


def _mesh_trainer_run(mesh, cfg, case: dict, steps: int, kills: dict | None) -> dict:
    from repro_torch.models import build_model
    from repro_torch.runtime.failures import FailureInjector
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    inj = FailureInjector(4, schedule=kills) if kills else None
    t = Trainer(build_model(cfg), TrainerConfig(**case), injector=inj, mesh=mesh)
    hist = t.run(steps)
    out = {"history": [[h["step"], h["loss"]] for h in hist], "n_recoveries": t.n_recoveries,
           "final": _gathered(t, mesh)}
    if mesh.rank == 0:
        out.update(created=t.engine.stats.created, aborted=t.engine.stats.aborted,
                   manifests=committed_manifests(t.engine))
    return out


def _placement_blocks(mesh, placement_cases) -> list:
    """Each placement case on this mesh's shape: this process's block of an
    arange laid out by ``distribute``, its placements and ``placements``'."""
    from repro_torch.sharding.mesh import distribute, placements

    out = []
    for sizes, names, shape, spec in placement_cases:
        if tuple(sizes) != tuple(s for _, s in mesh.axes) or tuple(names) != mesh.axis_names:
            continue
        x = distribute(torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape), spec, mesh)
        out.append((x.to_local().numpy(), [str(p) for p in x.placements], [str(p) for p in placements(spec, mesh)]))
    return out


def _decode_raises(mesh) -> dict:
    """``ssm.decode`` and an MoE slot's ``decode_block`` on a DTensor: each
    one's ``NotImplementedError`` words, or "ran"."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks, build_model, ssm
    from repro_torch.models.common import ShardCtx
    from repro_torch.models.lm import on_mesh
    from repro_torch.sharding.mesh import distribute
    from repro_torch.utils import threefry
    from repro_torch.utils.pytree import tree_map

    out = {}
    for name, arch in (("ssm", "mamba2-780m"), ("moe", "mixtral-8x7b")):
        model = build_model(get_config(arch).reduced())
        cfg, ctx = model.cfg, ShardCtx(mesh, model.rules)
        layer = tree_map(lambda x: x[0], model.init(threefry.PRNGKey(0), "cpu")["layers"]["slot0"])
        h = distribute(torch.zeros((4, 1, cfg.d_model), dtype=cfg.compute_dtype), ("data",), mesh)
        cache = {k: torch.zeros(s.shape, dtype=s.dtype)
                 for k, s in blocks.block_cache_spec(cfg, 0, 4, 8).items()}
        try:
            with on_mesh(ctx):
                if name == "ssm":
                    ssm.decode(layer["mixer"], h, cache, cfg, ctx=ctx)
                else:
                    blocks.decode_block(layer, h, cache, torch.tensor(0), cfg, 0, ctx=ctx)
            out[name] = "ran"
        except NotImplementedError as exc:
            out[name] = str(exc)
    return out


def trainer_mesh_rank(rank, world, init_method, rdv_dir, c) -> dict:
    """Every case of the sharded Trainer's tests on one process of the mesh
    ``c["mesh"]``, each case over its own rendezvous under ``rdv_dir``;
    ``c`` holds the oracle's constants (this process imports no jax)."""
    import os

    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_process_mesh

    llama = get_config("llama3.2-1b").reduced()
    case, steps, kills = c["case"], c["steps"], c["kills"]
    cases = {
        "placements": lambda m: _placement_blocks(m, c["placement_cases"]),
        "faulty": lambda m: _mesh_trainer_run(m, llama, case, steps, kills),
        "clean": lambda m: _mesh_trainer_run(m, llama, case, steps, None),
        "fsdp": lambda m: _mesh_trainer_run(m, llama.with_(sharding_preset="fsdp"), case, c["fsdp_steps"], None),
        "decode": _decode_raises,
    }
    out = {}
    for name, run in cases.items():
        mesh = init_process_mesh(*c["mesh"], "gloo", rank=rank, world_size=world, device="cpu",
                                 init_method="file://" + os.path.join(rdv_dir, name))
        try:
            out[name] = run(mesh)
        finally:
            tdist.destroy_process_group()
    out["modules"] = loaded_reference_modules()
    return out


# ---------------------------------------------------------------------------
# every model family on the mesh (tests/test_torch_trainer_mesh_zoo.py)
# ---------------------------------------------------------------------------

def _mesh_grads(mesh, cfg, case: dict) -> dict | None:
    """The loss's gradients at the first step of ``case`` (the params from
    its seed, its first batch) on the mesh, whole, as numpy on rank 0
    (None elsewhere): AdamW's update is blind to a gradient's scale, so the
    losses alone would not show one off by a factor."""
    from repro_torch.data.synthetic import SyntheticDataPipeline
    from repro_torch.models import build_model
    from repro_torch.models.common import ShardCtx
    from repro_torch.models.lm import on_mesh
    from repro_torch.runtime.state import place_state
    from repro_torch.sharding.axes import tree_pspecs
    from repro_torch.utils import threefry
    from repro_torch.utils.pytree import tree_flatten, tree_unflatten

    model = build_model(cfg)
    params = model.init(threefry.PRNGKey(case["seed"]), "cpu")
    paths, live = tree_flatten(place_state(params, mesh, tree_pspecs(model.abstract_params, model.rules, mesh)))
    batch = SyntheticDataPipeline(cfg, case["batch"], case["seq"], case["seed"], mesh=mesh, rules=model.rules).next()
    ctx = ShardCtx(mesh, model.rules)
    with on_mesh(ctx):
        leaves = [p.detach().requires_grad_() for p in live]
        loss, _ = model.loss(tree_unflatten(paths, leaves), batch, ctx=ctx)
        grads = [g.full_tensor() for g in torch.autograd.grad(loss, leaves, materialize_grads=True)]
    return dict(zip(["/".join(p) for p in paths], [g.numpy() for g in grads])) if mesh.rank == 0 else None


def trainer_mesh_zoo_rank(rank, world, init_method, rdv_dir, c) -> dict:
    """Each run of the oracle's ``ZOO_RUNS`` (``c["runs"]``) on one process
    of the mesh, the killed ones through ``c["kills"]`` and again clean,
    each over its own rendezvous under ``rdv_dir``; then the first step's
    gradients of each of ``c["grads"]``'s runs."""
    import os

    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_process_mesh

    out = {}
    for name, arch, over, steps, killed in c["runs"]:
        cfg = get_config(arch).reduced().with_(**over)
        for tag, kills in (("faulty", c["kills"]), ("clean", None)) if killed else (("clean", None),):
            mesh = init_process_mesh(*c["mesh"], "gloo", rank=rank, world_size=world, device="cpu",
                                     init_method="file://" + os.path.join(rdv_dir, f"{name}-{tag}"))
            try:
                res = _mesh_trainer_run(mesh, cfg, c["case"], steps, kills)
            finally:
                tdist.destroy_process_group()
            if name not in c["final"] and not killed:
                res["final"] = None
            out[f"{name}/{tag}"] = res
    mesh = init_process_mesh(*c["mesh"], "gloo", rank=rank, world_size=world, device="cpu",
                             init_method="file://" + os.path.join(rdv_dir, "grads"))
    try:
        for name, arch, over, _, _ in c["runs"]:
            if name in c["grads"]:
                out[f"{name}/grads"] = _mesh_grads(mesh, get_config(arch).reduced().with_(**over), c["case"])
    finally:
        tdist.destroy_process_group()
    out["modules"] = loaded_reference_modules()
    return out


# ---------------------------------------------------------------------------
# the recovery policies and the out-of-run calls on the mesh
# (tests/test_torch_trainer_mesh_policies.py)
# ---------------------------------------------------------------------------

def _engine_meta(t) -> dict | None:
    """Rank 0's engine as the oracle's ``_engine_meta`` gives it (None on
    the other ranks, which hold no engine)."""
    if t.engine is None:
        return None
    return {"n_ranks": t.engine.n_ranks, "created": t.engine.stats.created, "aborted": t.engine.stats.aborted,
            "manifests": committed_manifests(t.engine)}


def _hist(h) -> list:
    return [[x["step"], x["loss"]] for x in h]


def _policy_runs(mesh, c, policy: str | None, kills) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.failures import FailureInjector
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    case = dict(c["case"], **({"recovery_policy": policy} if policy else {}))
    t = Trainer(build_model(get_config("llama3.2-1b").reduced()), TrainerConfig(**case), mesh=mesh,
                injector=FailureInjector(4, schedule=kills) if kills else None)
    return {"history": _hist(t.run(c["steps"])), "n_recoveries": t.n_recoveries, "engine": _engine_meta(t),
            "final": _gathered(t, mesh)}


def _out_of_run(mesh, c, tier: str) -> dict:
    """run(4), restore_elastic(2), regrow(4), run(6); then a fresh 2-host
    Trainer's cold_restart() and run(resume)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    model = build_model(get_config("llama3.2-1b").reduced())
    a = Trainer(model, TrainerConfig(**c["out_case"], tier_dir=tier), mesh=mesh)
    out = {"first": _hist(a.run(4))}
    out["elastic_step"] = int(a.restore_elastic(2)["step"])
    out["after_elastic"] = _engine_meta(a)
    a.regrow(4)
    out["after_regrow"] = _engine_meta(a)
    out["second"] = _hist(a.run(6))
    out["end"] = _engine_meta(a)
    if a.engine is not None:
        a.engine.close()
    out["final"] = _gathered(a, mesh)
    b = Trainer(model, TrainerConfig(**{**c["out_case"], "n_virtual_hosts": 2}, tier_dir=tier), mesh=mesh)
    out["cold_step"] = int(b.cold_restart()["step"])
    out["cold"] = _engine_meta(b)
    out["resumed"] = _hist(b.run(c["resume"]))
    out["n_recoveries"] = [a.n_recoveries, b.n_recoveries]
    if b.engine is not None:
        b.engine.close()
    out["cold_final"] = _gathered(b, mesh)
    return out


def trainer_mesh_policies_rank(rank, world, init_method, rdv_dir, tier_dir, c) -> dict:
    """The "shrink" and "elastic" runs through ``c["kills"]``, the clean run
    they replay, and the out-of-run calls (their disk rung under
    ``tier_dir``), on one process of the mesh."""
    import os

    import torch.distributed as tdist

    from repro_torch.launch.mesh import init_process_mesh

    cases = {
        "shrink": lambda m: _policy_runs(m, c, "shrink", c["kills"]),
        "elastic": lambda m: _policy_runs(m, c, "elastic", c["kills"]),
        "clean": lambda m: _policy_runs(m, c, None, None),
        "out": lambda m: _out_of_run(m, c, tier_dir),
    }
    out = {}
    for name, run in cases.items():
        mesh = init_process_mesh(*c["mesh"], "gloo", rank=rank, world_size=world, device="cpu",
                                 init_method="file://" + os.path.join(rdv_dir, name))
        try:
            out[name] = run(mesh)
        finally:
            tdist.destroy_process_group()
    out["modules"] = loaded_reference_modules()
    return out
