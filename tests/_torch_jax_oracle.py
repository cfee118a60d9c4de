"""JAX side of the port's comparison tests, run in a subprocess with eight
virtual CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``).

``python tests/_torch_jax_oracle.py device_tier OUT.npz`` runs the device-tier
cases; ``... state OUT.npz`` runs the llama3.2-1b layout and slice cases;
``... engine OUT.npz`` runs the host-tier checkpoint engine's cases;
``... elastic OUT.npz`` the elastic N-to-M planner, reshard executors and
``restore_elastic`` cases; ``... trainer OUT.npz`` the reference ``Trainer``
through two kills (``TRAINER_CASE``); ``... trainer_tiers OUT.npz`` the
reference ``Trainer`` through a whole-system loss and a cold 4 -> 3 restart
from its disk rung (``TRAINER_TIERS_CASE``); ``... async OUT.npz`` the create
drain's and the pipelined restore's cases (``async_cases``); ``... psum OUT.npz`` the reference's
``compressed_psum`` under ``shard_map`` over 4 devices (``psum_inputs``); ``... dryrun OUT.npz``
(with 512 devices) what the reference's dry run records without compiling (``run_dryrun``); ``... trainer_ep
OUT.npz`` the reference ``Trainer``'s plan and committed stores under expert parallelism
(``TRAINER_EP_CASE``); ``... trainer_mesh OUT.npz`` the reference ``Trainer(mesh=)`` on a
(2, 2) mesh with Auto axes through ``TRAINER_KILLS``, the ``fsdp`` preset's first steps on it,
and ``NamedSharding`` device maps (``MESH_PLACEMENT_CASES``); ``... trainer_mesh_zoo OUT.npz`` the
same mesh's ``Trainer`` for every model family (``ZOO_RUNS``); ``... trainer_mesh_policies OUT.npz``
its "shrink" and "elastic" recoveries and its out-of-run calls (``POLICY_CASE``,
``OUT_OF_RUN_CASE``). The arrays go to the
``.npz``, the metadata to ``OUT.npz.json``.

The engine cases' entities (``ShardedVec``, ``Counter``, ``engine_state``),
the dump of an engine's committed stores (``dump_engine``) and the elastic
cases' runners (``elastic_plan_cases``, ``elastic_engine_cases``) are shared
with the port's tests, which run the same code on the port's engine.
"""

from __future__ import annotations

import itertools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

# (name, codec, parity_group, rs_parity)
CASES = (("copy", "copy", 0, 2), ("xor2", "xor", 2, 1), ("rs2", "rs", 2, 2), ("rs3", "rs", 3, 2),
         ("lrc2", "lrc", 2, 2))  # lrc: lrc_locals 2 (both sides' default) over rs_parity globals


def device_tier_state():
    """The f32/bf16/int8 state of tests/test_device_tier.py's striped cases."""
    rng = np.random.default_rng(0)
    state = {
        "w": rng.standard_normal((8, 4)).astype(np.float32),
        "v": np.asarray(jnp.asarray(rng.standard_normal((8,)), jnp.bfloat16)),
        "b": rng.integers(-100, 100, (16,)).astype(np.int8),
    }
    specs = {"w": ("data", "model"), "v": ("data",), "b": ("data",)}
    return state, specs


def corrupt(state: dict, failed, rows_per_rank: dict) -> dict:
    """Garbage in the failed data coordinates' shards (the mask must zero it)."""
    out = {}
    for k, a in state.items():
        a = a.copy()
        n = rows_per_rank[k]
        for r in failed:
            a[n * r : n * (r + 1)] = 99
        out[k] = a
    return out


def _put(mesh, state, specs):
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P(*specs[k]))) for k, v in state.items()}


def _bucket_meta(prog):
    return [
        {"tag": b.tag, "axis": b.axis, "dtype": b.dtype, "axes": list(b.axes),
         "leaf_idx": list(b.leaf_idx), "word_offsets": list(b.word_offsets), "words": b.words}
        for b in prog.buckets
    ]


def _restore_meta(rest) -> dict:
    return {"pcie_bytes": rest.pcie_bytes, "host_decode_pcie_bytes": rest.host_decode_pcie_bytes,
            "axes": list(rest.axes), "n_parity": rest.n_parity,
            "stripe_words": [list(t) for t in rest.stripe_words]}


# tests/test_device_tier.py's copy-codec restore cases (the roll, many leaves
# and unaligned shards) on the (4, 2) ("data", "model") mesh: leaf -> (shape,
# dtype, spec); every leaf an arange but "rep", all ones
COPY_CASES = {
    "roll": {"w": ((8, 6), "float32", ("data", "model")), "rep": ((5,), "float32", ())},
    "many": {f"w{i}": ((8, 4 + 2 * i), "float32", ("data", "model") if i % 2 else ("data", None))
             for i in range(6)},
    "unaligned": {"a": ((4, 2), "int8", ("data", None)), "b": ((8, 3), "int8", ("data", None))},
}
# the striped full-blob cases (tests/test_device_tier.py's parity oracle):
# (name, codec, parity_group, rs_parity)
FULL_BLOB_CASES = (("xor2", "xor", 2, 1), ("rs3", "rs", 3, 2))


def copy_case_state(name: str) -> tuple[dict, dict]:
    state, specs = {}, {}
    for k, (shape, dtype, spec) in COPY_CASES[name].items():
        n = int(np.prod(shape))
        state[k] = (np.ones(n) if k == "rep" else np.arange(n)).astype(dtype).reshape(shape)
        specs[k] = spec
    return state, specs


def _copy_and_mirror_cases(mesh, arrays: dict, meta: dict) -> None:
    """The copy codec's restore_fn, full blobs and the mirror program."""
    from repro.core.device_tier import build_mirror_program, build_snapshot_program

    for name in COPY_CASES:
        state_np, specs = copy_case_state(name)
        sds = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in state_np.items()}
        ps = {k: P(*v) for k, v in specs.items()}
        prog = build_snapshot_program(mesh, sds, ps, include_own_copy=name == "roll")
        payload = jax.jit(prog.snapshot_fn)(_put(mesh, state_np, specs))
        rest = jax.jit(prog.restore_fn)(payload)
        meta[f"copy/{name}"] = {"buckets": _bucket_meta(prog), "exchanged_names": list(prog.exchanged_names),
                                "pcie_bytes": prog.pcie_bytes}
        arrays[f"copy/{name}/checksum"] = np.asarray(payload["checksum"])
        for tag, val in payload["partner"].items():
            arrays[f"copy/{name}/partner/{tag}"] = np.asarray(val)
        for idx, leaf in rest.items():
            arrays[f"copy/{name}/restored/{idx}"] = np.asarray(leaf)
        if name == "roll":
            mprog = build_mirror_program(mesh, sds, ps)
            mpay = jax.jit(mprog.snapshot_fn)(_put(mesh, state_np, specs))
            meta["mirror"] = {"buckets": _bucket_meta(mprog), "keys": sorted(mpay),
                              "exchanged_bytes": mprog.exchanged_bytes, "pcie_bytes": mprog.pcie_bytes}
            arrays["mirror/checksum"] = np.asarray(mpay["checksum"])
            for tag, val in mpay["mirror"].items():
                arrays[f"mirror/{tag}"] = np.asarray(val)
    state_np, specs = device_tier_state()
    sds = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in state_np.items()}
    ps = {k: P(*v) for k, v in specs.items()}
    state = _put(mesh, state_np, specs)
    for name, codec, g, m in FULL_BLOB_CASES:
        prog = build_snapshot_program(mesh, sds, ps, codec=codec, parity_group=g, rs_parity=m,
                                      emit_full_blobs=True)
        payload = jax.jit(prog.snapshot_fn)(state)
        meta[f"full/{name}"] = {"buckets": _bucket_meta(prog), "keys": sorted(payload),
                                "own_bytes": prog.own_bytes, "exchanged_bytes": prog.exchanged_bytes,
                                "pcie_bytes": prog.pcie_bytes}
        arrays[f"full/{name}/checksum"] = np.asarray(payload["checksum"])
        for tag, val in payload["parity_full"].items():
            arrays[f"full/{name}/parity_full/{tag}"] = np.asarray(val)


def run_device_tier(out_path: str) -> None:
    from repro.core.device_tier import (
        build_snapshot_program, build_striped_restore_program, staged_snapshot_fetch,
        striped_decode_rows,
    )

    mesh = jax.make_mesh((4, 2), ("data", "model"))
    state_np, specs = device_tier_state()
    sds = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in state_np.items()}
    ps = {k: P(*v) for k, v in specs.items()}
    state = _put(mesh, state_np, specs)
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {}
    for name, codec, g, m in CASES:
        prog = build_snapshot_program(mesh, sds, ps, codec=codec, parity_group=g, rs_parity=m)
        payload = jax.jit(prog.snapshot_fn)(state)
        meta[name] = {
            "buckets": _bucket_meta(prog), "own_bytes": prog.own_bytes,
            "exchanged_bytes": prog.exchanged_bytes, "pcie_bytes": prog.pcie_bytes,
            "exchanged_names": list(prog.exchanged_names), "combos": [],
        }
        arrays[f"{name}/checksum"] = np.asarray(payload["checksum"])
        for k in sds:
            arrays[f"{name}/own/{k}"] = np.asarray(payload["own"][k])
        key = "partner" if codec == "copy" else "parity"
        for tag, val in payload[key].items():
            arrays[f"{name}/{key}/{tag}"] = np.asarray(val)
        if name == "xor2":
            for db in (True, False):
                staged = staged_snapshot_fetch(prog, state, double_buffer=db)
                for tag, val in staged["parity"].items():
                    arrays[f"staged{int(db)}/parity/{tag}"] = np.asarray(val)
                for k in sds:
                    arrays[f"staged{int(db)}/own/{k}"] = np.asarray(staged["own"][k])
        if codec == "copy":
            continue
        rest = build_striped_restore_program(mesh, sds, ps, codec=codec, parity_group=g, rs_parity=m)
        meta[name]["restore"] = _restore_meta(rest)
        tol = 1 if codec == "xor" else m
        for nfail in range(tol + 1):
            for failed in itertools.combinations(range(4), nfail):
                tag = "-".join(map(str, failed)) or "none"
                try:
                    rows, mask = striped_decode_rows(4, g, codec, m, set(failed))
                except ValueError:
                    meta[name]["combos"].append([tag, False])
                    continue
                meta[name]["combos"].append([tag, True])
                arrays[f"{name}/rows/{tag}"] = rows
                arrays[f"{name}/mask/{tag}"] = mask
                bad = _put(mesh, corrupt(state_np, failed, {"w": 2, "v": 2, "b": 4}), specs)
                outs = rest.restore_fn(bad, payload["parity"], {"data": rows}, {"data": mask})
                for idx, leaf in outs.items():
                    arrays[f"{name}/restored/{tag}/{idx}"] = np.asarray(leaf)
    # compress=True (copy codec): int8 codes + f32 scales per bucket
    prog = build_snapshot_program(mesh, sds, ps, compress=True)
    payload = jax.jit(prog.snapshot_fn)(state)
    meta["compressed"] = {"buckets": _bucket_meta(prog), "own_bytes": prog.own_bytes,
                          "exchanged_bytes": prog.exchanged_bytes, "pcie_bytes": prog.pcie_bytes}
    arrays["compressed/checksum"] = np.asarray(payload["checksum"])
    staged = staged_snapshot_fetch(prog, state, double_buffer=True)
    for tag, val in payload["partner"].items():
        for part in ("q", "scale"):
            arrays[f"compressed/partner/{tag}/{part}"] = np.asarray(val[part])
            arrays[f"compressed/staged/{tag}/{part}"] = np.asarray(staged["partner"][tag][part])
    _copy_and_mirror_cases(mesh, arrays, meta)
    _save(out_path, arrays, meta)


def run_state(out_path: str) -> None:
    from repro.configs import get_config
    from repro.core.device_tier import (
        build_snapshot_program, build_striped_restore_program, striped_decode_rows,
    )
    from repro.launch.steps import build_step

    mesh = jax.make_mesh((8, 1), ("data", "model"))
    cfg = get_config("llama3.2-1b")
    bundle = build_step(cfg, "train_4k", mesh)
    sds, shardings = bundle.args_sds[0], bundle.in_shardings[0]
    leaves = jax.tree_util.tree_flatten_with_path(sds)[0]
    shard_leaves = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    meta: dict = {"layout": [
        ["/".join(p.key for p in path), list(x.shape), x.dtype.name,
         [list(e) if isinstance(e, tuple) else e for e in sh.spec]]
        for (path, x), sh in zip(leaves, shard_leaves)
    ]}

    # The slice end to end at reduced size: rs g=4 m=2, kill ranks {0, 2}.
    small = build_step(cfg.reduced(), "train_4k", mesh)
    ssds, ssh = small.args_sds[0], small.in_shardings[0]
    spaths = jax.tree_util.tree_flatten_with_path(ssds)[0]
    rng = np.random.default_rng(7)
    state_np = {}
    for path, x in spaths:
        key = "/".join(p.key for p in path)
        state_np[key] = (rng.standard_normal(x.shape) * 0.1).astype(x.dtype) if x.dtype != np.int32 \
            else np.asarray(5, np.int32)
    tree_np = jax.tree.unflatten(jax.tree.structure(ssds), [state_np["/".join(p.key for p in path)] for path, _ in spaths])
    state = jax.tree.map(lambda a, sh: jax.device_put(jnp.asarray(a), sh), tree_np, ssh)
    ps = jax.tree.map(lambda sh: sh.spec, ssh, is_leaf=lambda x: isinstance(x, NamedSharding))
    prog = build_snapshot_program(mesh, ssds, ps, codec="rs", parity_group=4, rs_parity=2)
    payload = jax.jit(prog.snapshot_fn)(state)
    arrays = {f"state/{k}": v for k, v in state_np.items()}
    arrays["checksum"] = np.asarray(payload["checksum"])
    for tag, val in payload["parity"].items():
        arrays[f"parity/{tag}"] = np.asarray(val)
    rows, mask = striped_decode_rows(8, 4, "rs", 2, {0, 2})
    rest = build_striped_restore_program(mesh, ssds, ps, codec="rs", parity_group=4, rs_parity=2)
    # ranks 0 and 2 are dead: the survivor mask zeroes whatever their shards
    # hold, so the intact state stands in for the killed one here
    outs = rest.restore_fn(state, payload["parity"], {"data": rows}, {"data": mask})
    for idx, leaf in outs.items():
        arrays[f"restored/{idx}"] = np.asarray(leaf)
    meta["small_buckets"] = _bucket_meta(prog)
    meta["small_paths"] = ["/".join(p.key for p in path) for path, _ in spaths]
    _save(out_path, arrays, meta)


# ---------------------------------------------------------------------------
# Host-tier checkpoint engine
# ---------------------------------------------------------------------------

# tests/test_engine.py's MODES with the copy codec, restored by the serial
# "sync" path (the port's restore)
ENGINE_MODES = {
    "pairwise": {},
    "neighbor": {"scheme": "neighbor"},
    "two_copies": {"n_copies": 2},
    "compressed": {"compress": True},
}
ENGINE_RANKS = 8
ENGINE_DIM = 1000  # >= 256, so compress_tree quantizes the vector (padded to 8192)

# the ShardedStateEntity + RngEntity cases over 4 ranks (rank 2 wiped):
# tag -> EngineConfig fields; the striped codecs in groups of 2, each
# group's blobs on the other, plain and int8-compressed
ENGINE_STATE_CASES = {
    "state0": {}, "state1": {"compress": True},
    **{f"{name}{int(c)}": {**cfg, "compress": c}
       for name, cfg in (("xor", {"parity_group": 2}), ("rs", {"codec": "rs", "parity_group": 2, "rs_parity": 2}),
                         ("lrc", {"codec": "lrc", "parity_group": 2}))
       for c in (False, True)},
}


class ShardedVec:
    """tests/test_engine.py's sharded entity (per-rank unique contents)."""

    def __init__(self, n, dim=ENGINE_DIM):
        self.n = n
        self.data = [np.arange(dim, dtype=np.float32) + 1000 * r for r in range(n)]

    def snapshot_shards(self, n):
        return [{"v": self.data[r].copy(), "origin": np.int64(r)} for r in range(n)]

    def restore_shards(self, shards):
        for origin, payload in shards.items():
            assert int(payload["origin"]) == origin
            self.data[origin] = np.asarray(payload["v"]).copy()


class Counter:
    def __init__(self):
        self.step = 0

    def snapshot(self):
        return {"step": np.int64(self.step)}

    def restore(self, snap):
        self.step = int(snap["step"])


def engine_state():
    """A train-state-like tree for ShardedStateEntity over 4 ranks: f32 and
    bf16 leaves split on the data dim (quantized under compress), a bf16
    leaf replicated, an int32 step; with its specs."""
    import ml_dtypes

    rng = np.random.default_rng(11)
    state = {
        "opt": {"m": rng.standard_normal((8, 300)).astype(np.float32),
                "w16": rng.standard_normal((4, 512)).astype(ml_dtypes.bfloat16)},
        "params": {"embed": rng.standard_normal((6, 40)).astype(ml_dtypes.bfloat16)},
        "step": np.asarray(5, np.int32),
    }
    specs = {"opt": {"m": ("data", None), "w16": ("data", None)},
             "params": {"embed": (None, "model")}, "step": ()}
    return state, specs


def man_json(man) -> dict:
    """A manifest (or the engine's ("compressed", manifest) tag) as JSON."""
    if isinstance(man, tuple):
        return {"tag": man[0], **man_json(man[1])}
    coords = None if man.coords is None else [
        [list(c.global_shape), c.axis, c.start, c.stop] for c in man.coords
    ]
    return {"names": list(man.names), "shapes": [list(x) for x in man.shapes],
            "dtypes": list(man.dtypes), "offsets": list(man.offsets), "total": int(man.total),
            "coords": coords}


def dump_engine(eng, as_np) -> tuple[dict, dict]:
    """Every committed store of an engine: own arenas, the striped codecs'
    exchange sets and held copies or stripes (bytes) and their manifests,
    the handshake and exchange checksums, the replicated manifest table.
    ``as_np`` turns a flat buffer into numpy."""
    arrays, stores = {}, {}
    for r, st in sorted(eng.stores.items()):
        ro = st.buffer.read_only
        if ro is None:
            continue
        d = {"own": {}, "parity": [], "meta_keys": sorted(ro.meta),
             "step": ro.meta.get("step"), "codecs": ro.meta.get("codecs")}
        for name, (flat, man) in sorted(ro.own.items()):
            arrays[f"{r}/own/{name}"] = as_np(flat)
            d["own"][name] = man_json(man)
        for name, (flat, man) in sorted(ro.own_exch.items()):  # striped codecs' exchange sets
            arrays[f"{r}/own_exch/{name}"] = as_np(flat)
            d.setdefault("own_exch", {})[name] = man_json(man)
        for gi, held in sorted(ro.parity.items()):
            for (name, b, j), piece in sorted(held.items()):
                arrays[f"{r}/parity/{gi}/{name}/{b}/{j}"] = as_np(piece)
                d["parity"].append([gi, name, b, j])
        d["checksums"] = {k: list(v) for k, v in sorted(ro.meta.get("checksums", {}).items())}
        d["exch_checksums"] = sorted([o, n, *v] for (o, n), v in ro.meta.get("exch_checksums", {}).items())
        d["manifests"] = sorted([o, n, man_json(m)] for (o, n), m in ro.meta["manifests"].items())
        stores[str(r)] = d
    return arrays, {"stores": stores}


def _holders(cfg, n: int, origin: int) -> list[int]:
    from repro.core.distribution import get_scheme, multi_copy_shifts

    if cfg.get("n_copies", 1) == 1:
        return [get_scheme(cfg.get("scheme", "pairwise"))(n, origin)[0]]
    return [(origin + s) % n for s in multi_copy_shifts(n, cfg["n_copies"])]


def engine_vec_cases(make_engine, wrap, as_np, vec_data) -> tuple[dict, dict]:
    """Per mode: commit a checkpoint of ShardedVec + Counter over 8 ranks
    and dump it; wipe rank 3 and restore; wipe rank 2 with rank 6, and rank 2
    with every holder of its copies, and record whether the data is lost.
    ``make_engine(n, **cfg)`` builds an engine, ``wrap`` adapts an entity,
    ``vec_data`` reads an entity's vector as numpy."""
    arrays, meta = {}, {}
    for mode, cfg in ENGINE_MODES.items():
        eng = make_engine(ENGINE_RANKS, **cfg)
        vec, cnt = ShardedVec(ENGINE_RANKS), Counter()
        eng.register("state", wrap(vec))
        eng.register("counter", wrap(cnt))
        cnt.step = 42
        assert eng.checkpoint({"step": 42})
        a, m = dump_engine(eng, as_np)
        arrays.update({f"{mode}/{k}": v for k, v in a.items()})
        for d in vec.data:
            d += 999.0
        cnt.step = 99
        eng.stores[3].wipe()
        got = eng.restore()
        m["restore"] = {"meta_step": int(got["step"]), "counter": cnt.step,
                        "zero_comm": eng.stats.zero_comm_restores, "adopted": eng.stats.adopted_restores}
        for r in range(ENGINE_RANKS):
            arrays[f"{mode}/restored/{r}"] = vec_data(vec, r)
        m["lost"] = {}
        for tag, kill in (("2+6", [2, 6]), ("2+holders", [2, *_holders(cfg, ENGINE_RANKS, 2)])):
            eng = make_engine(ENGINE_RANKS, **cfg)
            eng.register("state", wrap(ShardedVec(ENGINE_RANKS)))
            eng.checkpoint({"step": 1})
            for r in kill:
                eng.stores[r].wipe()
            try:
                eng.restore()
                m["lost"][tag] = False
            except Exception as e:  # noqa: BLE001 - the class name is the result
                m["lost"][tag] = type(e).__name__
        meta[mode] = m
    return arrays, meta


def run_engine(out_path: str) -> None:
    import jax.tree_util as jtu

    from repro.core.checkpoint import CheckpointEngine, EngineConfig
    from repro.runtime.state import RngEntity, ShardedStateEntity, ShardPlan

    def make_engine(n, **cfg):
        return CheckpointEngine(n, EngineConfig(restore_mode="sync", **cfg))

    arrays, meta = engine_vec_cases(make_engine, lambda e: e, np.asarray, lambda vec, r: vec.data[r])

    # ShardedStateEntity + RngEntity over 4 ranks: ENGINE_STATE_CASES
    state_np, specs = engine_state()
    sds = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state_np)
    ps = jtu.tree_map(lambda t: P(*t), specs, is_leaf=lambda x: isinstance(x, tuple))
    plan = ShardPlan.from_pspecs(sds, ps)
    for tag, cfg in ENGINE_STATE_CASES.items():
        box = {"s": jax.tree.map(np.copy, state_np)}
        eng = make_engine(4, **cfg)
        rng = RngEntity()
        rng.seed, rng.counter = 7, 3
        eng.register("state", ShardedStateEntity(lambda: box["s"], lambda s: box.update(s=s), plan))
        eng.register("rng", rng)
        assert eng.checkpoint({"step": 1})
        a, m = dump_engine(eng, np.asarray)
        arrays.update({f"{tag}/{k}": v for k, v in a.items()})
        box["s"] = jax.tree.map(lambda a: (a + 1).astype(a.dtype), box["s"])
        rng.seed, rng.counter = 0, 0
        eng.stores[2].wipe()
        eng.restore()
        m["rng"] = [rng.seed, rng.counter]
        for path, leaf in jtu.tree_flatten_with_path(box["s"])[0]:
            arrays[f"{tag}/restored/" + "/".join(k.key for k in path)] = np.asarray(leaf)
        meta[tag] = m
    _save(out_path, arrays, meta)


# ---------------------------------------------------------------------------
# The create drain and the pipelined restore (the copy codec's mirrors of
# tests/test_async_pipeline.py)
# ---------------------------------------------------------------------------

ASYNC_RANKS = 8
ASYNC_CHUNK = 256          # restore_chunk_bytes that gives several chunks per unit
ASYNC_RESTORE_KILL = 5     # the wiped rank of the restore cases (pairwise partner 1)
ASYNC_SURVIVOR_KILL = 6    # the survivor the mid-restore cases kill (partner 2)


def _vec_setup(make_engine, wrap, n=ASYNC_RANKS, hook=None, **cfg):
    eng = make_engine(n, hook, **cfg)
    vec, cnt = ShardedVec(n), Counter()
    eng.register("state", wrap(vec))
    eng.register("counter", wrap(cnt))
    return eng, vec, cnt


def _restored(vec) -> np.ndarray:
    return np.stack([np.asarray(d) for d in vec.data])


def _stats(eng, pinned_chunks: bool = False) -> dict:
    """The engine's counters; with ``pinned_chunks`` (a fixed
    ``restore_chunk_bytes``) also the pipelined restore's, which under the
    adaptive planner depend on the rates this process has measured."""
    names = ["created", "aborted", "restored", "zero_comm_restores", "adopted_restores", "reconstructed_restores",
             "last_bytes_staged", "last_bytes_exchanged", "last_pipeline_chunks"]
    if pinned_chunks:
        names += ["last_restore_chunks", "last_restore_bytes_rebuilt", "last_restore_decompressed_bytes",
                  "restore_plan_reuses"]
    return {k: getattr(eng.stats, k) for k in names}


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the class name is the result
        return type(e).__name__


def async_cases(make_engine, wrap, as_np) -> tuple[dict, dict]:
    """Every case of the port's ``tests/test_torch_async.py``, run the same
    way on either engine: ``make_engine(n, fault_hook, **cfg)`` builds one,
    ``wrap`` adapts an entity, ``as_np`` reads a flat buffer. Returns the
    committed stores, restored vectors and engine counters of each case."""
    arrays, meta = {}, {}

    def record(tag, eng, vec=None, pinned_chunks=False, **extra):
        a, m = dump_engine(eng, as_np)
        arrays.update({f"{tag}/{k}": v for k, v in a.items()})
        if vec is not None:
            arrays[f"{tag}/restored"] = _restored(vec)
        meta[tag] = {"stores": m["stores"], "stats": _stats(eng, pinned_chunks), **extra}

    # 1. create: blocking, drained in finalize_async, drained in the background
    # (the default); then a pipelined restore of rank 2
    for compress in (False, True):
        for how in ("checkpoint", "foreground", "background"):
            tag = f"create/{how}/{int(compress)}"
            eng, vec, cnt = _vec_setup(make_engine, wrap, compress=compress)
            cnt.step = 7
            if how == "checkpoint":
                ok = eng.checkpoint({"step": 7})
            else:
                ok = eng.checkpoint_async({"step": 7}, background=how == "background") \
                    and eng.finalize_async() is True
            for d in vec.data:
                d += 123.0
            eng.stores[2].wipe()
            got = eng.restore()
            record(tag, eng, vec, ok=bool(ok), step=int(got["step"]), counter=cnt.step)
            eng.close()

    # 2. restore: sync vs pipelined, serial and parallel drains, plain and
    # compressed; the pipelined one twice (the second from the plan cache)
    for compress in (False, True):
        for workers in (0, 1, 4):
            for mode in ("sync", "pipelined"):
                tag = f"restore/{mode}/{workers}/{int(compress)}"
                eng, vec, _ = _vec_setup(make_engine, wrap, compress=compress, restore_mode=mode,
                                         async_workers=workers, restore_chunk_bytes=ASYNC_CHUNK)
                assert eng.checkpoint({"step": 4})
                eng.stores[ASYNC_RESTORE_KILL].wipe()
                for d in vec.data:
                    d += 7.0
                steps = [int(eng.restore()["step"])]
                first = _restored(vec)
                for d in vec.data:
                    d += 3.0
                steps.append(int(eng.restore()["step"]))
                arrays[f"{tag}/first"] = first
                record(tag, eng, vec, pinned_chunks=True, steps=steps)
                eng.close()

    # 3. restore_elastic 8 -> 6 out of each restore mode
    for mode in ("sync", "pipelined"):
        tag = f"elastic/{mode}"
        eng, vec, _ = _vec_setup(make_engine, wrap, restore_mode=mode, async_workers=2)
        assert eng.checkpoint({"step": 3})
        eng.stores[5].wipe()
        got = eng.restore_elastic(6)
        arrays[f"{tag}/restored"] = _restored(vec)
        meta[tag] = {"step": int(got["step"]), "n_ranks": eng.n_ranks, "stats": _stats(eng)}
        eng.close()

    # 4. a rank dying at drain unit k aborts the snapshot; the committed one
    # stays byte for byte and restores
    for kill_chunk in (0, 1, 2, "background"):
        tag = f"kill/{kill_chunk}"
        state = {"chunks": 0, "armed": False}
        victim = 3 if kill_chunk == "background" else 6
        at = 1 if kill_chunk == "background" else kill_chunk

        def hook(phase, state=state, victim=victim, at=at):
            if phase == "pipeline_chunk" and state["armed"]:
                if state["chunks"] == at:
                    state["armed"] = False
                    eng.stores[victim].wipe()
                state["chunks"] += 1

        eng, vec, _ = _vec_setup(make_engine, wrap, hook=hook)
        assert eng.checkpoint({"step": 1})
        for d in vec.data:
            d += 5
        state["armed"] = True
        captured = eng.checkpoint_async({"step": 2}, background=kill_chunk == "background")
        finalized = eng.finalize_async()
        after_abort, _ = dump_engine(eng, as_np)
        got = eng.restore()
        arrays.update({f"{tag}/after_abort/{k}": v for k, v in after_abort.items()})
        record(tag, eng, vec, captured=bool(captured), finalized=finalized, step=int(got["step"]))
        eng.close()

    # 5. a staged byte flipped after the capture: the drain's VERIFY aborts
    corrupted = {"done": False}

    def flip(phase):
        if phase == "pipeline_chunk" and not corrupted["done"]:
            corrupted["done"] = True
            flat, _ = eng.stores[0].buffer.writable.own["state"]
            flat[0] ^= 0xFF

    eng, vec, _ = _vec_setup(make_engine, wrap, n=4)
    assert eng.checkpoint({"step": 1})
    eng._fault_hook = flip
    meta["staged_corruption"] = {"ok": bool(eng.checkpoint({"step": 2})), "stats": _stats(eng)}
    eng.close()

    # 6. discard_pending joins a background drain; the committed checkpoint restores
    eng, vec, _ = _vec_setup(make_engine, wrap, n=4)
    assert eng.checkpoint({"step": 1})
    assert eng.checkpoint_async({"step": 2})
    eng.discard_pending()
    meta["discard"] = {"step": int(eng.restore()["step"]), "stats": _stats(eng)}
    eng.close()

    # 7. a survivor dying at each chunk of a serial pipelined restore: the
    # restore completes from the references captured at prep; a second
    # restore recovers the new failure too
    chunks = {"n": 0}
    eng, vec, _ = _vec_setup(make_engine, wrap, restore_chunk_bytes=ASYNC_CHUNK, async_workers=0,
                             hook=lambda ph: chunks.__setitem__("n", chunks["n"] + (ph == "restore_chunk")))
    assert eng.checkpoint({"step": 1})
    eng.stores[ASYNC_RESTORE_KILL].wipe()
    eng.restore()
    meta["restore_kill_chunks"] = chunks["n"]
    eng.close()
    for kill_chunk in range(chunks["n"]):
        tag = f"restore_kill/{kill_chunk}"
        state = {"chunks": 0, "armed": False}

        def hook(phase, state=state, kill_chunk=kill_chunk):
            if phase == "restore_chunk" and state["armed"]:
                if state["chunks"] == kill_chunk:
                    state["armed"] = False
                    eng.stores[ASYNC_SURVIVOR_KILL].wipe()
                state["chunks"] += 1

        eng, vec, _ = _vec_setup(make_engine, wrap, hook=hook, restore_chunk_bytes=ASYNC_CHUNK, async_workers=0)
        assert eng.checkpoint({"step": 1})
        eng.stores[ASYNC_RESTORE_KILL].wipe()
        for d in vec.data:
            d += 3.0
        state["armed"] = True
        steps = [int(eng.restore()["step"])]
        first = _restored(vec)
        for d in vec.data:
            d += 11.0
        steps.append(int(eng.restore()["step"]))
        arrays[f"{tag}/first"] = first
        arrays[f"{tag}/restored"] = _restored(vec)
        meta[tag] = {"steps": steps, "stats": _stats(eng, pinned_chunks=True)}
        eng.close()

    # 8. the adopted copy corrupted after the commit: the restore's VERIFY
    # raises under the pipelined restore (the sync one restores the bytes)
    for mode in ("sync", "pipelined"):
        eng, vec, _ = _vec_setup(make_engine, wrap, restore_mode=mode, restore_chunk_bytes=ASYNC_CHUNK)
        assert eng.checkpoint({"step": 1})
        eng.stores[1].wipe()
        holder = next(r for r in range(ASYNC_RANKS) if eng.stores[r].alive
                      and ("state", 0, 0) in eng.stores[r].buffer.read_only.parity.get(1, {}))
        eng.stores[holder].buffer.read_only.parity[1][("state", 0, 0)][8] ^= 0xFF
        meta[f"restore_corrupt/{mode}"] = {"holder": holder, "outcome": _outcome(lambda: int(eng.restore()["step"]))}
        eng.close()

    # 9. the create drain over 1 and 4 workers
    for workers in (1, 4):
        tag = f"workers/{workers}"
        eng, vec, _ = _vec_setup(make_engine, wrap, n=12, async_workers=workers)
        assert eng.checkpoint_async({"step": 2}) and eng.finalize_async() is True
        eng.stores[7].wipe()
        eng.restore()
        record(tag, eng, vec)
        eng.close()

    # 10. ragged worlds: every single loss and every pair of losses that are
    # not each other's copy holders, pipelined, over 10 ranks
    outcomes = {}
    for kills in itertools.chain(itertools.combinations(range(10), 1), itertools.combinations(range(10), 2)):
        eng, vec, _ = _vec_setup(make_engine, wrap, n=10, restore_chunk_bytes=512)
        assert eng.checkpoint({"step": 1})
        orig = _restored(vec)
        for r in kills:
            eng.stores[r].wipe()
        for d in vec.data:
            d *= -1.0
        out = _outcome(eng.restore)
        outcomes["+".join(map(str, kills))] = out if isinstance(out, str) else bool(np.array_equal(_restored(vec), orig))
        eng.close()
    meta["ragged"] = outcomes
    striped_async_cases(make_engine, wrap, record, arrays, meta)
    return arrays, meta


# the striped codecs' mirrors of the cases above (tests/test_async_pipeline.py
# and tests/test_codec.py run them under xor and rs): groups of 4 over 12
# ranks, each codec's kill set within its tolerance
STRIPED = {"xor": {"parity_group": 4}, "rs": {"codec": "rs", "parity_group": 4, "rs_parity": 2},
           "lrc": {"codec": "lrc", "parity_group": 4}}
STRIPED_KILLS = {"xor": (5,), "rs": (4, 6), "lrc": (4, 6)}
STRIPED_RANKS = 12


def striped_async_cases(make_engine, wrap, record, arrays: dict, meta: dict) -> None:
    """Per striped codec: the create drain over 1 and 4 workers; sync and
    pipelined restores over 0 and 4 workers (rs also int8-compressed), each
    twice; a survivor killed at every chunk of a serial pipelined rs
    restore; a held rs stripe corrupted after the commit; every single and
    double loss over 10 ranks (a ragged last group of 2)."""
    n = STRIPED_RANKS
    for codec, cfg in STRIPED.items():
        for workers in (1, 4):
            tag = f"striped/{codec}/workers/{workers}"
            eng, vec, _ = _vec_setup(make_engine, wrap, n=n, async_workers=workers, **cfg)
            assert eng.checkpoint_async({"step": 2}) and eng.finalize_async() is True
            for r in STRIPED_KILLS[codec]:
                eng.stores[r].wipe()
            eng.restore()
            record(tag, eng, vec)
            eng.close()
        for compress in (False, True) if codec == "rs" else (False,):
            for workers in (0, 4):
                for mode in ("sync", "pipelined"):
                    tag = f"striped/{codec}/restore/{mode}/{workers}/{int(compress)}"
                    eng, vec, _ = _vec_setup(make_engine, wrap, n=n, compress=compress, restore_mode=mode,
                                             async_workers=workers, restore_chunk_bytes=ASYNC_CHUNK, **cfg)
                    assert eng.checkpoint({"step": 4})
                    for r in STRIPED_KILLS[codec]:
                        eng.stores[r].wipe()
                    for d in vec.data:
                        d += 7.0
                    steps = [int(eng.restore()["step"])]
                    first = _restored(vec)
                    for d in vec.data:
                        d += 3.0
                    steps.append(int(eng.restore()["step"]))
                    arrays[f"{tag}/first"] = first
                    record(tag, eng, vec, pinned_chunks=True, steps=steps)
                    eng.close()

    # rank 1 wiped; survivor 5 (group 1, holder of one of group 0's blobs)
    # killed at each chunk of the serial restore; the second restore rebuilds
    # both from the blobs that remain
    rs = STRIPED["rs"]
    chunks = {"n": 0}
    eng, vec, _ = _vec_setup(make_engine, wrap, n=n, restore_chunk_bytes=ASYNC_CHUNK, async_workers=0,
                             hook=lambda ph: chunks.__setitem__("n", chunks["n"] + (ph == "restore_chunk")), **rs)
    assert eng.checkpoint({"step": 1})
    eng.stores[1].wipe()
    eng.restore()
    meta["striped/restore_kill_chunks"] = chunks["n"]
    eng.close()
    for kill_chunk in range(chunks["n"]):
        tag = f"striped/restore_kill/{kill_chunk}"
        state = {"chunks": 0, "armed": False}

        def hook(phase, state=state, kill_chunk=kill_chunk):
            if phase == "restore_chunk" and state["armed"]:
                if state["chunks"] == kill_chunk:
                    state["armed"] = False
                    eng.stores[5].wipe()
                state["chunks"] += 1

        eng, vec, _ = _vec_setup(make_engine, wrap, n=n, hook=hook, restore_chunk_bytes=ASYNC_CHUNK,
                                 async_workers=0, **rs)
        assert eng.checkpoint({"step": 1})
        eng.stores[1].wipe()
        for d in vec.data:
            d += 3.0
        state["armed"] = True
        steps = [int(eng.restore()["step"])]
        first = _restored(vec)
        for d in vec.data:
            d += 11.0
        steps.append(int(eng.restore()["step"]))
        arrays[f"{tag}/first"] = first
        arrays[f"{tag}/restored"] = _restored(vec)
        meta[tag] = {"steps": steps, "stats": _stats(eng, pinned_chunks=True)}
        eng.close()

    # a byte of a stripe group 0's decode reads, flipped after the commit
    for mode in ("sync", "pipelined"):
        eng, vec, _ = _vec_setup(make_engine, wrap, n=n, restore_mode=mode, restore_chunk_bytes=ASYNC_CHUNK, **rs)
        assert eng.checkpoint({"step": 1})
        eng.stores[1].wipe()
        eng.stores[4].buffer.read_only.parity[0][("state", 0, 0)][8] ^= 0xFF
        meta[f"striped/restore_corrupt/{mode}"] = {"outcome": _outcome(lambda: int(eng.restore()["step"]))}
        eng.close()

    for codec, cfg in STRIPED.items():
        outcomes = {}
        for kills in itertools.chain(itertools.combinations(range(10), 1), itertools.combinations(range(10), 2)):
            eng, vec, _ = _vec_setup(make_engine, wrap, n=10, restore_chunk_bytes=512, **cfg)
            assert eng.checkpoint({"step": 1})
            orig = _restored(vec)
            for r in kills:
                eng.stores[r].wipe()
            for d in vec.data:
                d *= -1.0
            out = _outcome(eng.restore)
            outcomes["+".join(map(str, kills))] = out if isinstance(out, str) else bool(np.array_equal(_restored(vec), orig))
            eng.close()
        meta[f"striped/{codec}/ragged"] = outcomes


def run_async(out_path: str) -> None:
    from repro.core.checkpoint import CheckpointEngine, EngineConfig

    def make_engine(n, hook=None, **cfg):
        return CheckpointEngine(n, EngineConfig(**cfg), fault_hook=hook)

    arrays, meta = async_cases(make_engine, lambda e: e, np.asarray)
    _save(out_path, arrays, meta)


# ---------------------------------------------------------------------------
# Elastic N-to-M restore
# ---------------------------------------------------------------------------

# tests/test_elastic.py's grids
PLAN_OLD, PLAN_NEW = (1, 2, 3, 4, 6, 8), (1, 2, 3, 5, 6, 8, 12)
ROUNDTRIP_OLD, ROUNDTRIP_NEW = (1, 2, 4, 6, 8), (1, 3, 5, 6, 8, 12)
EXEC_PAIRS = ((4, 2), (4, 6), (3, 4), (8, 6))
EXEC_DTYPES = ("float32", "bfloat16", "int32")
ROW_NBYTES = [8, 20, 63, 8]  # tests/test_elastic.py's movement accounting


def elastic_global():
    """tests/test_elastic.py's fixture: a split leaf, a replicated one, a
    7-row leaf (7 divides almost no world size) and a 0-d one; with specs."""
    state = {
        "a": np.arange(48, dtype=np.float32).reshape(24, 2),
        "b": np.arange(5, dtype=np.float32),
        "c": np.arange(21, dtype=np.float32).reshape(7, 3),
        "step": np.asarray(11, np.int64),
    }
    specs = {"a": ("data", None), "b": (), "c": ("data", None), "step": ()}
    return state, specs


def elastic_exec_state(dtype: str):
    """The fixture in ``dtype`` (random values) plus a leaf split on its
    middle dim, for the executors."""
    import ml_dtypes

    rng = np.random.default_rng(13)
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)

    def draw(shape):
        if dtype == "int32":
            return rng.integers(-2**31, 2**31, shape).astype(np.int32)
        return rng.standard_normal(shape).astype(dt)

    state, specs = elastic_global()
    state = {**{k: draw(state[k].shape) for k in ("a", "b", "c")}, "e": draw((2, 12, 3)), "step": state["step"]}
    return state, {**specs, "e": (None, "data", None)}


def elastic_engine_state():
    """The fixture plus an f32 leaf whose shards are quantized under
    compress (at least 256 elements on every world size up to 12) and a
    bf16 leaf split on its middle dim."""
    import ml_dtypes

    rng = np.random.default_rng(17)
    state, specs = elastic_global()
    state = {**state, "d": rng.standard_normal((24, 256)).astype(np.float32),
             "e": rng.standard_normal((2, 24, 16)).astype(ml_dtypes.bfloat16)}
    return state, {**specs, "d": ("data", None), "e": (None, "data", None)}


def coords_json(coords) -> list:
    return [[[list(c.global_shape), c.axis, c.start, c.stop] for c in per_leaf] for per_leaf in coords]


def plan_json(p) -> dict:
    return {
        "n_old": p.n_old, "n_new": p.n_new,
        "targets": [sorted([i, t.start, t.stop, t.split] for i, t in tj.items()) for tj in p.targets],
        "segments": [[[s.leaf, s.origin, s.src_start, s.dst_start, s.rows, s.local] for s in sj]
                     for sj in p.segments],
        "bytes": [p.bytes_total, p.bytes_moved, p.bytes_lower_bound, p.movement_ratio],
        "notes": list(p.notes),
    }


def elastic_plan_cases(coords_for, plan_repartition, leaf_slice) -> dict:
    """The planner on tests/test_elastic.py's grid (residency: origin o
    stays resident on new rank o where it exists), its minimal-movement case
    and its missing-rows case. ``coords_for(n)`` gives the fixture's shard
    coordinates over n ranks."""
    out: dict = {"grid": {}, "minimal": {}}
    for n_old in PLAN_OLD:
        coords = coords_for(n_old)
        out["grid"][f"coords{n_old}"] = coords_json(coords)
        for n_new in PLAN_NEW:
            residency = {o: o if o < n_new else None for o in range(n_old)}
            out["grid"][f"{n_old}-{n_new}"] = plan_json(plan_repartition(coords, n_new, residency, ROW_NBYTES))
    for n_new in (2, 3, 4, 6, 12):
        residency = {0: 0, 1: 1, 2: None, 3: 2}  # rank 2's payload resident nowhere
        out["minimal"][str(n_new)] = plan_json(plan_repartition(coords_for(4), n_new, residency, ROW_NBYTES))
    try:
        plan_repartition([[leaf_slice((8, 2), 0, 0, 4)]], 1, {0: 0})  # rows [4, 8) held by nobody
        out["missing_rows"] = None
    except ValueError as e:
        out["missing_rows"] = type(e).__name__
    return out


def elastic_cases() -> list[tuple[str, int, int, int | None, bool]]:
    """(tag, n_old, n_new, killed rank, compress) of every engine case:
    tests/test_elastic.py's round trips, one failed rank 8 -> 6, grow after
    a failure 4 -> 12; each plain and compressed."""
    base = [(f"rt{a}-{b}", a, b, None) for a in ROUNDTRIP_OLD for b in ROUNDTRIP_NEW]
    base += [(f"kill{k}-8-6", 8, 6, k) for k in (0, 3, 7)]
    base += [("grow-4-12", 4, 12, 2)]
    return [(f"{tag}/c{int(c)}", a, b, k, c) for c in (False, True) for tag, a, b, k in base]


def elastic_engine_cases(setup, as_np) -> tuple[dict, dict]:
    """Every case of ``elastic_cases``: checkpoint on N (state + rng
    entities), zero the live state, wipe the killed rank, restore_elastic(M);
    record the restored state, the meta step, the world, the ElasticReport
    with its plans, the restore counters and the journal's "resize" record;
    then re-protect with a checkpoint on M and dump its committed stores.
    ``setup(n, compress, **cfg)`` returns (engine, live) where ``live`` has
    ``zero()``, ``leaves()`` (path -> numpy) and ``rng()``. Also records
    whether losing rank 2 and its pairwise partner raises, and runs
    ``ELASTIC_STRIPED``."""
    arrays, meta = {}, {}
    for tag, n_old, n_new, kill, compress in elastic_cases():
        _elastic_case(setup, as_np, arrays, meta, tag, n_old, n_new, () if kill is None else (kill,),
                      {"compress": compress})
    for tag, n_old, n_new, kills, cfg in ELASTIC_STRIPED:
        _elastic_case(setup, as_np, arrays, meta, tag, n_old, n_new, kills, cfg)
    eng, _ = setup(8, False)
    assert eng.checkpoint({"step": 1})
    for r in (2, 6):
        eng.stores[r].wipe()
    try:
        eng.restore_elastic(6)
        meta["lost"] = None
    except Exception as e:  # noqa: BLE001 - the class name is the result
        meta["lost"] = type(e).__name__
    return arrays, meta


# tests/test_codec.py::test_elastic_restore_after_rs_burst and its xor and lrc
# twins: (tag, N, M, wiped ranks, EngineConfig fields)
_RS = {"codec": "rs", "parity_group": 4, "rs_parity": 2}
ELASTIC_STRIPED = (
    *[(f"rs-burst-8-{m}", 8, m, (1, 2), _RS) for m in (3, 6, 12)],
    ("rs-burst-8-6/c1", 8, 6, (1, 2), {**_RS, "compress": True}),
    ("xor-8-6", 8, 6, (5,), {"parity_group": 4}),
    ("lrc-burst-8-6", 8, 6, (1, 2), {"codec": "lrc", "parity_group": 4}),
)


def _elastic_case(setup, as_np, arrays, meta, tag, n_old, n_new, kills, cfg) -> None:
    eng, live = setup(n_old, **cfg)
    assert eng.checkpoint({"step": 7})
    live.zero()
    for r in kills:
        eng.stores[r].wipe()
    got = eng.restore_elastic(n_new)
    rep = eng.last_elastic_report
    m = {
        "meta_step": int(got["step"]), "n_ranks": eng.n_ranks, "stores": sorted(eng.stores),
        "report": [rep.n_old, rep.n_new, rep.bytes_total, rep.bytes_moved, rep.bytes_lower_bound,
                   rep.movement_ratio],
        "plans": {name: plan_json(p) for name, p in sorted(rep.plans.items())},
        "adopted": eng.stats.adopted_restores, "zero_comm": eng.stats.zero_comm_restores,
        "reconstructed": eng.stats.reconstructed_restores,
        "resize": [{k: v for k, v in ev.items() if k not in ("ts", "duration_s")}
                   for ev in eng.journal.events("resize")],
        "rng": live.rng(),
    }
    for path, leaf in live.leaves().items():
        arrays[f"{tag}/restored/{path}"] = leaf
    assert eng.checkpoint({"step": 8})  # the new world re-protects itself
    a, d = dump_engine(eng, as_np)
    arrays.update({f"{tag}/{k}": v for k, v in a.items()})
    m.update(d)
    meta[tag] = m


def run_elastic(out_path: str) -> None:
    import jax.tree_util as jtu

    from repro.core.checkpoint import CheckpointEngine, EngineConfig
    from repro.core.serialization import LeafSlice
    from repro.elastic import plan_repartition, reshard_leaf_device, reshard_leaves
    from repro.runtime.state import RngEntity, ShardedStateEntity, ShardPlan

    def plan_for(state, specs):
        sds = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state)
        ps = jtu.tree_map(lambda t: P(*t), specs, is_leaf=lambda x: isinstance(x, tuple))
        return ShardPlan.from_pspecs(sds, ps)

    def paths(tree):
        return ["/".join(k.key for k in path) for path, _ in jtu.tree_flatten_with_path(tree)[0]]

    state0, specs0 = elastic_global()
    plan0 = plan_for(state0, specs0)
    meta: dict = {"plans": elastic_plan_cases(plan0.shard_coords, plan_repartition, LeafSlice)}
    arrays: dict = {}

    # the executors: host and Pallas gather (interpret mode), leaf by leaf
    meta["exec"] = {}
    for dtype in EXEC_DTYPES:
        state, specs = elastic_exec_state(dtype)
        plan = plan_for(state, specs)
        names = paths(state)
        for n_old, n_new in EXEC_PAIRS:
            ent = ShardedStateEntity(lambda: state, lambda s: None, plan)
            coords = plan.shard_coords(n_old)
            leaves = {o: jax.tree.leaves(s) for o, s in enumerate(ent.snapshot_shards(n_old))}
            axes = [ls.axis for ls in coords[0]]
            p = plan_repartition(coords, n_new, {o: o if o < n_new else None for o in range(n_old)})
            key = f"exec/{dtype}/{n_old}-{n_new}"
            meta["exec"][key] = plan_json(p)
            for j, new in enumerate(reshard_leaves(p, leaves, axes)):
                for i, leaf in enumerate(new):
                    arrays[f"{key}/host/{j}/{names[i]}"] = np.asarray(leaf)
                    if axes[i] is None:
                        continue
                    segs = [s for s in p.segments[j] if s.leaf == i]
                    dev = reshard_leaf_device({o: leaves[o][i] for o in range(n_old)}, segs, axes[i])
                    arrays[f"{key}/device/{j}/{names[i]}"] = np.asarray(dev)

    # the engine: restore_elastic round trips, plain and compressed
    state_e, specs_e = elastic_engine_state()
    plan_e = plan_for(state_e, specs_e)

    class Live:
        def __init__(self, box, rng):
            self.box, self.rng_ent = box, rng

        def zero(self):
            self.box["s"] = jax.tree.map(np.zeros_like, self.box["s"])
            self.rng_ent.seed = self.rng_ent.counter = 0

        def leaves(self):
            return dict(zip(paths(self.box["s"]), (np.asarray(x) for x in jax.tree.leaves(self.box["s"]))))

        def rng(self):
            return [self.rng_ent.seed, self.rng_ent.counter]

    def setup(n, compress=False, **cfg):
        box = {"s": jax.tree.map(np.copy, state_e)}
        rng = RngEntity()
        rng.seed, rng.counter = 7, 3
        eng = CheckpointEngine(n, EngineConfig(restore_mode="sync", compress=compress, **cfg))
        eng.register("state", ShardedStateEntity(lambda: box["s"], lambda s: box.update(s=s), plan_e))
        eng.register("rng", rng)
        return eng, Live(box, rng)

    a, m = elastic_engine_cases(setup, np.asarray)
    arrays.update(a)
    meta["engine"] = m
    _save(out_path, arrays, meta)


# The trainer cross-check: reduced llama3.2-1b, 20 steps, a checkpoint every
# 5, hosts 1 and 2 killed at steps 8 and 17, replaced from 4 spares.
TRAINER_CASE = dict(batch=4, seq=32, total_steps=20, checkpoint_period=5, n_virtual_hosts=4, n_spares=4)
TRAINER_KILLS = {8: [1], 17: [2]}
TRAINER_STEPS = 20


def _flat_np(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in p): np.asarray(x) for p, x in flat}


def run_trainer(out_path: str) -> None:
    """The reference Trainer through ``TRAINER_KILLS``: its initial state,
    every step's batch (a batch is a function of the step alone), the loss
    history, recoveries, created/aborted counts, the committed stores'
    manifests and the final state."""
    from repro.configs import get_config
    from repro.models import build_model
    from repro.runtime.failures import FailureInjector
    from repro.runtime.trainer import Trainer, TrainerConfig

    model = build_model(get_config("llama3.2-1b").reduced())
    t = Trainer(model, TrainerConfig(**TRAINER_CASE), injector=FailureInjector(4, schedule=TRAINER_KILLS))
    arrays = {f"init/{k}": v for k, v in _flat_np(jax.device_get(t.state)).items()}
    for step in range(TRAINER_STEPS):
        for k, v in t.data.peek(step).items():
            arrays[f"batch/{step}/{k}"] = np.asarray(v)
    hist = t.run(TRAINER_STEPS)
    arrays.update({f"final/{k}": v for k, v in _flat_np(jax.device_get(t.state)).items()})
    _, stores = dump_engine(t.engine, np.asarray)
    meta = {"history": [[h["step"], h["loss"]] for h in hist], "n_recoveries": t.n_recoveries,
            "created": t.engine.stats.created, "aborted": t.engine.stats.aborted,
            "manifests": {r: {"own": d["own"], "manifests": d["manifests"], "step": d["step"]}
                          for r, d in stores["stores"].items()}}
    _save(out_path, arrays, meta)


# The tier ladder's trainer cross-check: TRAINER_TIERS_CASE's reference
# Trainer loses all 4 hosts at step 12 with a disk rung flushed at every
# checkpoint (the legacy disk_path alias), escalates and finishes 20 steps;
# then a job of 12 steps on a tier_dir is closed and a fresh 3-host Trainer
# cold-restarts from its newest generation (4 -> 3) and runs to step 20.
TRAINER_TIERS_CASE = dict(batch=4, seq=32, total_steps=20, checkpoint_period=5, n_virtual_hosts=4)
TRAINER_TIERS_KILLS = {12: [0, 1, 2, 3]}


def run_trainer_tiers(out_path: str) -> None:
    """The reference Trainer through TRAINER_TIERS_KILLS and through the cold
    4 -> 3 restart: loss histories, recoveries, escalations, the restart's
    step and world, and both final states."""
    import os

    from repro.configs import get_config
    from repro.models import build_model
    from repro.runtime.failures import FailureInjector
    from repro.runtime.trainer import Trainer, TrainerConfig

    root = os.path.dirname(os.path.abspath(out_path))
    model = build_model(get_config("llama3.2-1b").reduced())
    t = Trainer(model, TrainerConfig(**TRAINER_TIERS_CASE, disk_path=os.path.join(root, "disk"), disk_every=1),
                injector=FailureInjector(4, schedule=TRAINER_TIERS_KILLS))
    loss = t.run(20)
    t.engine.close()
    arrays = {f"loss/{k}": v for k, v in _flat_np(jax.device_get(t.state)).items()}
    meta = {"loss": {"history": [[h["step"], h["loss"]] for h in loss], "n_recoveries": t.n_recoveries,
                     "escalations": t.engine.stats.tier_escalations}}
    tier = os.path.join(root, "tier")
    a = Trainer(model, TrainerConfig(**TRAINER_TIERS_CASE, tier_dir=tier, disk_flush_every=1))
    first = a.run(12)
    a.engine.close()
    b = Trainer(model, TrainerConfig(**{**TRAINER_TIERS_CASE, "n_virtual_hosts": 3}, tier_dir=tier,
                                     disk_flush_every=1))
    m = b.cold_restart()
    cold = b.run(20)
    b.engine.close()
    arrays.update({f"cold/{k}": v for k, v in _flat_np(jax.device_get(b.state)).items()})
    meta["cold"] = {"first": [[h["step"], h["loss"]] for h in first], "step": int(m["step"]),
                    "n_ranks": b.engine.n_ranks, "escalations": b.engine.stats.tier_escalations,
                    "history": [[h["step"], h["loss"]] for h in cold]}
    _save(out_path, arrays, meta)


PSUM_WORLD = 4


def psum_inputs() -> dict:
    """Per-rank gradient shards for ``compressed_psum`` (rank r's is row r):
    f32 of 8192 and of (2, 8192) elements, bf16 of 8192, with magnitudes
    spread over blocks; and a ragged f32 shard of 5000, which neither
    package reduces."""
    rng = np.random.default_rng(11)

    def grads(shape):
        spread = np.exp(rng.uniform(-6, 3, (PSUM_WORLD, *shape[:-1], shape[-1] // 256, 1)))
        x = rng.standard_normal((PSUM_WORLD, *shape[:-1], shape[-1] // 256, 256)) * spread
        return x.reshape(PSUM_WORLD, *shape).astype(np.float32)

    import ml_dtypes

    return {"f32": grads((8192,)), "f32_2d": grads((2, 8192)),
            "bf16": grads((8192,)).astype(ml_dtypes.bfloat16),
            "ragged": rng.standard_normal((PSUM_WORLD, 5000)).astype(np.float32)}


def run_psum(out_path: str) -> None:
    """Each case's per-rank results (identical on every rank), or the name
    of the exception the reference raised."""
    from jax.sharding import Mesh

    from repro.optim.grad_compress import compressed_psum
    from repro.sharding.mesh import shard_map

    mesh = Mesh(np.array(jax.devices()[:PSUM_WORLD]), ("d",))
    arrays, meta = {}, {}
    for name, x in psum_inputs().items():
        g = jnp.asarray(x.reshape(-1, *x.shape[2:]))  # the ranks' shards stacked on the leading dim
        fn = jax.jit(shard_map(lambda s: compressed_psum(s, "d"), mesh=mesh, in_specs=P("d"), out_specs=P("d"),
                               check_rep=False))
        try:
            out = np.asarray(fn(jax.device_put(g, NamedSharding(mesh, P("d")))))
        except Exception as e:  # the reference's failure on a ragged shard
            meta[name] = type(e).__name__
            continue
        arrays[name] = out.reshape(x.shape)
        meta[name] = "ok"
    _save(out_path, arrays, meta)


# Expert parallelism in the Trainer: the reduced mixtral with 16 experts (4
# do not divide the 16-way data axis of the trainer's production mesh, and
# "ep" would change nothing) and moe_mode="ep"; one checkpoint of the
# initial state.
TRAINER_EP_CASE = dict(batch=2, seq=32, total_steps=1, checkpoint_period=1, n_virtual_hosts=4)


def trainer_ep_config(get_config):
    return get_config("mixtral-8x7b").reduced().with_(num_experts=16, moe_mode="ep")


def run_trainer_ep(out_path: str) -> None:
    """The reference Trainer on ``trainer_ep_config``: its shard plan, its
    initial state, and the committed stores of one checkpoint of it."""
    from repro.configs import get_config
    from repro.models import build_model
    from repro.runtime.trainer import Trainer, TrainerConfig

    t = Trainer(build_model(trainer_ep_config(get_config)), TrainerConfig(**TRAINER_EP_CASE))
    arrays = {f"init/{k}": v for k, v in _flat_np(jax.device_get(t.state)).items()}
    assert t.engine.checkpoint({"step": 0})
    stored, stores = dump_engine(t.engine, np.asarray)
    arrays.update({f"store/{k}": v for k, v in stored.items()})
    meta = {"plan": {"dims": list(t.plan.dims), "shapes": [list(x) for x in t.plan.shapes]}, **stores}
    _save(out_path, arrays, meta)


# The sharded Trainer: the reference's Trainer(mesh=) on (2, 2) ("data",
# "model"), a jax.sharding.Mesh over devices 0-3 row-major. jax.make_mesh gives
# Explicit axes in jax 0.9, under which the reference's constrain raises, so
# the mesh is built over the devices (Auto axes). The fsdp preset takes
# TRAINER_MESH_FSDP_STEPS steps of TRAINER_CASE with no kill.
MESH_SHAPE = ((2, 2), ("data", "model"))
TRAINER_MESH_FSDP_STEPS = 4
# (mesh sizes, axis names, array shape, spec): the specs the sharded step
# lays out, multi-axis entries and an uneven mix
MESH_PLACEMENT_CASES = (
    ((2, 2), ("data", "model"), (256, 64), (None, "model")),
    ((2, 2), ("data", "model"), (64, 4, 16), ("data", "model")),
    ((2, 2), ("data", "model"), (8, 32), ("data",)),
    ((2, 2), ("data", "model"), (128, 12), (("data", "model"),)),
    ((2, 2), ("data", "model"), (6, 8, 4), (None, ("data", "model"), None)),
    ((2, 2), ("data", "model"), (), ()),
    ((2, 2, 2), ("pod", "data", "model"), (16, 8), (("pod", "data"), "model")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 24), ("model", ("pod", "data"))),
    ((2, 2, 2), ("pod", "data", "model"), (32,), (("pod", "data", "model"),)),
)


def reference_mesh(sizes, names):
    """A ``jax.sharding.Mesh`` over the first devices in row-major order (Auto
    axes)."""
    n = int(np.prod(sizes))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(sizes), names)


def run_trainer_mesh(out_path: str) -> None:
    """The reference Trainer(mesh=) through ``TRAINER_KILLS`` (history,
    recoveries, created/aborted, committed manifests, final state); the
    fsdp preset's first steps on the same mesh; each placement case's
    device -> index map."""
    from repro.configs import get_config
    from repro.models import build_model
    from repro.runtime.failures import FailureInjector
    from repro.runtime.trainer import Trainer, TrainerConfig

    mesh = reference_mesh(*MESH_SHAPE)
    cfg = get_config("llama3.2-1b").reduced()
    t = Trainer(build_model(cfg), TrainerConfig(**TRAINER_CASE), mesh=mesh,
                injector=FailureInjector(4, schedule=TRAINER_KILLS))
    hist = t.run(TRAINER_STEPS)
    arrays = {f"final/{k}": v for k, v in _flat_np(jax.device_get(t.state)).items()}
    _, stores = dump_engine(t.engine, np.asarray)
    meta = {"history": [[h["step"], h["loss"]] for h in hist], "n_recoveries": t.n_recoveries,
            "created": t.engine.stats.created, "aborted": t.engine.stats.aborted,
            "manifests": {r: {"own": d["own"], "manifests": d["manifests"], "step": d["step"]}
                          for r, d in stores["stores"].items()}}
    tf = Trainer(build_model(cfg.with_(sharding_preset="fsdp")), TrainerConfig(**TRAINER_CASE), mesh=mesh)
    meta["fsdp_history"] = [[h["step"], h["loss"]] for h in tf.run(TRAINER_MESH_FSDP_STEPS)]
    arrays.update({f"fsdp/{k}": v for k, v in _flat_np(jax.device_get(tf.state)).items()})
    maps = []
    for sizes, names, shape, spec in MESH_PLACEMENT_CASES:
        m = reference_mesh(sizes, names)
        idx = NamedSharding(m, P(*spec)).devices_indices_map(shape)
        maps.append([[list(sl.indices(n)[:2]) for sl, n in zip(idx[d], shape)] for d in m.devices.reshape(-1)])
    meta["placements"] = maps
    _save(out_path, arrays, meta)


# The rest of the sharded train step: every family on the same mesh.
# (name, arch, config overrides, steps, killed): the kill runs go through
# ZOO_KILLS; the others take a few clean steps. The MoE runs are held
# against the reference over their first ZOO_MOE_COMPARED steps (routing
# ties part the trajectories after a few steps).
ZOO_CASE = dict(batch=4, seq=32, total_steps=20, checkpoint_period=2, n_virtual_hosts=4, n_spares=4)
ZOO_KILLS = {3: [1]}
ZOO_RUNS = (
    ("mixtral-tp", "mixtral-8x7b", {}, 5, True),
    ("mixtral-ep", "mixtral-8x7b", {"num_experts": 16, "moe_mode": "ep"}, 5, True),
    ("mamba2", "mamba2-780m", {}, 5, True),
    ("jamba", "jamba-1.5-large-398b", {}, 2, False),
    ("hubert", "hubert-xlarge", {}, 3, False),
    ("vlm", "llama-3.2-vision-90b", {}, 3, False),
    ("gemma2", "gemma2-2b", {}, 3, False),
)
ZOO_MOE_COMPARED = 3
ZOO_FINAL = ("mamba2", "hubert", "vlm", "gemma2")  # final states held against the reference


def run_trainer_mesh_zoo(out_path: str) -> None:
    """The reference Trainer(mesh=) for every run of ``ZOO_RUNS``: history
    and recoveries, and the final state of ``ZOO_FINAL``'s."""
    from repro.configs import get_config
    from repro.models import build_model
    from repro.runtime.failures import FailureInjector
    from repro.runtime.trainer import Trainer, TrainerConfig

    mesh = reference_mesh(*MESH_SHAPE)
    arrays, meta = {}, {}
    for name, arch, over, steps, killed in ZOO_RUNS:
        inj = FailureInjector(4, schedule=ZOO_KILLS) if killed else None
        t = Trainer(build_model(get_config(arch).reduced().with_(**over)), TrainerConfig(**ZOO_CASE), mesh=mesh,
                    injector=inj)
        hist = t.run(steps)
        meta[name] = {"history": [[h["step"], h["loss"]] for h in hist], "n_recoveries": t.n_recoveries}
        if name in ZOO_FINAL:
            arrays.update({f"{name}/{k}": v for k, v in _flat_np(jax.device_get(t.state)).items()})
    _save(out_path, arrays, meta)


# The recovery policies and the out-of-run calls on the mesh: the reduced
# llama with no spares loses host 2 at step 4 under "shrink" and under
# "elastic"; then, with a spare and a disk rung flushed at every commit,
# run(4), restore_elastic(2), regrow(4), run(6), and a fresh 2-host job's
# cold_restart() and run(POLICY_RESUME_STEPS).
POLICY_CASE = dict(batch=4, seq=32, total_steps=20, checkpoint_period=3, n_virtual_hosts=4, n_spares=0)
POLICY_KILLS = {4: [2]}
POLICY_STEPS = 7
OUT_OF_RUN_CASE = dict(POLICY_CASE, n_spares=1, disk_flush_every=1)
POLICY_RESUME_STEPS = 8


def _engine_meta(t) -> dict:
    _, stores = dump_engine(t.engine, np.asarray)
    return {"n_ranks": t.engine.n_ranks, "created": t.engine.stats.created, "aborted": t.engine.stats.aborted,
            "manifests": {r: {"own": d["own"], "manifests": d["manifests"], "step": d["step"]}
                          for r, d in stores["stores"].items()}}


def run_trainer_mesh_policies(out_path: str) -> None:
    """The reference Trainer(mesh=) under "shrink" and "elastic" through
    ``POLICY_KILLS``, and through the out-of-run calls: each run's history,
    recoveries, engine (rank count, created, aborted, committed manifests)
    and final state."""
    import os

    from repro.configs import get_config
    from repro.models import build_model
    from repro.runtime.failures import FailureInjector
    from repro.runtime.trainer import Trainer, TrainerConfig

    def hist(h):
        return [[x["step"], x["loss"]] for x in h]

    mesh = reference_mesh(*MESH_SHAPE)
    model = build_model(get_config("llama3.2-1b").reduced())
    arrays, meta = {}, {}
    for policy in ("shrink", "elastic"):
        t = Trainer(model, TrainerConfig(**POLICY_CASE, recovery_policy=policy), mesh=mesh,
                    injector=FailureInjector(4, schedule=POLICY_KILLS))
        meta[policy] = {"history": hist(t.run(POLICY_STEPS)), "n_recoveries": t.n_recoveries, **_engine_meta(t)}
        arrays.update({f"{policy}/{k}": v for k, v in _flat_np(jax.device_get(t.state)).items()})
    tier = os.path.join(os.path.dirname(os.path.abspath(out_path)), "policy_tier")
    a = Trainer(model, TrainerConfig(**OUT_OF_RUN_CASE, tier_dir=tier), mesh=mesh)
    out = {"first": hist(a.run(4))}
    out["elastic_step"] = int(a.restore_elastic(2)["step"])
    out["after_elastic"] = _engine_meta(a)
    a.regrow(4)
    out["after_regrow"] = _engine_meta(a)
    out["second"] = hist(a.run(6))
    out["end"] = _engine_meta(a)
    a.engine.close()
    arrays.update({f"out/{k}": v for k, v in _flat_np(jax.device_get(a.state)).items()})
    b = Trainer(model, TrainerConfig(**{**OUT_OF_RUN_CASE, "n_virtual_hosts": 2}, tier_dir=tier), mesh=mesh)
    out["cold_step"] = int(b.cold_restart()["step"])
    out["cold"] = _engine_meta(b)
    out["resumed"] = hist(b.run(POLICY_RESUME_STEPS))
    out["n_recoveries"] = [a.n_recoveries, b.n_recoveries]
    b.engine.close()
    arrays.update({f"cold/{k}": v for k, v in _flat_np(jax.device_get(b.state)).items()})
    meta["out"] = out
    _save(out_path, arrays, meta)


MOE_ARCHS = ("mixtral-8x7b", "grok-1-314b", "jamba-1.5-large-398b")


def dryrun_cases() -> list[tuple[str, str]]:
    """(arch, moe_mode) of the dry-run comparison: every config under "tp",
    the MoE configs under "ep" too."""
    from repro.configs import list_archs

    return [(a, "tp") for a in list_archs()] + [(a, "ep") for a in MOE_ARCHS]


def run_dryrun(out_path: str) -> None:
    """What the reference's dry run records without compiling, on both
    production meshes (run with 512 host devices): applicability, parameter
    and token counts of every (arch, shape); each applicable cell's
    per-device argument bytes (``in_shardings[i].shard_shape``) under every
    case of ``dryrun_cases``; and the train state's snapshot (copy) and
    striped restore (rs, g=4, m=2) programs' byte accounting."""
    import math

    from repro.configs import SHAPES, applicability, get_config
    from repro.core.device_tier import cached_snapshot_program, cached_striped_restore_program
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import build_step

    meshes = {"single": make_production_mesh(), "multi": make_production_mesh(multi_pod=True)}
    cells, verdicts = {}, {}
    for arch, mode in dryrun_cases():
        cfg = get_config(arch).with_(moe_mode=mode)
        for sname, shape in SHAPES.items():
            ok, reason = applicability(cfg, shape)
            if mode == "tp":
                verdicts[f"{arch}/{sname}"] = [ok, reason]
            if not ok:
                continue
            for mname, mesh in meshes.items():
                b = build_step(cfg, sname, mesh)
                args = []
                for sds, sh in zip(b.args_sds, b.in_shardings):
                    leaves = jax.tree.leaves(sds)
                    shs = jax.tree.leaves(sh, is_leaf=lambda x: isinstance(x, NamedSharding))
                    args.append(sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
                                    for x, s in zip(leaves, shs)))
                rec = {"args": args, "n_params": b.model.n_params, "n_active_params": b.model.n_active_params,
                       "tokens": shape.tokens if shape.kind != "decode" else shape.global_batch}
                if sname == "train_4k":
                    pspecs = jax.tree.map(lambda s: s.spec, b.in_shardings[0])
                    snap = cached_snapshot_program(mesh, b.args_sds[0], pspecs, redundancy_axis="data")
                    rest = cached_striped_restore_program(mesh, b.args_sds[0], pspecs, redundancy_axis="data",
                                                          codec="rs", parity_group=4, rs_parity=2)
                    rec["snapshot"] = [snap.exchanged_bytes, snap.own_bytes, snap.pcie_bytes, len(snap.buckets)]
                    rec["restore"] = [rest.pcie_bytes, rest.host_decode_pcie_bytes, len(rest.buckets)]
                cells[f"{arch}/{mode}/{sname}/{mname}"] = rec
    _save(out_path, {}, {"cells": cells, "applicability": verdicts})


def _save(out_path: str, arrays: dict, meta: dict) -> None:
    # bf16 leaves travel as their 16-bit patterns (npz has no bf16)
    enc = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if v.dtype.name == "bfloat16":
            enc[k + "#bf16"] = v.view(np.uint16)
        else:
            enc[k] = v
    np.savez(out_path, **enc)
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f)


def load(out_path: str) -> tuple[dict, dict]:
    """The oracle's arrays (bf16 restored as ml_dtypes) and metadata."""
    import ml_dtypes

    arrays = {}
    with np.load(out_path) as z:
        for k in z.files:
            if k.endswith("#bf16"):
                arrays[k[: -len("#bf16")]] = z[k].view(ml_dtypes.bfloat16)
            else:
                arrays[k] = z[k]
    with open(out_path + ".json") as f:
        return arrays, json.load(f)


if __name__ == "__main__":
    {"device_tier": run_device_tier, "state": run_state, "engine": run_engine,
     "elastic": run_elastic, "trainer": run_trainer, "async": run_async,
     "trainer_tiers": run_trainer_tiers, "psum": run_psum, "dryrun": run_dryrun,
     "trainer_ep": run_trainer_ep, "trainer_mesh": run_trainer_mesh, "trainer_mesh_zoo": run_trainer_mesh_zoo,
     "trainer_mesh_policies": run_trainer_mesh_policies}[sys.argv[1]](sys.argv[2])
