"""JAX side of the port's comparison tests, run in a subprocess with eight
virtual CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``).

``python tests/_torch_jax_oracle.py device_tier OUT.npz`` runs the device-tier
cases; ``... state OUT.npz`` runs the llama3.2-1b layout and slice cases;
``... engine OUT.npz`` runs the host-tier checkpoint engine's cases;
``... elastic OUT.npz`` the elastic N-to-M planner, reshard executors and
``restore_elastic`` cases. The arrays go to the ``.npz``, the metadata to
``OUT.npz.json``.

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
CASES = (("copy", "copy", 0, 2), ("xor2", "xor", 2, 1), ("rs2", "rs", 2, 2), ("rs3", "rs", 3, 2))


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
    """Every committed store of an engine: own arenas and held copies (bytes)
    and their manifests, the handshake and exchange checksums, the
    replicated manifest table. ``as_np`` turns a flat buffer into numpy."""
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

    # ShardedStateEntity + RngEntity over 4 ranks, compressed and not
    state_np, specs = engine_state()
    sds = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), state_np)
    ps = jtu.tree_map(lambda t: P(*t), specs, is_leaf=lambda x: isinstance(x, tuple))
    plan = ShardPlan.from_pspecs(sds, ps)
    for compress in (False, True):
        tag = f"state{int(compress)}"
        box = {"s": jax.tree.map(np.copy, state_np)}
        eng = make_engine(4, compress=compress)
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
    ``setup(n, compress)`` returns (engine, live) where ``live`` has
    ``zero()``, ``leaves()`` (path -> numpy) and ``rng()``. Also records
    whether losing rank 2 and its pairwise partner raises."""
    arrays, meta = {}, {}
    for tag, n_old, n_new, kill, compress in elastic_cases():
        eng, live = setup(n_old, compress)
        assert eng.checkpoint({"step": 7})
        live.zero()
        if kill is not None:
            eng.stores[kill].wipe()
        got = eng.restore_elastic(n_new)
        rep = eng.last_elastic_report
        m = {
            "meta_step": int(got["step"]), "n_ranks": eng.n_ranks, "stores": sorted(eng.stores),
            "report": [rep.n_old, rep.n_new, rep.bytes_total, rep.bytes_moved, rep.bytes_lower_bound,
                       rep.movement_ratio],
            "plans": {name: plan_json(p) for name, p in sorted(rep.plans.items())},
            "adopted": eng.stats.adopted_restores, "zero_comm": eng.stats.zero_comm_restores,
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

    def setup(n, compress):
        box = {"s": jax.tree.map(np.copy, state_e)}
        rng = RngEntity()
        rng.seed, rng.counter = 7, 3
        eng = CheckpointEngine(n, EngineConfig(restore_mode="sync", compress=compress))
        eng.register("state", ShardedStateEntity(lambda: box["s"], lambda s: box.update(s=s), plan_e))
        eng.register("rng", rng)
        return eng, Live(box, rng)

    a, m = elastic_engine_cases(setup, np.asarray)
    arrays.update(a)
    meta["engine"] = m
    _save(out_path, arrays, meta)


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
     "elastic": run_elastic}[sys.argv[1]](sys.argv[2])
