"""JAX side of the port's comparison tests, run in a subprocess with eight
virtual CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``).

``python tests/_torch_jax_oracle.py device_tier OUT.npz`` runs the device-tier
cases; ``... state OUT.npz`` runs the llama3.2-1b layout and slice cases. The
arrays go to the ``.npz``, the metadata to ``OUT.npz.json``.
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
    {"device_tier": run_device_tier, "state": run_state}[sys.argv[1]](sys.argv[2])
