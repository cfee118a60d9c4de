#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py`` on a machine with no card: every phase, on the
CPU, at a small config, in seconds.

    python3 tools/rehearse_chip_smoke.py            # all phases through main()
    python3 tools/rehearse_chip_smoke.py --phase7   # the training loop alone, both checkpoint modes
    python3 tools/rehearse_chip_smoke.py --phase11  # the model zoo alone
    python3 tools/rehearse_chip_smoke.py --phase12  # the encoder and the VLM alone
    python3 tools/rehearse_chip_smoke.py --phase13  # the phase-field application alone
    python3 tools/rehearse_chip_smoke.py --phase4b  # the device-tier path, then the dry run's accounting of it
    python3 tools/rehearse_chip_smoke.py --phase4c  # the device tier over 8 processes (gloo on the CPU)
    python3 tools/rehearse_chip_smoke.py --phase7c  # phase 7's sync run and the sharded Trainer on 4 processes
                                                    # (llama, then Mamba-2 and mixtral at small_zoo's sizes)

It runs a copy of ``chip_smoke.py``'s source in which the card is the CPU:
``"cuda"`` strings and ``.cuda()`` calls name the CPU, every entry point of
the port resolves its default device to the CPU, the CUDA timing, memory
and device calls are stubbed, nothing is built and no raw kernel is
launched (the kernel wrappers take their plain versions on CPU tensors), and
the launch counts read one for every kernel but the row gather, the
runtime-matrix GF(2^8) product and the checksum, whose plain runs are
counted for real (phase 6 checks the gather's exact count, phases 8 and 8b
that the product ran, phase 4 that the mirror program folded its checksum),
and every host tensor reports itself pinned (the engine on the CPU leases
pageable arenas); the profiler traces the CPU only. Phase
9's tier directories go under a temporary directory, removed at the end;
where the machine lacks ``os.posix_fadvise`` or ``/proc/mounts``, the page
cache drop and the filesystem probe are stubbed; its process runs this same
CPU copy. Phase 10 serves prompts of
64 tokens in a 128-token cache (the runs, kills and checks unchanged), and
so does phase 11, whose Mamba-2 and mixtral configs shrink to 2 and 1
layers of d_model 256 (``small_zoo``), and phase 12, whose hubert and VLM
configs shrink to 2 layers and one period of d_model 256
(``small_encoder_vlm``; its ``compressed_psum`` runs in a gloo group), and
phase 13 runs the phase-field drills on a 256 x 256 field. What
it finds are wrong paths, shapes, arguments and control flow; its times
mean nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import types
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))  # phase 4c's processes import chip_smoke by name

import repro_torch.sharding.mesh as mesh_mod  # noqa: E402  (before the rest of the port)

_resolve = mesh_mod.resolve_device
mesh_mod.resolve_device = lambda device=None: _resolve(
    "cpu" if device is None or str(device).startswith("cuda") else device)

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import checkpoint  # noqa: E402
from repro_torch.kernels import _build, checksum, ops, reshard, rs_decode  # noqa: E402

KERNELS = ("xor_reduce", "gf256_matmul", "quantize_blockwise", "dequantize_blockwise")
_get_config = configs.get_config  # the real one: the rehearsal's returns its small config


class _Event:
    def __init__(self, **_) -> None:
        pass

    def record(self, *_) -> None:
        pass

    def elapsed_time(self, _) -> float:
        return 1.0


def small_config():
    return replace(configs.get_config("llama3.2-1b"), num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
                   head_dim=64, d_ff=512, vocab_size=1000)


def small_zoo():
    """Phase 11's (Mamba-2, mixtral) pair at d_model 256: 2 layers of 4 SSD
    heads of 64 with state 32, and 1 layer of 8 experts top-2 of d_ff 512."""
    ssm = replace(_get_config("mamba2-780m"), num_layers=2, d_model=256, ssm_state=32, vocab_size=1000)
    moe = replace(_get_config("mixtral-8x7b"), num_layers=1, d_model=256, num_heads=4, num_kv_heads=2,
                  head_dim=64, d_ff=512, vocab_size=1000)
    return ssm, moe


def small_encoder_vlm():
    """Phase 12's (hubert, VLM) pair at d_model 256: 2 encoder layers of 4
    heads of 64 over 512-wide frames, and one period of the VLM (4 self and
    1 cross slot) over 100 vision tokens of width 64, in attention chunks of
    64 (so the vision keys pad)."""
    enc = replace(_get_config("hubert-xlarge"), num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
                  head_dim=64, d_ff=512)
    vlm = replace(_get_config("llama-3.2-vision-90b"), num_layers=5, d_model=256, num_heads=4, num_kv_heads=2,
                  head_dim=64, d_ff=512, vocab_size=1000, vision_tokens=100, frontend_stub_dim=64,
                  attn_chunk=64)
    return enc, vlm


def rehearse_tier_body(rank: int, world: int, init_method: str, cfg, tier_root: str) -> dict:
    """Phase 9's process in the rehearsal: the same CPU copy of
    ``chip_smoke.py``, its tier directories under the parent's."""
    mod = load_chip_smoke(cfg)
    shutil.rmtree(mod.TIER_ROOT, ignore_errors=True)
    mod.TIER_ROOT = Path(tier_root)
    return mod.tier_body(rank, world, init_method, cfg)


def load_chip_smoke(cfg) -> types.ModuleType:
    src = (ROOT / "chip_smoke.py").read_text()
    src = src.replace('"cuda"', '"cpu"').replace(".cuda()", '.to("cpu")')
    mod = types.ModuleType("chip_smoke")
    mod.__file__ = str(ROOT / "chip_smoke.py")
    exec(compile(src, "chip_smoke.py (CPU rehearsal)", "exec"), mod.__dict__)
    # phase 4c hands its processes ``chip_smoke.rank_body`` by name: they run
    # the real module, on the device the parent names (the CPU here)
    sys.modules["chip_smoke"] = mod
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.Event = _Event
    torch.cuda.max_memory_allocated = torch.cuda.memory_allocated = lambda *a: 0
    torch.cuda.is_available = lambda: True
    torch.cuda.get_device_name = lambda *a: "CPU rehearsal"
    torch.cuda.device_count = lambda: 1
    torch.Tensor.is_pinned = lambda self, *a: True
    _build.build = lambda *a: {}
    _build.lib_path = lambda name: ROOT / "chip_smoke.py"  # "built": nothing is, nothing launches
    _build.call = _build.stream_of = lambda *a, **k: None
    torch.Tensor.pin_memory = lambda self, *a: self
    profile = torch.profiler.profile  # no CUDA activity to trace on the CPU
    torch.profiler.profile = lambda activities=(), **k: profile(
        activities=[a for a in activities if a != torch.profiler.ProfilerActivity.CUDA], **k)
    gathers = [1]
    copy_runs = reshard.copy_runs_into

    def counted_copy(sources, out, table, *a, **k):
        gathers[0] += table.shape[0] > 0
        return copy_runs(sources, out, table, *a, **k)

    reshard.copy_runs_into = counted_copy
    decodes = [1]
    decode = rs_decode.rs_decode_into

    def counted_decode(*a, **k):
        decodes[0] += 1
        return decode(*a, **k)

    rs_decode.rs_decode_into = counted_decode
    checksums = [1]
    checksum_rows = checksum.checksum_rows

    def counted_checksum(*a, **k):
        checksums[0] += 1
        return checksum_rows(*a, **k)

    checksum.checksum_rows = counted_checksum
    ops.launch_counts = lambda: {**{k: 1 for k in KERNELS}, "gather_rows": gathers[0],
                                 "gf256_matmul_dyn": decodes[0], "checksum": checksums[0]}
    ops.reset_launch_counts = lambda: None
    checkpoint.reshard_leaves = checkpoint.reshard_leaves_device  # the engine picks the host one on the CPU
    for name in ("sass_phase", "free_pinned_cache"):
        setattr(mod, name, lambda *a: None)
    mod.kernel_tests_phase = lambda: lambda: None
    mod.gpu_line = lambda: "CPU rehearsal, 0 W"
    mod.get_config = configs.get_config = lambda name: cfg
    mod.zoo_configs = small_zoo
    mod.encoder_vlm_configs = small_encoder_vlm
    mod.PSUM_BACKEND = "gloo"
    mod.TIER_ROOT = Path(tempfile.mkdtemp(prefix="rehearse-tiers-"))

    def start_tier(cfg):  # phase 9's process runs this copy too, not the real module
        from repro_torch.launch.mesh import RankGroup

        group = RankGroup(rehearse_tier_body, 1, args=(cfg, str(mod.TIER_ROOT)))
        group.started = time.time()
        return group

    mod.start_tier = start_tier
    # at this width a rank's exchange bytes span two chunks of the default
    # 1 MiB dirty map: both layers and a 4 KiB grid keep phase 9's rewrite
    # of layer 0 under the crossover, so its creates take the patch path
    mod.TIER_LAYERS = cfg.num_layers
    mod.TIER_CFG = {**mod.TIER_CFG, "delta_chunk_bytes": 4096}
    # phase 10 at this config: the same batch, decoded tokens, checkpoint
    # interval and kills, prompts of 64 in a cache of 128
    mod.SERVE = {**mod.SERVE, "max_seq": 128}
    mod.SERVE_PROMPT = 64
    mod.PF_SHAPE = (256, 256)  # 8 hosts of 32 rows
    # phase 4c's and 7c's processes run the kernels' plain versions, which
    # count nothing
    mod.RANK_KERNELS = ()
    mod.MESH7C_KERNELS = mod.MESH7C_SSM_KERNELS = ()
    mod.PHASE4_LAYERS = cfg.num_layers
    if not hasattr(os, "posix_fadvise"):
        mod.drop_cached = lambda root: False
    if not os.path.exists("/proc/mounts"):
        mod.dir_probe = lambda path: dict(path=str(path), mount="?", fstype="?",
                                          free_gb=shutil.disk_usage(path).free / 1e9)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase7", action="store_true", help="run the training loop's phase alone")
    ap.add_argument("--phase11", action="store_true", help="run the model zoo's phase alone")
    ap.add_argument("--phase12", action="store_true", help="run the encoder and VLM phase alone")
    ap.add_argument("--phase13", action="store_true", help="run the phase-field phase alone")
    ap.add_argument("--phase4b", action="store_true",
                    help="run the device-tier path (phase 4) and the dry run's accounting of it alone")
    ap.add_argument("--phase4c", action="store_true", help="run the device tier over processes alone")
    ap.add_argument("--phase7c", action="store_true",
                    help="run phase 7's sync run and the sharded Trainer over processes alone")
    args = ap.parse_args()
    torch.set_num_threads(4)
    cfg = small_config()
    mod = load_chip_smoke(cfg)
    if not (args.phase7 or args.phase11 or args.phase12 or args.phase13 or args.phase4b or args.phase4c
            or args.phase7c):
        try:
            return mod.main()
        finally:
            shutil.rmtree(mod.TIER_ROOT, ignore_errors=True)
    mod._HOST_START[:] = [mod.host_free_gib(), mod.host_rss_gib()]
    if args.phase4b:
        from repro_torch.launch.steps import init_train_state, train_state_layout
        from repro_torch.sharding.mesh import make_mesh

        mesh = make_mesh((8, 1), ("data", "model"), device="cpu")
        layout = train_state_layout(cfg, mesh)
        state = init_train_state(layout, mesh, torch.Generator().manual_seed(mod.SEED))
        cli = mod.DryrunCli()
        try:
            counts, runs = mod.device_tier_path(state, layout, mesh)
            out = mod.dryrun_path(cfg, state, layout, mesh, runs, cli)
        finally:
            cli.stop()
        print(json.dumps({k: v for k, v in out.items() if k != "cli"}))
        return 0
    if args.phase4c:
        counts, runs = mod.rank_path(cfg, mod.start_ranks(cfg))
        print(json.dumps(runs))
        return 0
    if args.phase7c:
        one = replace(cfg, num_layers=mod.TRAIN_LAYERS)
        group = mod.start_mesh_trainer(one)
        try:
            mod.feed_mesh_trainer(group)
            run, _ = mod.trainer_path(one, "sync")
            ssm, moe = small_zoo()
            mod.feed_mesh_zoo(group, ssm, moe)
            counts, runs = mod.mesh_trainer_path(group, run["loss"], {"phase 7 (sync)": time.time()})
        finally:
            group.stop()
        one_card, _ = mod.trainer_path(ssm, "sync", engine=checkpoint.EngineConfig(**mod.ZOO_TRAIN_ENGINE),
                                       train=mod.ZOO_TRAIN, label="zoo trainer")
        mod.check_mesh_ssm_losses(runs["ssm"], one_card["loss"])
        print(json.dumps(runs))
        return 0
    if args.phase13:
        counts, runs = mod.phase_field_path()
        print(json.dumps(runs))
        print(json.dumps(counts))
        return 0
    if args.phase11 or args.phase12:
        counts, runs = mod.zoo_path() if args.phase11 else mod.encoder_vlm_path()
        print(json.dumps(counts))
        return 0
    for mode in ("sync", "async"):
        run, counts = mod.trainer_path(cfg, mode)
        print(json.dumps(run))
        print(json.dumps(counts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
