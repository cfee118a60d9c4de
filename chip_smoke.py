#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build the kernels, hold
each against its plain PyTorch version, train full-width llama3.2-1b
through a host failure with the fault-tolerant training loop, serve it
through host failures with the fault-tolerant server, train a full-width
Mamba-2 and serve a full-width Mixtral and Mamba-2 through kills, train a
full-width HuBERT encoder and serve a full-width vision-language model
through kills, run the paper's phase-field application on an 8192 x 8192
field through kills and a two-host burst, then create and restore the llama
train state through the device tier and through the host-tier checkpoint
engine.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``); it exits non-zero,
printing no result, on any failure or without a card. Phases:

1. build: one ``nvcc`` per kernel source, all at once (the two GF(2^8)
   sources in parts, see ``kernels/_build.py``), timed; the card's
   name and power limit; the GF(2^8) kernels' issued instructions per word
   by pipe, read from their SASS (``tools/sass_mix.py``);
2. kernel tests: ``pytest -m cuda tests/test_torch_cuda.py`` in a child
   process, started right after the build so that it runs while phase 1
   disassembles the GF(2^8) libraries on the host (the host's free memory
   is read once it has ended): B1-B6 against their plain versions at ragged small sizes
   (quantize: f32/bf16/f16, unaligned inputs, all-zero blocks, values on the
   round-half-even boundaries; gather: f32/bf16/int8/int32 rows of 1 byte to
   512 KiB, unaligned rows, repeated and reversed indices, 0 and 1 output
   rows, the run-table kernel on heads and tails 1-15 bytes off 16, runs
   under 16 bytes, a permutation, 5,000 runs, and the in-place reshard
   against the host executor), the device tier on the card against the CPU path (f32/bf16/int8
   leaves, padded shards, ragged groups, every tolerated failure
   combination, compress=True), and the host engine and its
   ``restore_elastic`` with the state on the card against the same engine on
   the CPU;
3. kernels at the main path's shapes (the encode outputs are stripe-slot
   views of a payload tensor, the decode runs at both runs' shapes, the
   quantize pair at the device-tier bucket's): each bit-equal to its plain
   version, with its time, its plain version's, a PyTorch call's where one
   computes the same function, and its bound (the largest of the bytes over
   HBM, the integer work on the ALU and FMA pipes and through dispatch, and
   f32 work), each resource's time printed; B5b and ``torch.mul`` in
   alternating rounds;
4. device-tier path: the llama3.2-1b train state at ``PHASE4_LAYERS`` (8)
   of its 16 layers, width kept (10.49 GB, seeded), on a
   virtual (8, 1) ("data", "model") mesh, with rs g=4 m=2, with xor g=4 and
   with lrc g=4 (2 local XOR rows over 2 Cauchy rows, ranks 0 and 1 of one
   local subgroup killed):
   snapshot with the device checksum (held against ``np_checksum`` of the
   staged host bytes), staged fetch to pinned host memory (twice: first
   with fresh pinned buffers, then reusing them), ranks killed, parity
   uploaded, striped restore, every leaf compared; then the copy codec with
   compress=True: int8 partner codes and scales bit-equal to the plain
   quantize of the same bucket, the staged fetch, and the fetched partner
   dequantized on the card within half a step of the original; then the
   hot-replica transport, ``build_mirror_program`` with validate=True: its
   folded checksum (B1) equal to the main runs', its mirrored buckets,
   re-aligned by the copy codec's ``restore_fn``, byte-equal to every
   exchanged leaf;
4b. the dry run's accounting (``launch/dryrun.py``) of phase 4's layout
   held against what phase 4 moved and what the card holds: the snapshot
   cells' own and PCIe bytes equal the pinned host buffers each staged
   fetch filled, the restore cells' PCIe bytes the stripes uploaded plus
   the leaves rebuilt on the card, and the train cell's per-device state
   bytes those of each rank's shard tensors of the state on the card
   (times 8: the state plus 7 copies of the leaves every rank holds
   whole); then the records of the dry-run CLI (``DRYRUN_CLI``) on meta
   tensors, run on one thread in a child process beside phases 12, 13 and 4, printed
   and checked. It measures bytes, not time;
4c. the device tier over processes: phase 4's layout cut to 1 layer
   (``RANK_LAYERS``, 4.53 GB, width kept) as 8 processes, one per coordinate
   of the (8, 1) mesh (``launch.mesh.RankGroup``, a ``file://`` rendezvous,
   started before phase 4 so that their start-up runs beside it), all
   on the one card over gloo (``RANK_BACKEND``: NCCL refuses two ranks on
   one device, so each message is staged through host memory). Each process
   holds only its shards (the exchanged ones copied out of the parent's
   tensors, which it gets by CUDA IPC and keeps as the originals) and runs
   rs g=4 m=2 killing {0,2} and xor g=4 killing {5} (create, the killed
   processes' shards and stripes overwritten, the restore rebuilding them
   with B4 on those processes), the compressed copy (B5a) and the mirror
   program with its copy restore. Checked: every process's payload SHA-256
   equals its coordinate's rows of the one-card program on the same layout
   (run in this process beside the processes' start-up), the handshake
   checksum is the same on every process and run, the rebuilt shards equal
   the originals, each process sent what its program accounts, B1-B5a
   launched on the processes. Prints each process's create and restore
   seconds, bytes sent and card peak;
5. engine path: a seeded llama3.2-1b train state cut to ``PATH_LAYERS``
   (1) of its 16 layers, width kept, held by a ShardedStateEntity over 4
   ranks (the ZeRO-1 data dim split four ways) plus an RngEntity, through three
   cycles: ``CheckpointEngine(4, EngineConfig())`` (the reference's default
   engine), ``EngineConfig(compress=True)`` and ``EngineConfig(compress=True,
   async_workers=4)``. Each: a background ``checkpoint_async`` (every leaf
   copied from the card straight into pinned arenas, the device-to-host rate
   printed) and ``finalize_async``, overwrite the live state, wipe rank 2's
   host store, the pipelined restore; survivors byte-exact, rank 2's split
   float leaves bit-equal to the plain dequantize(quantize(x)); then the
   same committed generation through the sync restore, checked the same way.
   If the host lacks the RAM this path needs, depth (layers) is cut
   further, never width, and the cut is printed;
6. elastic path: the same cut state and entities through
   ``CheckpointEngine(4, EngineConfig())`` attached to a
   ``VirtualCluster(4)``: checkpoint, overwrite the live state, kill rank 2,
   ``stabilize("elastic")``, ``restore_elastic(2)`` (its recovery through the
   pipelined restore), ``resize(2)``; re-protect with a checkpoint on 2
   ranks, overwrite again, ``restore_elastic(8)``, ``resize(8)``. After each
   restore every leaf is byte-equal to the seeded original, and every leaf
   with a data axis of every new rank was built by the row gather (B6)
   reading the recovered origin shards in place: 33 x 2 and 33 x 8
   launches, no stacking. At full depth 4 -> 3 would hold every split
   leaf whole on each of 3 new ranks (44.5 GB beside the live state and the
   recovered payloads: more than the card has), so the drill goes 4 -> 2 ->
   8, world sizes that divide every ZeRO-1 dim. Depth is cut further, never
   width, if the host lacks the RAM, and the cut is printed;
7. training loop (paper Algorithm 3): the port's ``Trainer`` under its
   defaults (the reference's default engine) on llama3.2-1b at full width
   and ``TRAIN_LAYERS`` (1) of its 16 layers, params drawn from the seed by the reference's threefry streams, bf16
   params and compute with f32 master/m/v (batch 8, seq 128, lr 1e-3 as
   ``launch/train.py``'s defaults; 4 virtual hosts, one spare, a checkpoint
   every 3 steps, host 2 killed at step 5: checkpoints at 3 and 6, a
   rollback to 3, steps 3 and 4 replayed), 8 steps under
   ``torch.use_deterministic_algorithms(True)`` (``main`` sets
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before cuBLAS is first used); then
   the same run at ``TRAIN_ASYNC_LAYERS`` (1) layer, width kept, with
   ``checkpoint_mode="async"`` (each checkpoint captured at the step
   boundary, drained behind the next step, committed at the following
   barrier). Prints each step's loss and time (ending in
   ``torch.cuda.synchronize()``), every committed create's capture,
   blocked, finalize-wait and create times, the restore's time and chunk
   count, the card and host peaks; fails unless every loss is finite, there
   is one recovery, the replayed losses are bit-equal to the first pass, and
   every state leaf right after the restore is byte-equal to the state at
   the step-3 checkpoint (a host copy, or where the host has no room for
   one, each leaf's ``np_checksum``). Its engine holds two committed
   generations at once: depth is cut, never width, if the host lacks the
   RAM, and the cut is printed;
7c. the sharded train step: the port's ``Trainer(mesh=)`` as 4 processes
   sharing the card on the (2, 2) ("data", "model") mesh over gloo, whose
   DTensor groups run on the staged backend (``core/transport.py``; gloo's
   own all-gather of a card's tensors ends the processes), each holding its
   blocks of phase 7's state (llama3.2-1b at ``TRAIN_LAYERS``: params by the
   tp rules, the AdamW state ZeRO-1), on phase 7's ``TRAIN`` and
   ``TRAIN_STEPS`` through host 2's kill at step 5, rank 0's engine rs 4+2
   over 8 virtual hosts, under deterministic algorithms. Its processes start,
   take a warm-up step on a copy of their state and run beside phases 7 and
   5. After phase 5 the same processes get two more runs, beside phases 8
   and 8b, and the script waits for them after phase 8b: (a) phase 11's
   Mamba-2 trainer traffic (mamba2-780m at ``ZOO_SSM_LAYERS``, batch 4 x
   512) on the mesh under ``EngineConfig()`` over 4 hosts with no spare and
   ``recovery_policy="elastic"``, host 2 killed at step 5: rank 0's
   ``restore_elastic(3)`` on B6, then the re-protect create; (b) two train
   steps (``launch/steps.py::train_step``) of phase 11's mixtral layer
   (3.43 GB of bf16 params, computed in f32) on the mesh under the tp
   rules, batch 8 x 128, then the same two steps on one process. Prints
   each run's seconds (from the feed to the last process's end) and the
   phases it ran beside, each process's step times, card peak and staged
   traffic, and rank 0's create and restore times; fails unless every loss is finite and the same on
   every process, each killed run has one recovery, its replayed losses are
   bit-equal to the first pass and each process's blocks right after the
   restore are byte-equal to its blocks at the step-3 checkpoint, the
   llama run's losses before the kill are within rtol 1e-4 of phase 7's
   sync run and (a)'s of phase 11's one-card run (checked after phase 11),
   B4 launched in the llama run's restore and B6 in (a)'s, (a)'s engine
   ends on 3 ranks, and (b)'s losses are within rtol 1e-4 of one process's;
8. striped host codecs: the GF(2^8) backend probe's rates (run once, after
   phase 3, for every backend: ``table``, ``swar``, and ``torch`` on the
   card), then the seeded state of phase 5's depth over 8 ranks through two
   cycles of phase 5's form with ``gf_backend="torch"`` (every encode range
   and decode chunk through B4): ``EngineConfig(codec="rs", parity_group=4,
   rs_parity=2)`` losing hosts 0 and 2, and ``EngineConfig(parity_group=4,
   async_workers=4)`` (xor) losing host 5. Each prints the create's times
   and spans, the parity bytes held against the exchange bytes a copy would
   hold, the restores' times, chunks and decode spans, and the card and host
   peaks; every leaf must come back byte-equal and B4 must launch in each;
8b. failure-domain topology and the adaptive protection policy: the seeded
   state of phase 5's depth over 16 ranks on ``ClusterTopology.regular(16,
   hosts_per_rack=2)`` (8 racks, 4 groups of 4, which the domain-aware
   packer lays out as {0,4,8,12}, {1,5,9,13}, {2,6,10,14}, {3,7,11,15}),
   ``EngineConfig(codec="lrc", parity_group=4, rs_parity=2, lrc_locals=2,
   gf_backend="torch", topology=...)`` with a ``VirtualCluster(16,
   n_spares=3, topology=...)`` attached and a ``ProtectionPolicy`` attached:
   a create; rack 1 (ranks 2, 3) killed through
   ``FailureInjector.schedule_domain_burst`` and ``cluster.kill`` at one
   arrival instant (the journal fits one single-domain burst); the restore,
   before ``stabilize("spare")``, its recovery record naming "rack:1"; the
   policy's ``apply()`` lowering every entity to lrc m=1; a second create
   under the override (its commit hook changes nothing); rank 5 killed and
   restored from the payload's lrc:1:2 record (a local-subgroup repair).
   Fails unless no group holds two hosts of a rack, the burst costs each
   group at most one member (the contiguous layout: two in one), every
   leaf is byte-equal after both restores, nothing escalates, parity is
   1.0x then 0.75x the exchange bytes, and B4 launches in each create and
   restore. Prints the groups and both layouts' damage, each create's
   capture, pinning, ``blocked_s`` and ``create_s``, each restore's time,
   chunks and decode spans, the policy's ``report()``, and the peaks;
9. the storage-tier ladder and differential checkpointing, at
   ``TIER_LAYERS`` (1) of the 16 layers, width kept. Engine leg: the seeded
   state over 8 ranks with ``EngineConfig(codec="rs", parity_group=4,
   rs_parity=2, gf_backend="torch", delta=True, tiers=(storage.disk(dir,
   every=1, dedup=True),))``: three creates, each flushed to the tier
   directory (``build/tiers``; its filesystem and free bytes printed): a full
   encode, then two after rewriting every leaf of layer 0 and the step, each
   patching the parity in place (``delta_encodes``, B4 launched in the
   patch, a dirty fraction under the crossover, chunks reused by the flush;
   the third also leaves clean stripe chunks in place, its staging bank
   holding the first generation's). Then hosts 0 and 2 wiped and restored
   (within m = 2: no escalation), hosts 0, 1 and 2 wiped and restored (the
   generation's pages dropped from the page cache first: the escalation's
   load is timed cold), and a fresh engine on 4 ranks ``restore_elastic(4)``
   from the same directory (the cold 8 -> 4 restart, the row gather B6 on
   every split leaf of every new rank); every leaf byte-equal after each.
   Prints each create's capture, pinning, finalize wait and spans, each
   flush's seconds, bytes, GB/s and chunks written and reused, each load's
   seconds (read and pinning) and the restores' times, and the card and host
   peaks. Trainer leg: phase 7's run at the same depth with
   ``tier_dir``, ``disk_flush_every=1`` and no spare, all 4 hosts killed at
   step 5: the full restart escalates to step 3's generation and steps 3-4
   replay bit-equal; then a fresh ``Trainer`` on 2 hosts ``cold_restart()``s
   from step 6's generation (4 -> 2) and its two steps' losses must be
   bit-equal to the first run's. Phase 9 launches B4 (the patches, the
   encodes, the decode of the within-tolerance restore) and B6 (both cold
   restarts). It runs in a process of its own, started after phase 8b, beside
   phases 6, 10, 11, 12 and 13 (its legs wait on the tier directory's
   filesystem and leave the card and most cores idle), and is waited for
   before phase 4; it prints its own seconds, the phases it ran beside and
   the wait.

10. serving (paper Algorithm 3 over decode sessions): the port's ``Server``
   with llama3.2-1b at full width and all 16 layers (bf16 params from the
   seed, 2.47 GB, not snapshotted), 16 sessions with prompts of 1024 tokens
   drawn by ``utils/threefry.py``, a 2048-position KV cache (1.07 GB), 48
   decoded tokens, a session checkpoint every 16 tokens, 4 virtual hosts,
   under deterministic algorithms, through ``SERVE_RUNS``: (a) clean on the
   default ``EngineConfig()``; (b) host 2 killed at tick 20 (a spare) and
   host 1 dead silently at tick 34 (the heartbeat finds it); (c)
   ``checkpoint_mode="async"``, host 2 at tick 20; (d) ``replica_team=True``,
   the whole primary team killed at tick 30: one promotion, its
   ``replica_promote_restore`` stall under one checkpoint interval (traced
   commit spacing); (e) ``compress=True``, host 2 at tick 20 (B5a, B5b);
   (f) rs g=4 m=2 on ``gf_backend="torch"`` over 8 hosts (with one group of
   4 a group's parity stripes die with its hosts), hosts 0 and 2 at tick 20
   (B4); (g) no spares, ``recovery_policy="elastic"``, kills at ticks 11 and
   26: 4 -> 3 -> 2 (B6). Each prints its prefill seconds, the decode step's
   median and p99 (each step ending in ``torch.cuda.synchronize()``),
   tokens/s, every committed create's ``blocked_s``, every recovery's time
   and restore (with ``bytes_moved`` against its lower bound when elastic),
   the card and host peaks, and (d) ``bytes_synced``. Every run's tokens
   equal the clean run's bit for bit, except that (e) may decode the
   restored rank's rows differently after the rollback (its int8 partner
   copies are lossy): there every other row, and every token up to the
   rollback, must be equal;
11. the model zoo (the scheme is architecture-agnostic), at the published
   widths with the depth cut for time (``ZOO_SSM_LAYERS`` = 2 of
   mamba2-780m's 48 layers, ``ZOO_MOE_LAYERS`` = 1 of mixtral-8x7b's 32),
   under deterministic algorithms: (a) phase 7's run on mamba2-780m (d_model
   1536, 48 SSD heads of 64, state 128) with 4 sequences of 512 tokens (4
   SSD chunks) and ``EngineConfig(codec="rs", parity_group=4, rs_parity=2,
   gf_backend="torch")`` over 8 hosts (``ZOO_TRAIN``: a blob lives on the
   next group's hosts), host 2 killed at step 5, phase 7's checks, B4
   launched; (b) phase 10's traffic through the ``Server`` on mixtral-8x7b
   (8 experts top-2 of d_ff 14336, 1.72 B bf16 params from the seed): clean,
   and phase 10's rs run (hosts 0 and 2 at tick 20), tokens bit-equal, B4
   launched (prefill's 512-token groups have capacity 160, decode's one
   group of 16 tokens capacity 5: both drop slots); (c) the same traffic on
   mamba2-780m: clean, and the default engine with host 2 at tick 20, tokens
   bit-equal (the restore writes the SSM's conv history and state back).
   Each prints its create and restore seconds, the step time (trainer) or
   the decode median and p99, the card and host peaks and B4's launches;
12. the encoder and the VLM, at the published widths with the depth cut
   for time (``HUBERT_LAYERS`` = 2 of hubert-xlarge's 48 layers,
   ``VLM_LAYERS`` = 5 of llama-3.2-vision-90b's 100: one period, 4
   self-attention slots and 1 cross slot), under deterministic algorithms:
   (a) phase 11's trainer traffic (4 x 512 frame embeddings of width 512,
   masked prediction) on hubert-xlarge (d_model 1280, 16 heads of 80, d_ff
   5120 gelu) with ``EngineConfig(codec="xor", parity_group=4,
   gf_backend="torch")`` over 8 hosts, host 2 killed at step 5, phase 7's
   checks, B4 launched (the xor encode and the pipelined decode), and the
   encoder shown bidirectional on the card: a prefill of the step-0 frames
   and one with the last frame changed differ at the first position; (c)
   ``compressed_psum`` of (a)'s ``w_in`` gradient (26.2 M bf16 elements) in
   a one-process NCCL group (a ``file://`` rendezvous under ``build/``),
   bit-equal to the plain quantize and multiply, B5a launched; (b) phase
   10's traffic through the ``Server`` on the VLM (d_model 8192, 64 heads
   over 8 KV heads of 128, d_ff 28,672; 6.39 B bf16 params from the seed)
   with the serve CLI's vision stub (``threefry.normal(PRNGKey(0))``, 16 x
   1600 x 1280): clean, and phase 10's rs run (hosts 0 and 2 at tick 20),
   tokens bit-equal, the restored cross-attention cache byte-equal to the
   clean run's, B4 launched;
13. the paper's phase-field application
   (``examples/phase_field_stencil_torch.py``: a 2-D Allen-Cahn stencil with
   the moving window, block-partitioned over 8 hosts, checkpointed by the
   same engine) on one f32 field of ``PF_SHAPE`` = 8192 x 8192 (268 MB, 8
   blocks of 1024 rows), under deterministic algorithms: the stencil
   timed beside its bytes floor; (a) the reference's drill under
   ``EngineConfig()``: a clean run of 300 steps and one with host 3 killed
   at step 120 and host 6 at step 260, the final fields bit-equal, 2
   recoveries, the window offset at 24, the clean field at step 150 kept on
   the card; (b) ``EngineConfig(codec="rs", parity_group=4, rs_parity=2,
   gf_backend="torch")`` to step 150 with hosts 1 and 2 both lost at step
   120 (the field NaN-filled): the field at step 150 bit-equal to (a)'s, B4
   launched in the encodes and the decode; (c) xor over groups of 4 on B4 to
   step 50, one create, the same burst: the restore raises
   ``DataLostError``. Prints each run's creates (first and warm), restores,
   bytes staged per create, B4's launches and the card and host peaks.

Phase 3 also runs B6 at the main path's largest gather (the w_up master
leaf, 4 origins of (16, 512, 8192) f32, gathered for one new rank of the
4 -> 2 plan): in place (and for the embedding, split on its last dim)
against the host executor for every new rank and against ``torch.cat`` of
the narrowed origin shards; on the reference's stacked matrix (4 x 512
rows of 512 KiB) against ``torch.index_select``, with the plan's index and
with a seeded permutation of its rows; each pair in alternating order over
``B6_AB_ROUNDS`` rounds (medians and spreads); then the leaf's whole
reshard in place against the stack and gather that preceded it.

Phase 7 runs right after phase 3 (beside phase 7c), then phases 5, 8, 8b, (7c's wait), 6 (beside
phase 9), 10, 11, 12, 13, (9's wait), 4, 4b and 4c: 7, 5, 8, 8b and 9 need the most host RAM (8
and 8b too much to run beside 9), and phase 4's staged fetches leave pinned host blocks in
PyTorch's cache. The kernels' launch counts are set to 0 before each of the paths and read after
it (phase 4c's, 7c's and 9's in each of their processes, then summed); every kernel a path runs
must have launched in it (phase 7's copy codec launches none).

The line before the last is the kernels' JSON; the last line is the result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
ARCH = "llama3.2-1b"
# the largest leaf the elastic reshard gathers (phase 3's B6 shape)
W_UP_MASTER = ("opt", "master", "layers", "slot0", "ffn", "w_up")
W_EMBED_MASTER = ("opt", "master", "embed")  # split on its last dim: the gather's shortest rows
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores, NVIDIA data sheet
# Integer work per pipe (CUDA C++ Programming Guide, "Arithmetic
# Instructions" throughput table, compute capability 9.0: 64 results per
# clock per SM for 32-bit integer add, logical and shift operations (the ALU
# pipe) and 64 for 32-bit integer multiply and multiply-add (IMAD, on the FMA
# pipe)); dispatch is one warp instruction per clock in each of the SM's 4
# sub-partitions, 128 lanes per clock per SM. x 132 SMs x 1.98 GHz boost
# clock. The data sheet lists no integer rate.
ALU_OPS_PER_S = 64 * 132 * 1.98e9
FMA_OPS_PER_S = 64 * 132 * 1.98e9
DISPATCH_PER_S = 128 * 132 * 1.98e9
# (codec, g, m, killed ranks); lrc: 2 local XOR rows over m=2 Cauchy rows,
# ranks 0 and 1 both in its first local subgroup
MAIN_RUNS = (("rs", 4, 2, (0, 2)), ("xor", 4, 1, (5,)), ("lrc", 4, 2, (0, 1)))
# Phase 4's depth, width kept: 8 of llama3.2-1b's 16 layers since phase 4c
# joined the run (the whole run took 1195.8 s with all 16 on a slow host,
# with no room to spare under 1200 s). Phase 3 times the kernels on the
# full-depth bucket all the same.
PHASE4_LAYERS = 8
B6_AB_ROUNDS = 16  # rounds of phase 3's comparisons in alternating order
DEVICE_TIER_KERNELS = ("checksum", "xor_reduce", "gf256_matmul", "gf256_matmul_dyn", "quantize_blockwise",
                       "dequantize_blockwise")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phases_beside(phase_ends: dict, t0: float, t1: float) -> list[str]:
    """The phases of ``phase_ends`` (each phase's end, ``time.time()``, in
    the order they ran) whose span overlaps [t0, t1]."""
    names, starts = list(phase_ends), [-math.inf, *phase_ends.values()]
    return [n for n, a, b in zip(names, starts, phase_ends.values()) if a < t1 and b > t0]


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def host_free_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def host_rss_gib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


_HOST_START: list[float] = []  # (MemAvailable, this process's RSS) at start, GiB


def host_free_settled_gib(enough_gib: float = math.inf, max_wait_s: float = 30.0) -> float:
    """MemAvailable once it accounts for the memory this process has freed.
    On the GPU machine freed pages reach MemAvailable only seconds after the
    process's resident set drops (``tools/memavailable_lag.py`` measures
    it), so a reading right after a path under-reports what the next one
    can use. Waits, at most ``max_wait_s``, until MemAvailable is within 2
    GiB of the start reading less this process's growth since, or reaches
    ``enough_gib`` (what the caller needs to run at its full size: more
    would change nothing)."""
    want = min(_HOST_START[0] - max(host_rss_gib() - _HOST_START[1], 0.0) - 2.0, enough_gib)
    t0 = time.perf_counter()
    while (free := host_free_gib()) < want and time.perf_counter() - t0 < max_wait_s:
        time.sleep(1.0)
    if time.perf_counter() - t0 > 1.0:
        log(f"host RAM settled after {time.perf_counter() - t0:.1f} s: {free:.1f} GiB free")
    return free


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternating_rounds(fns: dict, rounds: int | None = None, reps: int = 10) -> dict[str, dict[str, float]]:
    """Each function timed ``rounds`` times (``B6_AB_ROUNDS`` by default),
    the mean of ``reps`` calls each (CUDA events), the order rotated every
    round and reversed every other one; per function the median, min, max
    and spread in ms."""
    names = list(fns)
    times: dict[str, list[float]] = {k: [] for k in names}
    for rnd in range(B6_AB_ROUNDS if rounds is None else rounds):
        order = names[rnd % len(names):] + names[: rnd % len(names)]
        for name in (order[::-1] if rnd % 2 else order):
            times[name].append(time_ms(fns[name], reps=reps))
    return {k: dict(median=statistics.median(v), min=min(v), max=max(v), spread=max(v) - min(v))
            for k, v in times.items()}


def gf_ops(coefs, n_words: int) -> tuple[float, float]:
    """(ALU-pipe, FMA-pipe) instructions the GF(2^8) product needs for these
    coefficients: per input column, one xtime step per bit below its highest
    set bit (2 on the ALU pipe: the top-bit mask and the masked XOR, both
    LOP3; 2 on the FMA pipe: the reduction multiply-high by 0x1D << 25,
    IMAD.HI, and the doubling, IMAD.SHL), plus half a LOP3 per set
    coefficient bit (a three-input XOR folds two terms into an
    accumulator). This counts what the function needs for these
    coefficients, not what the compiled kernel issues (``tools/sass_mix.py``
    reads that)."""
    alu = fma = 0.0
    for i in range(len(coefs[0])):
        col = [int(row[i]) for row in coefs]
        steps = max(max(col).bit_length() - 1, 0)
        alu += 2 * steps + 0.5 * sum(bin(c).count("1") for c in col)
        fma += 2 * steps
    return alu * n_words, fma * n_words


def bound_times(nbytes: int, alu: float = 0.0, fma: float = 0.0, flops: float = 0.0) -> dict[str, float]:
    """The least time in ms the card needs for each resource: the bytes over
    HBM, the integer work on the ALU and FMA pipes and through dispatch,
    f32 work outside the tensor cores."""
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "alu": alu / ALU_OPS_PER_S * 1e3,
            "fma": fma / FMA_OPS_PER_S * 1e3, "dispatch": (alu + fma) / DISPATCH_PER_S * 1e3,
            "f32": flops / F32_FLOPS * 1e3}


def bound(nbytes: int, alu: float = 0.0, fma: float = 0.0, flops: float = 0.0) -> tuple[float, str]:
    t = bound_times(nbytes, alu, fma, flops)
    return max(t.values()), ("bytes" if t["bytes"] >= max(t.values()) else "operations")


def max_abs_err(pairs) -> int:
    """Largest |a - b| over the uint32 words of each (kernel, plain) pair of
    equal-size tensors; 0 when every pair is bit-equal."""
    import torch

    err, chunk = 0, 1 << 28
    for a, b in pairs:
        a, b = a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32)
        check(a.numel() == b.numel(), f"compared tensors differ in size: {a.numel()} != {b.numel()}")
        for s in range(0, a.numel(), chunk):
            d = (a[s : s + chunk].to(torch.int64) & 0xFFFFFFFF) - (b[s : s + chunk].to(torch.int64) & 0xFFFFFFFF)
            err = max(err, int(d.abs().max()))
    return err


def max_value_err(a, b) -> float:
    """Largest |a - b| over two equal-size tensors compared as numbers (int8
    codes as integers, floats in float64); 0 only where they are equal bit
    for bit (bits that differ between equal numbers, signed zeros, count as
    infinite)."""
    import torch

    check(a.numel() == b.numel(), f"compared tensors differ in size: {a.numel()} != {b.numel()}")
    a, b = a.reshape(-1), b.reshape(-1)
    err, chunk = 0.0, 1 << 27
    for s in range(0, a.numel(), chunk):
        x, y = a[s : s + chunk], b[s : s + chunk]
        if torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            continue
        d = float((x.to(torch.float64) - y.to(torch.float64)).abs().max())
        err = max(err, d if d > 0 else float("inf"))
    return err


def ptxas_summary(name: str, text: str) -> None:
    """One line per library from its ``-Xptxas -v`` report: the kernels
    compiled, the most registers any uses, and every spill (the GF(2^8)
    libraries hold 128 instantiations each)."""
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
    spills = [ln.strip() for ln in text.splitlines()
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    log(f"  ptxas {name}: {len(regs)} kernels, registers {min(regs, default=0)}-{max(regs, default=0)}, "
        f"{len(spills)} with spills" + "".join(f"\n    {ln}" for ln in spills[:8]))


def sass_phase() -> None:
    """The GF(2^8) kernels' issued instructions per uint32 word of each row,
    read from their SASS (``tools/sass_mix.py``): the grid-stride loop of the
    (K=4, M=2) instantiation (the rs encode and decode) and of (K=4, M=1)
    (the xor decode)."""
    import os

    sys.path.insert(0, str(ROOT / "tools"))
    import sass_mix
    from repro_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    names = ("rs_encode", "rs_decode")
    # both disassemblies at once (each takes tens of seconds), each into a
    # file of its own: a pipe left unread would stall the second one
    outs = {name: (tempfile.TemporaryFile(mode="w+"), tempfile.TemporaryFile(mode="w+")) for name in names}
    procs = {name: subprocess.Popen([cuobjdump, "-sass", str(_build.lib_path(name))], stdout=outs[name][0],
                                    stderr=outs[name][1], text=True) for name in names}
    for name in names:
        rc = procs[name].wait(timeout=300)
        sass, err = [f.seek(0) or f.read() for f in outs[name]]
        for f in outs[name]:
            f.close()
        check(rc == 0, f"cuobjdump {name} failed: {err[-2000:]}")
        for k, m in ((4, 2), (4, 1)):
            c = sass_mix.gf_word_mix(sass, k, m)
            log(f"sass {name} (K={k}, M={m}) loop, per word: " + ", ".join(f"{p} {v:.2f}" for p, v in c.items()))


# ---------------------------------------------------------------------------
# phase 2: the kernels on the card at small and ragged sizes (pytest -m cuda)
# ---------------------------------------------------------------------------

def kernel_tests_phase():
    """tests/test_torch_cuda.py: B1-B6 against their plain versions at
    ragged lengths, unaligned rows, all-ones words, every coefficient, zero
    blocks, half steps and every row width of the reshard; the device tier
    on the card against the CPU path for every codec and failure
    combination and for compress=True; the host engine and its elastic
    restore on the card against the CPU. Its launches happen in its own
    process, started here; the returned function waits for it and checks
    it (the SASS disassembly of phase 1 runs on the host meanwhile)."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out, err = tempfile.TemporaryFile(mode="w+"), tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-m", "cuda",
         str(ROOT / "tests" / "test_torch_cuda.py")],
        stdout=out, stderr=err, text=True, env=env, cwd=ROOT,
    )

    def finish() -> None:
        rc = proc.wait(timeout=600)
        stdout, stderr = [f.seek(0) or f.read() for f in (out, err)]
        for f in (out, err):
            f.close()
        lines = stdout.strip().splitlines()
        check(rc == 0 and lines and " passed" in lines[-1] and "skipped" not in lines[-1],
              "tests/test_torch_cuda.py:\n" + stdout[-4000:] + stderr[-2000:])
        log(f"kernel tests on the card: {lines[-1]}")

    return finish


# ---------------------------------------------------------------------------
# phase 3: each kernel at the main path's shapes
# ---------------------------------------------------------------------------

def rand_words(shape, gen):
    import torch

    x = torch.randint(-(2**31), 2**31, shape, generator=gen, device="cuda", dtype=torch.int64)
    return x.to(torch.int32).view(torch.uint32)


def kernel_phase_main(words: int, gen) -> list[dict]:
    """Each kernel at the main path's shapes: bit-equal to its plain version,
    timed, bounded."""
    import torch

    from repro_torch.core import gf256
    from repro_torch.core.device_tier import striped_decode_rows
    from repro_torch.kernels import checksum as ck, quantize as qk, ref, rs_decode as rd, rs_encode as rse
    from repro_torch.kernels import xor_parity as xp

    results = []

    def record(name, source, replaces, err, ms, plain, nbytes, alu=0.0, fma=0.0, flops=0.0, lib=None):
        check(err == 0, f"{name}: kernel differs from its plain version (max |err| {err})")
        b_ms, b_by = bound(nbytes, alu, fma, flops)
        results.append(dict(name=name, source=source, replaces=replaces, max_abs_err=err, ms=ms,
                            plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                            bounds=bound_times(nbytes, alu, fma, flops)))

    def empty():
        return torch.empty(words, dtype=torch.int32, device="cuda").view(torch.uint32)

    # B1: the (8, words) fused f32 bucket; the plain version row by row
    # (its int64 temporaries of all eight rows would not fit beside it)
    buf = rand_words((8, words), gen)

    def plain_checksum():
        return torch.cat([ref.checksum_rows(buf[r : r + 1]).view(torch.int32) for r in range(8)])

    err = max_abs_err([(ck.checksum_rows(buf), plain_checksum())])
    record("checksum", "src/repro_torch/kernels/csrc/checksum.cu", "src/repro/kernels/checksum.py:42", err,
           time_ms(lambda: ck.checksum_rows(buf)), time_ms(plain_checksum, reps=1),
           buf.numel() * 4 + 8 * 8, alu=2 * buf.numel(), fma=buf.numel())
    del buf
    torch.cuda.empty_cache()

    # a parity group of g=4 members, one (words,) coordinate row each
    x = rand_words((4, words), gen)
    rows = list(x.unbind(0))
    # the parity payload's stripe slots, (m, n_coords, sw), as `_parity`
    # builds them for full groups: blob b is the contiguous run of its holder
    # group's slots (here group 1's, coordinates 4..7), written in place
    check(words % 4 == 0, "bucket words divide the group")
    slots = torch.empty((2, 8, words // 4), dtype=torch.int32, device="cuda").view(torch.uint32)
    blobs = [slots[b, 4:8].view(-1) for b in range(2)]

    # B2: xor g=4
    xp.xor_reduce_into(rows, blobs[0])
    err = max_abs_err([(blobs[0], ref.xor_reduce(x))])
    xi = x.view(torch.int32)
    record("xor_reduce", "src/repro_torch/kernels/csrc/xor_parity.cu", "src/repro/kernels/xor_parity.py:42", err,
           time_ms(lambda: xp.xor_reduce_into(rows, blobs[0])), time_ms(lambda: ref.xor_reduce(x), reps=2),
           5 * words * 4, alu=2 * words,
           lib=time_ms(lambda: torch.bitwise_xor(torch.bitwise_xor(xi[0], xi[1]), torch.bitwise_xor(xi[2], xi[3]))))

    # B3: rs g=4 m=2 (the Cauchy generator)
    gen_c = gf256.cauchy_matrix(2, 4).tolist()
    rse.rs_encode_into(rows, gen_c, blobs)
    err = max_abs_err(zip(blobs, ref.gf256_matmul(x, gen_c)))
    record("gf256_matmul", "src/repro_torch/kernels/csrc/rs_encode.cu", "src/repro/kernels/rs_encode.py:83", err,
           time_ms(lambda: rse.rs_encode_into(rows, gen_c, blobs)), time_ms(lambda: ref.gf256_matmul(x, gen_c), reps=1),
           6 * words * 4, *gf_ops(gen_c, words))

    def decode_case(codec: str, m: int, killed: list[int], cols: list[int], inputs: list, lost: list):
        """B4 at one run's decode shape: the killed members of group 0/1
        rebuilt from ``inputs`` (survivors, then blobs) with the restore's
        decode rows; bit-equal to the lost rows and to the plain version."""
        dec, _ = striped_decode_rows(8, 4, codec, m, set(killed))
        coef = dec[killed][:, cols]
        cdev = torch.from_numpy(coef.astype("int32")).cuda().view(torch.uint32)
        outs = [empty() for _ in killed]
        rd.rs_decode_into(inputs, cdev, outs)
        check(max_abs_err(zip(outs, lost)) == 0, f"rs_decode {codec}: lost rows not rebuilt")
        stacked = torch.stack([t.view(torch.int32) for t in inputs]).view(torch.uint32)
        err = max_abs_err(zip(outs, ref.gf256_matmul_dyn(stacked, cdev)))
        ms = time_ms(lambda: rd.rs_decode_into(inputs, cdev, outs))
        plain = time_ms(lambda: ref.gf256_matmul_dyn(stacked, cdev), reps=1)
        nbytes, ops = (len(inputs) + len(outs)) * words * 4, gf_ops(coef.tolist(), words)
        b_ms, b_by = bound(nbytes, *ops)
        log(f"rs_decode at the {codec} run's shape ({len(inputs)} -> {len(outs)}, coefficients "
            f"{coef.tolist()}): {ms:.3f} ms, bound {b_ms:.3f} ms by {b_by}, {100 * b_ms / ms:.1f}% of the bound "
            f"(plain {plain:.3f} ms), max |err| {err}")
        return err, ms, plain, nbytes, ops

    # B4, rs run: ranks {0, 2} from survivors 1, 3 and blobs 0, 1
    rs_case = decode_case("rs", 2, [0, 2], [1, 3, 4, 5], [rows[1], rows[3], blobs[0], blobs[1]], [rows[0], rows[2]])
    # B4, xor run: rank 5 (member 1 of group 1) from members 0, 2, 3 and the XOR blob
    xp.xor_reduce_into(rows, blobs[0])
    xor_err = decode_case("xor", 1, [5], [0, 2, 3, 4], [rows[0], rows[2], rows[3], blobs[0]], [rows[1]])[0]
    err, ms, plain, nbytes, ops = rs_case
    record("gf256_matmul_dyn", "src/repro_torch/kernels/csrc/rs_decode.cu", "src/repro/kernels/rs_decode.py:77",
           max(err, xor_err), ms, plain, nbytes, *ops)
    del x, rows, xi, slots, blobs
    torch.cuda.empty_cache()

    # B5a/B5b: the compressed device-tier bucket, (8, row) f32 rows (row =
    # the bucket's words rounded up to whole 256-element blocks; at
    # llama3.2-1b they are already whole), quantized in one launch; the plain
    # versions row by row (their temporaries of all eight rows would not fit
    # beside it)
    row = -(-words // 256) * 256
    n = 8 * row
    xf = torch.randn((8, row), generator=gen, device="cuda")
    q = torch.empty(n, dtype=torch.int8, device="cuda")
    sc = torch.empty(n // 256, dtype=torch.float32, device="cuda")
    qk.quantize_into(xf.view(-1), q, sc)
    err = 0
    for r in range(8):
        pq, ps = ref.quantize_blockwise(xf[r])
        err = max(err, max_value_err(q[r * row : (r + 1) * row], pq),
                  max_value_err(sc[r * row // 256 : (r + 1) * row // 256], ps))
    # per element: |x|, the running max, one division, the rounding, the clamp
    record("quantize_blockwise", "src/repro_torch/kernels/csrc/quantize.cu", "src/repro/kernels/quantize.py:40",
           err, time_ms(lambda: qk.quantize_into(xf.view(-1), q, sc)),
           time_ms(lambda: [ref.quantize_blockwise(xf[r]) for r in range(8)], reps=1),
           4 * n + n + 4 * (n // 256), flops=5 * n)
    del xf
    out = torch.empty(n, dtype=torch.float32, device="cuda")
    qk.dequantize_into(q, sc, out)
    err = 0
    for r in range(8):
        rows_q, rows_s = q[r * row : (r + 1) * row], sc[r * row // 256 : (r + 1) * row // 256]
        err = max(err, max_value_err(out[r * row : (r + 1) * row], ref.dequantize_blockwise(rows_q, rows_s)))
    # B5b against the one PyTorch call that computes it (int8 x f32 promotes
    # to f32: one rounded product per code), in alternating rounds
    lib = torch.empty(n, dtype=torch.float32, device="cuda")
    ab = alternating_rounds({"dequantize_blockwise": lambda: qk.dequantize_into(q, sc, out),
                             "torch.mul": lambda: torch.mul(q.view(-1, 256), sc.view(-1, 1), out=lib.view(-1, 256))})
    check(torch.equal(lib.view(torch.int32), out.view(torch.int32)), "torch.mul differs from dequantize_blockwise")
    log(f"dequantize_blockwise against torch.mul, {B6_AB_ROUNDS} rounds in alternating order, ms: " + json.dumps(ab))
    del lib
    record("dequantize_blockwise", "src/repro_torch/kernels/csrc/quantize.cu", "src/repro/kernels/quantize.py:60",
           err, ab["dequantize_blockwise"]["median"],
           time_ms(lambda: [ref.dequantize_blockwise(q[r * row : (r + 1) * row], sc[r * row // 256 : (r + 1) * row // 256])
                            for r in range(8)], reps=1),
           n + 4 * (n // 256) + 4 * n, flops=2 * n, lib=ab["torch.mul"]["median"])
    results[-1]["vs_torch_mul"] = ab
    del q, sc, out
    torch.cuda.empty_cache()
    for r in results:
        per = ", ".join(f"{k} {v:.3f}" for k, v in r.pop("bounds").items() if v)
        log(f"kernel {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, library {r['library_ms']}, "
            f"bound {r['bound_ms']:.3f} ms by {r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}% of it; "
            f"ms per resource: {per})")
    return results


def layout_and_plan(cfg, n_ranks: int):
    """The train-state layout over an (n_ranks, 1) ("data", "model") mesh on
    the card, with its ShardPlan."""
    from repro_torch.launch.steps import train_state_layout
    from repro_torch.runtime.state import ShardPlan
    from repro_torch.sharding.mesh import make_mesh

    mesh = make_mesh((n_ranks, 1), ("data", "model"))
    layout = train_state_layout(cfg, mesh)
    return mesh, layout, ShardPlan.from_pspecs(layout.sds, layout.pspecs)


def stack_rows(sources: dict, axis: int):
    """The reference's input to its row gather (and this port's before the
    run table): the origin shards stacked in origin order into one (rows,
    row_elems) matrix with ``axis`` leading, one ``torch.cat`` of the
    moved-axis views; with each origin's first row in it."""
    import torch

    base, off = {}, 0
    for o in sorted(sources):
        base[o], off = off, off + sources[o].shape[axis]
    stacked = torch.cat([sources[o].movedim(axis, 0) for o in sorted(sources)])
    return stacked.reshape(stacked.shape[0], -1), base


def segment_index(segments, base: dict):
    """The plan's segments (in ``dst_start`` order) as an int32 row index
    into ``stack_rows``' matrix, on the CPU."""
    import torch

    return torch.cat([torch.arange(s.src_start, s.src_start + s.rows, dtype=torch.int64) + base[s.origin]
                      for s in sorted(segments, key=lambda s: s.dst_start)]).to(torch.int32)


def leaf_case(cfg, gen, path=None):
    """A leaf's four origin shards of the drill (the w_up master leaf by
    default: (16, 512, 8192) f32), drawn from ``gen`` on the card, and the
    drill's 4 -> 2 plan for it (rank 2 killed): (sources, the split axis,
    bytes per row along it, the plan)."""
    import torch

    from repro_torch.elastic.plan import plan_repartition

    _, _, plan = layout_and_plan(cfg, ENGINE_RANKS)
    i = plan.treedef.index(W_UP_MASTER if path is None else path)
    axis, shape = plan.dims[i], list(plan.shapes[i])
    shape[axis] //= ENGINE_RANKS
    sources = {o: torch.randn(shape, generator=gen, device="cuda") for o in range(ENGINE_RANKS)}
    coords = [[c[i]] for c in plan.shard_coords(ENGINE_RANKS)]
    row_bytes = sources[0].numel() * 4 // shape[axis]
    # residency after killing rank 2: survivors 0, 1, 3 renumber to 0, 1, 2;
    # rank 2's copy is adopted on its pairwise partner 0; dense rank 2 leaves
    return sources, axis, row_bytes, plan_repartition(coords, 2, {0: 0, 1: 1, 2: 0, 3: None}, [row_bytes])


def gather_kernel_main(cfg, gen) -> dict:
    """B6 at the main path's largest gather, the w_up master leaf: four
    origin shards of (16, 512, 8192) f32 gathered for new rank 0 of the
    drill's 4 -> 2 plan (rank 2 killed).

    Stacked, the reference's form (4 x 512 rows of 512 KiB, 1,024
    gathered): the kernel and ``torch.index_select`` on the same matrix in
    alternating rounds, with the plan's index (one run) and with a seeded
    permutation of the same rows (1,024 runs), bit-equal. In place, the
    executor's form, for new rank 0 of w_up (two strided runs of 16 rows of
    16.8 MB) and of the embedding (split on its last dim: two strided runs
    of 128,256 rows of 2 KiB): the host executor gives the same bytes for
    every new rank, and the kernel is timed against
    ``torch.cat`` of the narrowed origin shards (the host executor's form
    as one PyTorch call). Then the whole reshard of w_up for new rank 0, in
    place against the stack and gather this executor did before."""
    import torch

    from repro_torch.elastic.reshard import leaf_runs, reshard_leaf_device, reshard_leaves, reshard_leaves_device
    from repro_torch.kernels import _build, ops, ref, reshard as rk

    sources, axis, row_bytes, p = leaf_case(cfg, gen)
    shape, segs = list(sources[0].shape), p.segments[0]
    stream = _build.stream_of(sources[0].device)
    err = 0

    # in place: the host executor's bytes for every new rank, then the
    # kernel against torch.cat for new rank 0
    in_place = {}
    for name, path in (("w_up", None), ("embed", W_EMBED_MASTER)):
        srcs, ax, _, pl = (sources, axis, row_bytes, p) if path is None else leaf_case(cfg, gen, path)
        dev = reshard_leaves_device(pl, {o: [t] for o, t in srcs.items()}, [ax])
        host = reshard_leaves(pl, {o: [t.cpu()] for o, t in srcs.items()}, [ax])
        for j in range(2):
            check(torch.equal(dev[j][0].cpu().view(torch.int32), host[j][0].contiguous().view(torch.int32)),
                  f"gather_rows: {name}, new rank {j} differs from the host executor")
        res, lib = dev[0][0], torch.empty_like(dev[0][0])
        del dev, host
        leaf_segs = sorted(pl.segments[0], key=lambda s: s.dst_start)
        views = [srcs[s.origin].narrow(ax, s.src_start, s.rows) for s in leaf_segs]
        table, order, _ = leaf_runs(srcs, leaf_segs, ax)
        *args, keep = rk.kernel_table([srcs[o] for o in order], res, table)
        fns = {"gather_rows": lambda args=args: _build.call("copy_runs", *args, stream),
               "torch.cat": lambda views=views, lib=lib, ax=ax: torch.cat(views, dim=ax, out=lib)}
        fns["torch.cat"]()
        res.zero_()
        rk.copy_runs_into([srcs[o] for o in order], res, table)
        err = max(err, max_abs_err([(res, lib)]))
        in_place[name] = dict(runs=table.tolist(), ms=alternating_rounds(fns))
        del res, lib, views, keep
        if path is not None:
            del srcs
    torch.cuda.empty_cache()

    stacked, base = stack_rows(sources, axis)
    idx_host = segment_index(segs, base)
    idx = idx_host.to("cuda")
    out = torch.empty((idx.numel(), stacked.shape[1]), dtype=stacked.dtype, device="cuda")
    lib_out = torch.empty_like(out)
    perm = idx_host[torch.randperm(idx_host.numel(), generator=torch.Generator().manual_seed(SEED))]
    stacked_ab = {}
    for name, index in (("plan", idx_host), ("permutation", perm)):
        table = rk.index_runs(index, row_bytes)
        *args, keep = rk.kernel_table([stacked], out, table)
        index_card = index.to("cuda", torch.int64)
        fns = {"gather_rows": lambda: _build.call("copy_runs", *args, stream),
               "index_select": lambda: torch.index_select(stacked, 0, index_card, out=lib_out)}
        fns["index_select"]()
        out.zero_()
        rk.copy_runs_into([stacked], out, table)
        err = max(err, max_abs_err([(out, lib_out)]))
        err = max(err, max_abs_err([(out, ref.gather_rows(stacked, index_card))]))
        stacked_ab[name] = dict(runs=table.shape[0], ms=alternating_rounds(fns))
        del keep
    check(err == 0, f"gather_rows: kernel differs from its plain version (max |err| {err})")
    ms = stacked_ab["plan"]["ms"]["gather_rows"]["median"]
    library_ms = stacked_ab["plan"]["ms"]["index_select"]["median"]
    plain_ms = time_ms(lambda: ref.gather_rows(stacked, idx))

    def stack_and_gather():  # the parent's executor: stack, gather, a moved-axis view
        st, _ = stack_rows(sources, axis)
        out = ops.gather_rows(st, idx_host)
        return out.reshape((idx_host.numel(), *shape[:axis], *shape[axis + 1 :])).movedim(0, axis)

    reshard = alternating_rounds({"in place": lambda: reshard_leaf_device(sources, segs, axis),
                                  "stack + gather": stack_and_gather}, rounds=8, reps=3)
    # bytes: each selected source row read once, each output row written once, the indices
    rows_read = int(torch.unique(idx).numel())
    nbytes = (rows_read + idx.numel()) * row_bytes + 4 * idx.numel()
    b_ms, b_by = bound(nbytes, 0)
    unit = rk.unit_bytes(row_bytes, stacked.data_ptr(), out.data_ptr())
    log(f"kernel gather_rows at the w_up master leaf ({ENGINE_RANKS} x {shape[axis]} rows of {row_bytes} B "
        f"-> {idx.numel()} rows, unit {unit} B): {ms:.4f} ms (plain {plain_ms:.3f}, "
        f"index_select {library_ms:.4f}, bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}% of it)")
    log(f"gather_rows against index_select, {B6_AB_ROUNDS} rounds in alternating order, ms: " + json.dumps(stacked_ab))
    log(f"gather_rows in place against torch.cat, {B6_AB_ROUNDS} rounds in alternating order, ms: "
        + json.dumps(in_place))
    log("reshard of the leaf for new rank 0, in place against the stack and gather, ms: " + json.dumps(reshard))
    del sources, stacked, out, lib_out
    torch.cuda.empty_cache()
    return dict(name="gather_rows", source="src/repro_torch/kernels/csrc/reshard.cu",
                replaces="src/repro/kernels/reshard.py:48", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, vs_index_select=stacked_ab,
                in_place=in_place, reshard_leaf=reshard)


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def host_checksum(prog, host_own, specs, mesh) -> tuple[int, int]:
    """The handshake checksum from the staged host bytes with np_checksum:
    per bucket coordinate, each leaf shard's (s1, s2) shifted to its word
    offset (s2 += offset·s1), summed over coordinates, then mixed."""
    import itertools

    import torch

    from repro_torch.utils.pytree import tree_flatten
    from repro_torch.core.integrity import np_checksum
    from repro_torch.sharding.mesh import axes_of, full_rank

    _, leaves = tree_flatten(host_own)
    _, pspecs = tree_flatten(specs)
    mask = 0xFFFFFFFF
    acc1 = acc2 = 0
    for bi, bucket in enumerate(prog.buckets):
        c1 = c2 = 0
        for i, off in zip(bucket.leaf_idx, bucket.word_offsets):
            t = leaves[i]
            # the bytes as a same-width integer array: np_checksum reads bytes only
            a = t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]).numpy()
            ps = full_rank(pspecs[i], a.ndim)
            split, axis_dims, local_dims = [], {}, []
            for size, e in zip(a.shape, ps):
                k = 1
                for ax in axes_of(e):
                    axis_dims[ax] = len(split)
                    split.append(mesh.shape[ax])
                    k *= mesh.shape[ax]
                check(size % k == 0, "main path leaves divide the mesh")
                local_dims.append(len(split))
                split.append(size // k)
            leaf_axes = [ax for ax in bucket.axes if ax in axis_dims]
            v = a.reshape(split).transpose([axis_dims[ax] for ax in leaf_axes] + local_dims)
            for coord in itertools.product(*[range(mesh.shape[ax]) for ax in bucket.axes]):
                idx = tuple(c for ax, c in zip(bucket.axes, coord) if ax in leaf_axes)
                s1, s2 = np_checksum(v[idx])
                c1 = (c1 + s1) & mask
                c2 = (c2 + s2 + off * s1) & mask
        acc1 = (acc1 * 1000003 + c1 * (bi + 1)) & mask
        acc2 = (acc2 * 1000003 + c2 * (bi + 1)) & mask
    return acc1, acc2


def main_run(state, layout, mesh, codec: str, g: int, m: int, kill) -> dict:
    """One create / stage / kill / restore cycle of the main path; every
    device and host buffer it makes is freed when it returns."""
    import torch

    from repro_torch.core.device_tier import (
        build_snapshot_program, build_striped_restore_program, overwrite_shards,
        staged_snapshot_fetch, striped_decode_rows,
    )
    from repro_torch.utils.pytree import tree_flatten

    prog = build_snapshot_program(mesh, layout.sds, layout.pspecs, codec=codec, parity_group=g, rs_parity=m)
    rest = build_striped_restore_program(mesh, layout.sds, layout.pspecs, codec=codec, parity_group=g, rs_parity=m)
    check([b.tag for b in prog.buckets] == ["data:float32"], f"buckets {[b.tag for b in prog.buckets]}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = prog.snapshot_fn(state)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    dev_sum = tuple(c & 0xFFFFFFFF for c in payload["checksum"].view(torch.int32).cpu().tolist())
    del payload
    torch.cuda.empty_cache()

    # the first fetch allocates (pins) its host buffers; the second reuses
    # them from PyTorch's pinned-memory cache
    t0 = time.perf_counter()
    host = staged_snapshot_fetch(prog, state, double_buffer=True)
    d2h_first_s = time.perf_counter() - t0
    del host
    t0 = time.perf_counter()
    host = staged_snapshot_fetch(prog, state, double_buffer=True)
    d2h_s = time.perf_counter() - t0
    d2h_bytes, own_d2h_bytes = tree_nbytes(host), tree_nbytes(host["own"])  # the pinned buffers it filled
    t0 = time.perf_counter()
    want = host_checksum(prog, host["own"], layout.pspecs, mesh)
    host_sum_s = time.perf_counter() - t0
    check(dev_sum == want, f"{codec}: device checksum {dev_sum} != host np_checksum {want}")

    overwrite_shards(mesh, state, layout.pspecs, "data", kill)  # the killed ranks' memory
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parity = {tag: t.to("cuda", non_blocking=True) for tag, t in host["parity"].items()}
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    h2d_bytes = tree_nbytes(parity)
    rows, mask = striped_decode_rows(mesh.shape["data"], g, codec, m, set(kill))
    t0 = time.perf_counter()
    restored = rest.restore_fn(state, parity, {"data": rows}, {"data": mask})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(len(restored) == len(prog.exchanged_names), "restore returned every exchanged leaf")
    restored_bytes = tree_nbytes(restored)
    del parity, restored
    for i, (h, x) in enumerate(zip(tree_flatten(host["own"])[1], tree_flatten(state)[1])):
        check(torch.equal(h.to("cuda").reshape(-1).view(torch.uint8), x.reshape(-1).view(torch.uint8)),
              f"{codec}: leaf {i} differs after restore")
    state_bytes = prog.own_bytes
    fused = sum(b.words * 4 * mesh.size for b in prog.buckets)
    return dict(
        codec=codec, g=g, m=m, killed=list(kill), checksum=list(dev_sum),
        create_s=create_s, create_gbps=state_bytes / create_s / 1e9,
        d2h_first_s=d2h_first_s, d2h_s=d2h_s, d2h_gbps=prog.pcie_bytes / d2h_s / 1e9,
        h2d_parity_s=h2d_s, restore_s=restore_s, restore_gbps=fused / restore_s / 1e9,
        host_checksum_s=host_sum_s, pcie_bytes=prog.pcie_bytes, peak_device_gb=peak / 1e9,
        own_bytes=prog.own_bytes, exchanged_bytes=prog.exchanged_bytes, fused_buckets=len(prog.buckets),
        restore_pcie_bytes=rest.pcie_bytes, host_decode_pcie_bytes=rest.host_decode_pcie_bytes,
        d2h_bytes=d2h_bytes, own_d2h_bytes=own_d2h_bytes, h2d_bytes=h2d_bytes, restored_bytes=restored_bytes,
    )


def compressed_run(state, layout, mesh) -> dict:
    """The copy codec with compress=True: create (the quantize kernel on all
    eight coordinate rows at once), codes and scales bit-equal to the plain
    quantize of the same rows, the staged fetch, and the fetched partner
    dequantized on the card (the dequantize kernel) within half a step of
    the original."""
    import torch

    from repro_torch.core.device_tier import build_snapshot_program, staged_snapshot_fetch
    from repro_torch.kernels import ops, ref

    prog = build_snapshot_program(mesh, layout.sds, layout.pspecs, compress=True)
    check([b.tag for b in prog.buckets] == ["data:float32"], f"buckets {[b.tag for b in prog.buckets]}")
    bucket = prog.buckets[0]
    words, tag = bucket.words, bucket.tag
    row = -(-words // 256) * 256  # the compressed row: whole 256-element blocks
    fused = words * 4 * mesh.size
    check(prog.pcie_bytes == prog.own_bytes + fused // 4,
          f"compressed pcie_bytes {prog.pcie_bytes} != own {prog.own_bytes} + fused/4 {fused // 4}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = prog.snapshot_fn(state)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    q, sc = payload["partner"][tag]["q"], payload["partner"][tag]["scale"]
    check(q.numel() == 8 * row and sc.numel() == 8 * row // 256, "compressed partner shapes")
    del payload
    torch.cuda.empty_cache()

    # the plain version over the same bucket: the uncompressed copy program's
    # partner holds the same f32 rows, moved along the same pairs
    plain_prog = build_snapshot_program(mesh, layout.sds, layout.pspecs, include_own_copy=False, validate=False)
    rows = plain_prog.snapshot_fn(state)["partner"][tag].view(torch.float32).view(8, words)

    def padded(r: int):
        if row == words:
            return rows[r]
        x = torch.zeros(row, dtype=torch.float32, device=rows.device)
        x[:words] = rows[r]
        return x

    err = 0.0
    for r in range(8):
        pq, ps = ref.quantize_blockwise(padded(r))
        err = max(err, max_value_err(q[r * row : (r + 1) * row], pq),
                  max_value_err(sc[r * row // 256 : (r + 1) * row // 256], ps))
        del pq, ps
    check(err == 0, f"compressed partner differs from the plain quantize (max |err| {err})")

    t0 = time.perf_counter()
    host = staged_snapshot_fetch(prog, state, double_buffer=True)
    d2h_s = time.perf_counter() - t0
    d2h_bytes, own_d2h_bytes = tree_nbytes(host), tree_nbytes(host["own"])
    code_d2h_bytes = tree_nbytes(host["partner"][tag]["q"])
    hq = host["partner"][tag]["q"].to("cuda")
    hs = host["partner"][tag]["scale"].to("cuda")
    del host
    check(torch.equal(hq, q) and torch.equal(hs.view(torch.int32), sc.view(torch.int32)),
          "staged partner differs from the snapshot's")
    del q, sc
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deq = ops.dequantize_blockwise(hq, hs)
    torch.cuda.synchronize()
    deq_s = time.perf_counter() - t0
    # |x - q·s| <= s/2 up to the rounding of x/s and of q·s: s/2 + 254·s·2^-24
    worst = 0.0
    for r in range(8):
        d = (deq[r * row : (r + 1) * row] - padded(r)).abs().view(-1, 256).amax(1)
        step = hs[r * row // 256 : (r + 1) * row // 256]
        worst = max(worst, float((d / step).max()))
        check(bool((d <= step * (0.5 + 254 * 2.0**-24)).all()), f"row {r}: dequantized beyond half a step")
    peak = torch.cuda.max_memory_allocated()
    del rows, deq, hq, hs
    torch.cuda.empty_cache()
    free_pinned_cache()
    return dict(codec="copy", compress=True, create_s=create_s, d2h_s=d2h_s,
                d2h_gbps=prog.pcie_bytes / d2h_s / 1e9, dequantize_s=deq_s,
                worst_err_in_steps=worst, pcie_bytes=prog.pcie_bytes, peak_device_gb=peak / 1e9,
                own_bytes=prog.own_bytes, exchanged_bytes=prog.exchanged_bytes, d2h_bytes=d2h_bytes,
                own_d2h_bytes=own_d2h_bytes, code_d2h_bytes=code_d2h_bytes)


def mirror_run(state, layout, mesh, want_sum: list[int]) -> dict:
    """The hot-replica transport, ``build_mirror_program`` with
    ``validate=True``: every primary coordinate's fused bucket lands on its
    shadow twin (i + 4 of the 8 data coordinates), the folded checksum (B1)
    equals the main runs' (held against ``np_checksum`` of the staged host
    bytes there), and the mirrored buffers, re-aligned by the copy codec's
    ``restore_fn``, are byte-equal to every exchanged leaf of the state."""
    import torch

    from repro_torch.core.device_tier import build_mirror_program
    from repro_torch.utils.pytree import tree_flatten

    prog = build_mirror_program(mesh, layout.sds, layout.pspecs)
    check([b.tag for b in prog.buckets] == ["data:float32"], f"buckets {[b.tag for b in prog.buckets]}")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = prog.snapshot_fn(state)
    torch.cuda.synchronize()
    mirror_s = time.perf_counter() - t0
    check(sorted(payload) == ["checksum", "mirror"], f"mirror payload keys {sorted(payload)}")
    got_sum = [c & 0xFFFFFFFF for c in payload["checksum"].view(torch.int32).cpu().tolist()]
    check(got_sum == want_sum, f"mirror checksum {got_sum} != the main runs' {want_sum}")
    t0 = time.perf_counter()
    restored = prog.restore_fn({"partner": payload.pop("mirror")})
    torch.cuda.synchronize()
    realign_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_flatten(state)[1]
    check(sorted(restored) == sorted(prog.exchanged_names), "restore_fn returned every exchanged leaf")
    for name, x in restored.items():
        check(torch.equal(_int_view(x), _int_view(leaves[int(name)])), f"mirror: leaf {name} differs")
    del payload, restored
    torch.cuda.empty_cache()
    fused = sum(b.words * 4 * mesh.size for b in prog.buckets)
    return dict(mirror_s=mirror_s, mirror_gbps=fused / mirror_s / 1e9, realign_s=realign_s,
                exchanged_bytes=prog.exchanged_bytes, pcie_bytes=prog.pcie_bytes, peak_device_gb=peak / 1e9)


def tree_nbytes(tree) -> int:
    """Bytes of the tensors of a tree, as they lie in memory (numel x item
    size)."""
    from repro_torch.utils.pytree import tree_flatten

    return sum(x.numel() * x.element_size() for x in tree_flatten(tree)[1])


def free_pinned_cache() -> None:
    """Return the pinned host blocks PyTorch caches after a staged fetch
    (where this PyTorch build exposes the call)."""
    import torch

    fn = getattr(torch._C, "_host_emptyCache", None) or getattr(torch._C, "_accelerator_emptyHostCache", None)
    if fn is not None:
        fn()


def device_tier_path(state, layout, mesh) -> tuple[dict, list[dict]]:
    """The llama3.2-1b train state on the card through every run of
    MAIN_RUNS, the compressed copy run and the mirror run; returns the
    kernels' launch counts over this path alone."""
    import torch

    from repro_torch.kernels import ops

    runs = []
    ops.reset_launch_counts()  # this path's counts start here
    for codec, g, m, kill in MAIN_RUNS:
        before = ops.launch_counts()
        run = main_run(state, layout, mesh, codec, g, m, kill)
        after = ops.launch_counts()
        run["launches"] = {k: after[k] - before[k] for k in after}
        runs.append(run)
        torch.cuda.empty_cache()
        free_pinned_cache()
        run["host_free_after_gib"] = host_free_gib()
        log(f"main {codec} g={g} m={m} kill {list(kill)}: " + json.dumps(run))
    before = ops.launch_counts()
    run = compressed_run(state, layout, mesh)
    after = ops.launch_counts()
    run["launches"] = {k: after[k] - before[k] for k in after}
    runs.append(run)
    log("main copy compress=True: " + json.dumps(run))
    before = ops.launch_counts()
    run = mirror_run(state, layout, mesh, runs[0]["checksum"])
    after = ops.launch_counts()
    run["launches"] = {k: after[k] - before[k] for k in after}
    check(run["launches"]["checksum"] > 0, "the mirror program launched no checksum (B1)")
    runs.append(run)
    log("main mirror (validate=True): " + json.dumps(run))
    counts = ops.launch_counts()
    for name in DEVICE_TIER_KERNELS:
        check(counts[name] > 0, f"kernel {name} was launched no time on the device-tier path")
    return counts, runs


# ---------------------------------------------------------------------------
# phase 4b: the dry run's accounting against what phase 4 built and launched
# ---------------------------------------------------------------------------

DRYRUN_CLI = ("--arch", ARCH, "--shape", "train_4k", "--mesh", "single", "--snapshot", "--restore")


class DryrunCli:
    """The dry-run CLI (``DRYRUN_CLI``) in a child process on meta tensors,
    started before phase 12 so that it runs on the host beside phases 12, 13
    and 4 (the child's imports alone take seconds on the checkout's
    filesystem). It counts on one thread, so those phases' host work keeps
    the other cores.
    ``records()`` waits for it and returns its records; ``stop()`` kills it
    if it still runs and removes its directory."""

    def __init__(self) -> None:
        self.out = tempfile.mkdtemp(prefix="dryrun-")
        self.t0 = time.perf_counter()
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
        self.proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_CLI,
                                      "--out", self.out], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True, cwd=ROOT, env=env)

    def records(self) -> dict:
        try:
            _, err = self.proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            self.stop()
            fail("the dry-run CLI took more than 300 s")
        check(self.proc.returncode == 0, f"the dry-run CLI exited {self.proc.returncode}: {err[-2000:]}")
        cells = {name: json.loads(Path(self.out, name).read_text())
                 for name in sorted(os.listdir(self.out)) if name.endswith(".json")}
        return dict(cells=cells, cli_s=time.perf_counter() - self.t0)

    def stop(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        shutil.rmtree(self.out, ignore_errors=True)


def rank_shard_bytes(leaves, specs, mesh) -> list[int]:
    """Bytes of each rank's shard tensors of the state on the card, rank by
    rank over the mesh: every leaf cut with ``tensor_split`` along its
    sharded dims at the rank's coordinates (numel x item size of the piece)."""
    import itertools

    from repro_torch.sharding.mesh import axes_of, full_rank

    out = []
    for coord in itertools.product(*(range(n) for n in mesh.shape.values())):
        at = dict(zip(mesh.shape, coord))
        n = 0
        for x, spec in zip(leaves, specs):
            for d, e in enumerate(full_rank(spec, x.ndim)):
                k, i = 1, 0
                for a in axes_of(e):
                    k, i = k * mesh.shape[a], i * mesh.shape[a] + at[a]
                if k > 1:
                    x = x.tensor_split(k, dim=d)[i]
            n += x.numel() * x.element_size()
        out.append(n)
    return out


def dryrun_path(cfg, state, layout, mesh, runs4, cli: DryrunCli) -> dict:
    """``launch/dryrun.py``'s accounting of phase 4's own layout (``cfg`` on
    the (8, 1) mesh) held against what phase 4's runs moved and what the
    card holds:

    * each striped run: the snapshot cell's ``own_bytes_global`` and
      ``pcie_bytes_global`` equal the bytes of the pinned host buffers the
      staged fetch filled (the own copy, and all of them); the restore
      cell's ``pcie_bytes_global`` equals the held stripes uploaded to the
      card plus the exchanged leaves the restore rebuilt there (the survivor
      shards a host-to-card restore uploads), and ``host_decode_pcie_bytes``
      those leaves' bytes more again;
    * the compressed copy run: the own copy as above, and the int8 codes
      fetched equal to the accounted payload up to each row's padding to
      whole 256-word blocks (the block scales the accounting leaves out, as
      the reference's does, are printed beside it);
    * the train cell's per-device state bytes: the worst rank's shard
      tensors of the state on the card (``rank_shard_bytes``), every rank
      holding as much, so per-device x 8 is the state plus 7 more copies of
      the leaves every rank holds whole.

    ``exchanged_bytes_global`` counts what the reference's collectives
    move between chips; one card moves none of it, so it is printed, not
    held. Then the CLI's records, each printed and each accounted. It
    measures bytes, not time."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_step
    from repro_torch.sharding.mesh import axes_of, full_rank
    from repro_torch.utils.pytree import tree_flatten

    out: dict = {"programs": []}
    for run in runs4:
        if "codec" not in run:
            continue  # the mirror run: no dry-run cell
        codec = run["codec"]
        if run.get("compress"):
            acc = dryrun.snapshot_accounting(cfg, mesh, compress=True)
            codes = acc["pcie_bytes_global"] - acc["own_bytes_global"]
            check(acc["own_bytes_global"] == run["own_d2h_bytes"],
                  f"compressed own bytes {acc['own_bytes_global']} != {run['own_d2h_bytes']} fetched")
            check(0 <= run["code_d2h_bytes"] - codes < 256 * mesh.size,
                  f"compressed codes {codes} accounted, {run['code_d2h_bytes']} fetched")
            row = dict(own_bytes=acc["own_bytes_global"], pcie_bytes=acc["pcie_bytes_global"],
                       d2h_bytes=run["d2h_bytes"], code_d2h_bytes=run["code_d2h_bytes"],
                       scale_d2h_bytes=run["d2h_bytes"] - run["own_d2h_bytes"] - run["code_d2h_bytes"])
        else:
            acc = dryrun.snapshot_accounting(cfg, mesh, codec=codec, parity_group=run["g"], rs_parity=run["m"])
            rest = dryrun.restore_accounting(cfg, mesh, codec=codec, parity_group=run["g"], rs_parity=run["m"])
            got = (acc["own_bytes_global"], acc["pcie_bytes_global"], rest["pcie_bytes_global"],
                   rest["host_decode_pcie_bytes_global"])
            seen = (run["own_d2h_bytes"], run["d2h_bytes"], run["h2d_bytes"] + run["restored_bytes"],
                    run["h2d_bytes"] + 2 * run["restored_bytes"])
            check(got == seen, f"dry run's {codec} (own, pcie, restore pcie, host decode) {got} != phase 4's {seen}")
            row = dict(own_bytes=got[0], pcie_bytes=got[1], restore_pcie_bytes=got[2], host_decode_pcie_bytes=got[3],
                       h2d_bytes=run["h2d_bytes"], restored_bytes=run["restored_bytes"])
        out["programs"].append(dict(codec=codec, compress=bool(run.get("compress")),
                                    exchanged_bytes=acc["exchanged_bytes_global"], **row))
    check(len(out["programs"]) == len(MAIN_RUNS) + 1, f"{len(out['programs'])} runs of phase 4 accounted")

    # the train cell's memory accounting (``run_cell(..., fast=True)``'s) of
    # ``cfg``, the depth phase 4 ran
    memory = dryrun.memory_accounting(build_step(cfg, "train_4k", mesh))
    per_device = memory["argument_bytes_by_input"]["state"]
    _, leaves = tree_flatten(state)
    _, specs = tree_flatten(layout.pspecs)
    ranks = rank_shard_bytes(leaves, specs, mesh)
    allocated = sum(x.numel() * x.element_size() for x in leaves)
    whole = sum(x.numel() * x.element_size() for x, spec in zip(leaves, specs)
                if math.prod(mesh.shape[a] for e in full_rank(spec, x.ndim) for a in axes_of(e)) == 1)
    check(ranks == [per_device] * mesh.size, f"per-device state bytes {per_device}, ranks hold {ranks}")
    check(per_device * mesh.size == allocated + (mesh.size - 1) * whole,
          f"per-device state bytes {per_device} x {mesh.size} != {allocated} + {mesh.size - 1} x {whole}")
    out["state"] = dict(per_device_bytes=per_device, allocated_bytes=allocated, whole_leaf_bytes=whole,
                        argument_size_in_bytes=memory["argument_size_in_bytes"])

    t0 = time.perf_counter()
    got = cli.records()
    out.update(cli_s=got["cli_s"], cli_wait_s=time.perf_counter() - t0)
    for name, cell in got["cells"].items():
        log(f"dryrun cli {name}: " + json.dumps(cell))
        check(cell["status"] == "accounted", f"{name}: {cell['status']}")
    check(len(got["cells"]) == 3, "the CLI wrote the train, snapshot and restore cells")
    out["cli"] = got["cells"]
    log("dryrun path: " + json.dumps({k: v for k, v in out.items() if k != "cli"}))
    return out


# ---------------------------------------------------------------------------
# phase 4c: the device tier over processes, one per coordinate of the mesh
# ---------------------------------------------------------------------------

# One card: NCCL refuses two ranks on one device, so the processes share the
# card over gloo, which stages every message through host memory. The NCCL
# leg (device buffers straight onto the wire) needs one card per process.
RANK_BACKEND = "gloo"
RANK_MESH = ((8, 1), ("data", "model"))  # phase 4's mesh, one process a coordinate
RANK_LAYERS = 1  # phase 4's layout cut to 1 layer (4.53 GB), width kept
RANK_RUNS = (("rs", 4, 2, (0, 2)), ("xor", 4, 1, (5,)))  # then the compressed copy and the mirror program
RANK_KERNELS = ("checksum", "xor_reduce", "gf256_matmul", "gf256_matmul_dyn", "quantize_blockwise")


def payload_digests(payload: dict) -> dict:
    """SHA-256 of each bucket's payload block (all its rows, in order) and
    the checksum's words: ``{"checksum": [..], "<key>/<tag>[/part]": hex}``.
    A payload's arrays are contiguous blocks; stacked coordinate rows are
    split by the caller before this."""
    import hashlib

    import torch

    out = {}
    for key, val in payload.items():
        if key == "checksum":
            out[key] = [c & 0xFFFFFFFF for c in val.view(torch.int32).cpu().tolist()]
            continue
        for tag, x in val.items():
            for part, t in (x.items() if isinstance(x, dict) else [("", x)]):
                h = hashlib.sha256()
                for row in t.reshape(t.shape[0] if t.ndim > 1 else 1, -1):
                    h.update(_int_view(row.contiguous()).cpu().numpy().tobytes())
                out[f"{key}/{tag}" + (f"/{part}" if part else "")] = h.hexdigest()
    return out


def coordinate_rows(payload: dict, buckets, mesh, coord: int) -> dict:
    """One coordinate's block of a one-card payload: the reference's per-device
    slice (dim 0 of a partner buffer, dim 1 of a parity stack, laid out over
    the bucket's axes; every bucket of this layout spans the whole mesh)."""
    out = {}
    for key, val in payload.items():
        if key == "checksum":
            out[key] = val
            continue
        out[key] = {}
        for tag, x in val.items():
            b = next(b for b in buckets if b.tag == tag)
            n = math.prod(mesh.shape[a] for a in b.axes)
            check(n == mesh.size, f"bucket {tag} spans {n} of {mesh.size} coordinates")
            if isinstance(x, dict):
                out[key][tag] = {p: t.view(n, -1)[coord] for p, t in x.items()}
            elif key == "parity":
                out[key][tag] = x.view(x.shape[0], n, -1)[:, coord]
            else:
                out[key][tag] = x.view(n, -1)[coord]
    return out


def rank_programs(mesh, layout):
    """The programs phase 4c runs, on either mesh, in order: the striped
    runs (snapshot and restore), the compressed copy and the mirror."""
    from repro_torch.core.device_tier import (
        build_mirror_program, build_snapshot_program, build_striped_restore_program,
    )

    progs = []
    for codec, g, m, kill in RANK_RUNS:
        progs.append((f"{codec}", build_snapshot_program(mesh, layout.sds, layout.pspecs, codec=codec, parity_group=g,
                                                         rs_parity=m, include_own_copy=False),
                      build_striped_restore_program(mesh, layout.sds, layout.pspecs, codec=codec, parity_group=g,
                                                    rs_parity=m), (codec, g, m, kill)))
    progs.append(("compress", build_snapshot_program(mesh, layout.sds, layout.pspecs, compress=True,
                                                     include_own_copy=False), None, None))
    progs.append(("mirror", build_mirror_program(mesh, layout.sds, layout.pspecs), None, None))
    return progs


def rank_body(rank: int, world: int, init_method: str, device: str, cfg, receive) -> dict:
    """Phase 4c in one process, started before phase 4 (``start_ranks``):
    join the (8, 1) process mesh, lay out ``cfg``'s train state (already cut
    to RANK_LAYERS) over it and build the programs; then wait for the
    process's own shards of the state (``receive()``), copy its exchanged
    leaves out of the parent's tensors, which stay the originals (the leaves
    every coordinate holds whole are read in place), and run each program of
    ``rank_programs`` with its checks. Returns the digests, times, bytes sent
    and launch counts."""
    import torch
    import torch.distributed as tdist

    from repro_torch.core.device_tier import overwrite_shards, striped_decode_rows
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.launch.steps import train_state_layout
    from repro_torch.sharding.mesh import make_mesh
    from repro_torch.utils.pytree import tree_flatten, tree_unflatten

    entered = time.time()
    torch.set_num_threads(1)  # eight processes share the host's cores
    on_card = device != "cpu"
    mesh = init_process_mesh(*RANK_MESH, RANK_BACKEND, rank=rank, world_size=world, init_method=init_method,
                             device=None if on_card else "cpu")
    layout = train_state_layout(cfg, make_mesh(*RANK_MESH, device="meta"))
    progs = rank_programs(mesh, layout)
    exchanged = {int(i) for i in progs[0][1].exchanged_names}
    initialised = time.time()
    shards, = receive()
    paths, originals = tree_flatten(shards)
    live = tree_unflatten(paths, [x.clone() if i in exchanged else x for i, x in enumerate(originals)])
    tp = mesh.transport

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()
        tdist.barrier()

    def intact() -> bool:
        _, now = tree_flatten(live)
        return all(torch.equal(_int_view(now[i]), _int_view(originals[i])) for i in exchanged)

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    ready = time.time()
    ops.reset_launch_counts()  # the main path's counts start here
    runs = []
    for name, prog, rest, spec in progs:
        run = dict(name=name)
        sync()
        tp.reset_counts()
        t0 = time.perf_counter()
        payload = prog.snapshot_fn(live)
        sync()
        run.update(create_s=time.perf_counter() - t0, sent_bytes=tp.sent_bytes, recv_bytes=tp.recv_bytes,
                   program_sent_bytes=prog.sent_bytes)
        check(tp.sent_bytes == prog.sent_bytes, f"rank {rank} {name}: sent {tp.sent_bytes} bytes, the program "
              f"accounts {prog.sent_bytes}")
        if name == "mirror":
            payload["partner"] = payload.pop("mirror")
        run["digests"] = payload_digests(payload)
        if name == "mirror":  # the shadow copies re-aligned by the copy codec's restore_fn
            sync()
            t0 = time.perf_counter()
            restored = prog.restore_fn(payload)
            sync()
            run["restore_s"] = time.perf_counter() - t0
            run["restored_equal"] = all(torch.equal(_int_view(restored[str(i)]), _int_view(originals[i]))
                                        for i in exchanged)
        elif rest is not None:
            codec, g, m, kill = spec
            overwrite_shards(mesh, live, layout.pspecs, "data", kill)  # the killed ranks' memory
            parity = payload["parity"]
            if rank in kill:  # and the stripes they held
                for t in parity.values():
                    t.view(torch.int32).fill_(0x63636363)
            run["killed"] = rank in kill
            rows, mask = striped_decode_rows(RANK_MESH[0][0], g, codec, m, set(kill))
            sync()
            tp.reset_counts()
            t0 = time.perf_counter()
            rest.restore_fn(live, parity, {"data": rows}, {"data": mask})
            sync()
            run.update(restore_s=time.perf_counter() - t0, restore_sent_bytes=tp.sent_bytes)
            run["restored_equal"] = intact()
        del payload
        runs.append(run)
    return dict(rank=rank, coords=mesh.coords, runs=runs, launches=ops.launch_counts(), entered=entered,
                initialised=initialised, ready=ready, done=time.time(),
                peak_device_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0)


def rank_shards(state, layout, mesh, rank: int) -> dict:
    """Process ``rank``'s shards of the state: a contiguous copy of each leaf
    split over the mesh (its block at the rank's coordinate); a leaf every
    coordinate holds whole is the state's own tensor, shared."""
    from repro_torch.core.device_tier import local_shards
    from repro_torch.sharding.mesh import axes_of, coords_of
    from repro_torch.utils.pytree import tree_flatten, tree_unflatten

    paths, leaves = tree_flatten(state)
    _, specs = tree_flatten(layout.pspecs)
    split = [i for i, s in enumerate(specs) if any(mesh.shape[a] > 1 for e in s for a in axes_of(e))]
    cut = tree_flatten(local_shards(mesh, tree_unflatten([paths[i] for i in split], [leaves[i] for i in split]),
                                    tree_unflatten([paths[i] for i in split], [specs[i] for i in split]),
                                    coords=coords_of(mesh.axes, rank)))[1]
    out = list(leaves)
    for i, x in zip(split, cut):
        out[i] = x
    return tree_unflatten(paths, out)


def start_ranks(cfg):
    """Start phase 4c's processes (``rank_body``) before phase 4, so that
    their start-up (the interpreter, CUDA, the group, the programs) runs
    beside it; they then wait for their shards. The kernels are built here,
    once: the processes load the libraries and never run nvcc."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import RankGroup

    _build.build()
    check(all(_build.lib_path(n).exists() for n in _build.KERNELS), "phase 4c: the kernels are not built")
    group = RankGroup(rank_body, math.prod(RANK_MESH[0]), args=("cuda", replace(cfg, num_layers=RANK_LAYERS)),
                      late=True)
    group.started = time.time()
    return group


def rank_path(cfg, group) -> tuple[dict, dict]:
    """Phase 4c: phase 4's layout cut to RANK_LAYERS layer on RANK_MESH as
    one process per coordinate (``group``, from ``start_ranks``), sharing the
    card over RANK_BACKEND: the rs and xor runs of RANK_RUNS (create, kill,
    restore on the killed processes with B4), the compressed copy (B5a) and
    the mirror program (and its copy restore). Every process's payload
    digest equals its coordinate's rows of the one-card program on the same
    layout (run here while the processes run theirs), the handshake checksum
    is the same on every process, the restored shards equal the originals,
    each process sent what its program accounts, and B1-B5a launched on the
    processes. Returns the processes' launch counts, summed, and the runs."""
    import torch

    from repro_torch.launch.steps import init_train_state, train_state_layout
    from repro_torch.sharding.mesh import make_mesh

    world = math.prod(RANK_MESH[0])
    cfg = replace(cfg, num_layers=RANK_LAYERS)
    mesh = make_mesh(*RANK_MESH)
    t0, fed = time.perf_counter(), time.time()
    try:
        layout = train_state_layout(cfg, mesh)
        state = init_train_state(layout, mesh, torch.Generator(device="cuda").manual_seed(SEED))
        shards = [rank_shards(state, layout, mesh, r) for r in range(world)]
        torch.cuda.synchronize()
        log(f"phase 4c: {ARCH} at {RANK_LAYERS} layer, {tree_nbytes(state) / 1e9:.3f} GB, as {world} processes on "
            f"one card over {RANK_BACKEND} (one card: NCCL refuses two ranks on one device, so every message is "
            f"staged through host memory)")
        group.feed([(s,) for s in shards])
        t1 = time.perf_counter()
        want = {}  # the one-card program's rows, while the processes run
        for name, prog, _, _ in rank_programs(mesh, layout):
            payload = prog.snapshot_fn(state)
            if name == "mirror":
                payload["partner"] = payload.pop("mirror")
            want[name] = [payload_digests(coordinate_rows(payload, prog.buckets, mesh, r)) for r in range(world)]
            del payload
        one_card_s = time.perf_counter() - t1
        results = group.join(timeout=600)
    finally:
        group.stop()
    wall_s = time.perf_counter() - t0
    state_bytes = tree_nbytes(state)
    del shards, state
    torch.cuda.empty_cache()
    counts: dict = {}
    for res in results:
        for k, v in res["launches"].items():
            counts[k] = counts.get(k, 0) + v
    checksums = {json.dumps(run["digests"]["checksum"]) for res in results for run in res["runs"]
                 if "checksum" in run["digests"]}
    check(len(checksums) == 1, f"phase 4c: the handshake checksum differs between processes or runs: {checksums}")
    one_sum = {json.dumps(rows[0]["checksum"]) for name, rows in want.items() if "checksum" in rows[0]}
    check(checksums == one_sum, f"phase 4c: checksum {checksums} != the one-card program's {one_sum}")
    for res in results:
        r = res["rank"]
        check(res["coords"] == {"data": r, "model": 0}, f"phase 4c: rank {r} at {res['coords']}")
        for run in res["runs"]:
            check(run["digests"] == want[run["name"]][r],
                  f"phase 4c: rank {r}'s {run['name']} payload differs from the one-card program's rows")
            if "restored_equal" in run:
                check(run["restored_equal"], f"phase 4c: rank {r}'s shards differ after the {run['name']} restore")
        log(f"phase 4c rank {r}: " + ", ".join(
            f"{run['name']} create {run['create_s']:.3f} s" + (f" restore {run['restore_s']:.3f} s"
                                                               if "restore_s" in run else "")
            + f" sent {run['sent_bytes']}" + (f"+{run['restore_sent_bytes']}" if "restore_sent_bytes" in run else "")
            for run in res["runs"]) + f"; card peak {res['peak_device_gb']:.2f} GB")
    for name in RANK_KERNELS:
        check(counts.get(name, 0) > 0, f"phase 4c: kernel {name} was launched no time on the processes")
    # the time split, from this phase's start: every process initialised
    # (started before phase 4: the interpreter, CUDA, the group, the
    # programs), every process ready (its shards received and copied), the
    # runs done, and the rest (results, teardown)
    out = dict(
        wall_s=wall_s, one_card_s=one_card_s,
        entered_s=max(res["entered"] for res in results) - group.started,
        initialised_s=max(res["initialised"] for res in results) - fed,
        start_up_beside_phase4_s=fed - group.started,
        ready_s=max(res["ready"] for res in results) - fed,
        runs_s=max(res["done"] for res in results) - max(res["ready"] for res in results),
        after_s=fed + wall_s - max(res["done"] for res in results),
        backend=RANK_BACKEND, world=world, layers=RANK_LAYERS, state_bytes=state_bytes,
        runs=[dict(rank=res["rank"], peak_device_gb=res["peak_device_gb"],
                   runs=[{k: v for k, v in run.items() if k != "digests"} for run in res["runs"]])
              for res in results])
    log("phase 4c: " + json.dumps(out))
    log(f"phase 4c launches (the processes'): {json.dumps(counts)}")
    return counts, out


# ---------------------------------------------------------------------------
# phase 5: the host-tier checkpoint engine at full width
# ---------------------------------------------------------------------------

ENGINE_RANKS = 4  # the quickstart's virtual failure-domain hosts
HOST_HEADROOM_GIB = 6.0
# Depth of phases 5, 6 and 8 (llama3.2-1b has 16 layers; width is never
# cut): their creates cost about 1.3 s per GB staged, most of it pinning
# fresh arenas (at one layer the embedding's optimizer state is most of a
# generation), which leaves the run time for phases 7 and 9
PATH_LAYERS = 1
# phase 5's cycles: the reference's default engine, compressed, and
# compressed with the drain over 4 workers (each quantizing on its own stream)
ENGINE_CYCLES = (("default", {}), ("compress", {"compress": True}),
                 ("compress, 4 workers", {"compress": True, "async_workers": 4}))


def engine_host_need_gib(layout, plan) -> float:
    """Host RAM one engine cycle holds at its peak: the own arenas of all
    ranks, the exchange arenas, the compressed copies, and ``np_checksum``'s
    weight table (uint32, a power of two at least the largest own buffer's
    words). The capture copies each leaf from the card straight into its
    pinned arena: no host copy of the state besides."""
    from repro_torch.utils.pytree import tree_flatten

    sizes = [int(math.prod(sd.shape)) * sd.dtype.itemsize for sd in tree_flatten(layout.sds)[1]]
    split = sum(b for i, b in enumerate(sizes) if plan.split_dim(i, ENGINE_RANKS) is not None)
    repl = sum(sizes) - split
    own_max_words = (repl + split // ENGINE_RANKS) // 4
    weights = 4 * (1 << max(own_max_words - 1, 1).bit_length())
    need = ENGINE_RANKS * repl + split + split + split // 4 + weights
    return need / 2**30


def _int_view(t):
    import torch

    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def create_line(stats) -> dict:
    """A committed create's times from the engine's stats."""
    return dict(capture_s=stats.last_capture_s, blocked_s=stats.last_blocked_s,
                finalize_wait_s=stats.last_finalize_wait_s, create_s=stats.last_create_s,
                bytes_staged=stats.last_bytes_staged, drain_units=stats.last_pipeline_chunks)


def restore_line(stats, pipelined: bool = True) -> dict:
    """A restore's time from the engine's stats, with the pipeline's chunk
    count and drain time when it ran the pipeline (the sync restore leaves
    those gauges as the last pipelined restore set them)."""
    if not pipelined:
        return dict(restore_s=stats.last_restore_s)
    return dict(restore_s=stats.last_restore_s, restore_chunks=stats.last_restore_chunks,
                decode_s=stats.last_restore_decode_s, decompressed_bytes=stats.last_restore_decompressed_bytes)


@contextlib.contextmanager
def d2h_meter():
    """While the block runs: bytes and seconds of the engine's packs whose
    leaves lie on the card (the capture's device-to-host copies into pinned
    arenas, their arenas' pinning excluded), and bytes and seconds of the
    arenas pinned; yields {"bytes", "s", "pinned_bytes", "pin_s"}."""
    import torch

    from repro_torch.core import checkpoint, hoststore
    from repro_torch.utils.pytree import tree_flatten

    pack, pin = checkpoint.pack_bytes, hoststore.pinned_empty
    acc = {"bytes": 0, "s": 0.0, "pinned_bytes": 0, "pin_s": 0.0}

    def timed_pin(nbytes):
        t0 = time.perf_counter()
        out = pin(nbytes)
        acc["pin_s"] += time.perf_counter() - t0
        acc["pinned_bytes"] += nbytes
        return out

    def timed_pack(tree, *a, **k):
        on_card = any(isinstance(x, torch.Tensor) and x.is_cuda for x in tree_flatten(tree)[1])
        t0, pin_s = time.perf_counter(), acc["pin_s"]
        out = pack(tree, *a, **k)
        if on_card:
            acc["s"] += time.perf_counter() - t0 - (acc["pin_s"] - pin_s)
            acc["bytes"] += out[0].numel()
        return out

    checkpoint.pack_bytes, hoststore.pinned_empty = timed_pack, timed_pin
    try:
        yield acc
    finally:
        checkpoint.pack_bytes, hoststore.pinned_empty = pack, pin


def engine_cycle(state, originals, plan, cfg_kw: dict, n_ranks: int = ENGINE_RANKS, kills=(2,)) -> dict:
    """A background create (``checkpoint_async`` then ``finalize_async``) on
    ``n_ranks`` hosts → overwrite the live state → wipe the ``kills`` hosts'
    stores → the pipelined restore, then every leaf checked against the
    originals: byte-exact, except the killed ranks' quantized leaves under
    compress with the copy codec, which must equal the plain
    dequantize(quantize(x)) of the originals bit for bit. Then the same
    committed generation restored by the sync restore and checked the same
    way: the two restores give the same bytes. The host's resident set is
    sampled throughout (its peak over the cycle)."""
    import resource

    import torch

    from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
    from repro_torch.core.integrity import np_checksum
    from repro_torch.kernels import ref
    from repro_torch.obs.trace import tracer
    from repro_torch.runtime.state import RngEntity, ShardedStateEntity
    from repro_torch.utils.pytree import tree_flatten

    compress = bool(cfg_kw.get("compress"))
    eng = CheckpointEngine(n_ranks, EngineConfig(**cfg_kw))
    rng = RngEntity()
    rng.seed, rng.counter = SEED, 17
    eng.register("state", ShardedStateEntity(lambda: state, plan))
    eng.register("rng", rng)
    live = tree_flatten(state)[1]
    tr = tracer()
    tr.reset()
    tr.enable()
    free0 = host_free_gib()
    rss = rss_sampler()
    torch.cuda.synchronize()
    with d2h_meter() as d2h:
        check(eng.checkpoint_async({"step": 1}), "checkpoint_async: the capture failed")
    check(eng._pending.future is not None, "the default engine drains in the background")
    check(eng.finalize_async() is True, "finalize_async: the handshake failed")
    create = create_line(eng.stats)
    free1 = host_free_gib()
    exch = sum(st.buffer.read_only.own_exch.get("state", st.buffer.read_only.own["state"])[0].numel()
               for st in eng.stores.values())
    pinned = all(a.is_pinned() for st in eng.stores.values() for a in st._arenas.values())
    check(pinned, "an arena of the engine on the card is not pinned")
    # the host checksum's rate on this machine, over rank 0's own buffer
    own0 = eng.stores[0].buffer.read_only.own["state"][0]
    t0 = time.perf_counter()
    np_checksum(own0.numpy())
    checksum_gbps = own0.numel() / (time.perf_counter() - t0) / 1e9

    def overwrite_and_restore(pipelined: bool) -> dict:
        for leaf in live:  # the live state moves on: every byte overwritten
            leaf.fill_(7)
        rng.seed = rng.counter = 0
        meta = eng.restore()
        torch.cuda.synchronize()
        check(meta["step"] == 1 and (rng.seed, rng.counter) == (SEED, 17), "restore: meta or rng entity")
        quantized = exact = 0
        for i, (x, o) in enumerate(zip(live, tree_flatten(originals)[1])):
            d = plan.split_dim(i, n_ranks)
            if d is None:
                check(torch.equal(_int_view(x), _int_view(o)), f"leaf {i} (replicated) differs after restore")
                exact += 1
                continue
            for r, (xs, os) in enumerate(zip(x.chunk(n_ranks, d), o.chunk(n_ranks, d))):
                if r in kills and compress and o.is_floating_point() and os.numel() >= 256:
                    flat = os.reshape(-1)
                    pad = torch.zeros(-(-flat.numel() // 8192) * 8192, dtype=flat.dtype, device=flat.device)
                    pad[: flat.numel()] = flat
                    want = ref.dequantize_blockwise(*ref.quantize_blockwise(pad))[: flat.numel()].to(o.dtype)
                    check(torch.equal(_int_view(xs.reshape(-1)), _int_view(want)),
                          f"leaf {i} rank {r}: not the plain dequantize(quantize(x))")
                    quantized += 1
                else:
                    check(torch.equal(_int_view(xs), _int_view(os)), f"leaf {i} rank {r} differs after restore")
                    exact += 1
        return dict(**restore_line(eng.stats, pipelined), exact_pieces=exact, quantized_pieces=quantized)

    for r in kills:
        eng.stores[r].wipe()
    pipelined = overwrite_and_restore(True)
    check(pipelined["restore_chunks"] > 0, "the default engine's restore did not run the pipeline")
    tr.disable()
    spans: dict[str, float] = {}
    for ev in tr.events():
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"]
    tr.reset()
    eng.cfg = EngineConfig(**{**cfg_kw, "restore_mode": "sync"})
    sync = overwrite_and_restore(False)
    check((pipelined["exact_pieces"], pipelined["quantized_pieces"]) == (sync["exact_pieces"], sync["quantized_pieces"]),
          "the pipelined and the sync restore checked different pieces")
    stats = eng.stats
    out = dict(engine=cfg_kw, create=create, d2h_gbps=d2h["bytes"] / max(d2h["s"], 1e-9) / 1e9,
               d2h_bytes=d2h["bytes"], d2h_s=d2h["s"], pinned_bytes=d2h["pinned_bytes"], pin_s=d2h["pin_s"],
               pinned_arenas=pinned,
               restore_pipelined=pipelined, restore_sync=sync,
               bytes_exchanged=stats.last_bytes_exchanged, checksum_gbps=checksum_gbps,
               span_s={k: round(v, 6) for k, v in sorted(spans.items())},
               adopted=stats.adopted_restores, zero_comm=stats.zero_comm_restores,
               host_free_before_gib=free0, host_free_after_create_gib=free1,
               host_peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
               host_cycle_peak_rss_gib=rss(), reconstructed=stats.reconstructed_restores,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    if eng.codec.striped:
        # redundancy held on the hosts against the exchange bytes the copy
        # codec would hold (one whole copy of every exchange set)
        out.update(parity_bytes=stats.last_bytes_exchanged, exchange_bytes=exch,
                   parity_per_exchange_byte=stats.last_bytes_exchanged / max(exch, 1),
                   memory_overhead=eng.codec.memory_overhead(eng.codec.group_size(n_ranks), n_ranks))
    eng.close()
    del eng
    return out


def rss_sampler(period_s: float = 0.25):
    """Start sampling this process's resident set every ``period_s`` on a
    thread; the returned function stops it and gives the peak in GiB."""
    import threading

    samples = [host_rss_gib()]
    done = threading.Event()

    def run():
        while not done.wait(period_s):
            samples.append(host_rss_gib())

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def stop() -> float:
        done.set()
        t.join()
        return max(samples + [host_rss_gib()])

    return stop


def engine_path(cfg) -> tuple[dict, list[dict]]:
    """The host-tier engine over 4 ranks through ENGINE_CYCLES, on a seeded
    train state of PATH_LAYERS layers (fewer if the host lacks the RAM);
    returns the kernels' launch counts over this path alone."""
    import gc

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_train_state, train_state_layout
    from repro_torch.runtime.state import ShardPlan
    from repro_torch.sharding.mesh import make_mesh
    from repro_torch.utils.pytree import tree_flatten, tree_map

    mesh4 = make_mesh((ENGINE_RANKS, 1), ("data", "model"))

    def reckon(n_layers: int):
        layout = train_state_layout(replace(cfg, num_layers=n_layers), mesh4)
        plan = ShardPlan.from_pspecs(layout.sds, layout.pspecs)
        return layout, plan, engine_host_need_gib(layout, plan)

    layers = min(cfg.num_layers, PATH_LAYERS)
    layout, plan, need = reckon(layers)
    free = host_free_settled_gib(need + HOST_HEADROOM_GIB)
    while need + HOST_HEADROOM_GIB > free and layers > 1:
        layers //= 2
        layout, plan, need = reckon(layers)
    check(need + HOST_HEADROOM_GIB <= free, f"engine path: {need:.1f} GiB of host RAM needed, {free:.1f} free")
    log(f"engine: {layers} of {cfg.num_layers} layers, width kept (PATH_LAYERS {PATH_LAYERS}, for the run's "
        f"time; fewer only for the host's RAM): {free:.1f} GiB host RAM free, {need:.1f} GiB needed")
    state = init_train_state(layout, mesh4, torch.Generator(device="cuda").manual_seed(SEED))
    split = sum(plan.split_dim(i, ENGINE_RANKS) is not None for i in range(len(plan.dims)))
    log(f"engine: {layers} layers, {len(plan.dims)} leaves ({split} split over {ENGINE_RANKS} ranks), "
        f"host RAM {free:.1f} GiB free, about {need:.1f} GiB needed")
    originals = tree_map(lambda t: t.clone(), state)
    runs = []
    ops.reset_launch_counts()  # this path's counts start here
    for name, cfg_kw in ENGINE_CYCLES:
        for x, o in zip(tree_flatten(state)[1], tree_flatten(originals)[1]):
            x.copy_(o)
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        run = engine_cycle(state, originals, plan, cfg_kw)
        after = ops.launch_counts()
        run["launches"] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        runs.append(run)
        log(f"engine {name}: " + json.dumps(run))
        gc.collect()
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    del state, originals
    for name in ("quantize_blockwise", "dequantize_blockwise"):
        check(counts[name] > 0, f"kernel {name} was launched no time on the engine path")
    return counts, runs


# ---------------------------------------------------------------------------
# phase 8: the striped host codecs (rs, xor) with the GF(2^8) products on the card
# ---------------------------------------------------------------------------

STRIPED_RANKS = 8
# (name, EngineConfig fields, wiped hosts): rs g=4 m=2 losing two hosts of
# group 0 (whose blobs live whole on group 1; group 1 loses two stripes of
# each of its blobs and no data), and xor g=4 drained and restored over 4
# workers losing host 5; both with every GF product through B4
STRIPED_CYCLES = (
    ("rs", {"codec": "rs", "parity_group": 4, "rs_parity": 2, "gf_backend": "torch"}, (0, 2)),
    ("xor, 4 workers", {"parity_group": 4, "async_workers": 4, "gf_backend": "torch"}, (5,)),
)


def striped_host_need_gib(layout, plan) -> float:
    """Host RAM one striped cycle holds at its peak: all ranks' own arenas,
    the exchange arenas, the held stripes and the encode scratch (rs: half
    the exchange bytes each), the restore's blob and output arenas and the
    sync restore's rebuilt buffers (at most the exchange bytes), and
    ``np_checksum``'s weight table."""
    from repro_torch.utils.pytree import tree_flatten

    sizes = [int(math.prod(sd.shape)) * sd.dtype.itemsize for sd in tree_flatten(layout.sds)[1]]
    split = sum(b for i, b in enumerate(sizes) if plan.split_dim(i, STRIPED_RANKS) is not None)
    repl = sum(sizes) - split
    own_max_words = (repl + split // STRIPED_RANKS) // 4
    weights = 4 * (1 << max(own_max_words - 1, 1).bit_length())
    need = STRIPED_RANKS * repl + split + split + split + split + weights
    return need / 2**30


def striped_path(cfg) -> tuple[dict, list[dict]]:
    """The host engine over 8 ranks under STRIPED_CYCLES, on a seeded train
    state of PATH_LAYERS layers (fewer if the host lacks the RAM); every
    cycle must launch the GF(2^8) kernel B4. Returns the kernels' launch
    counts over this path alone."""
    import gc

    import torch

    from repro_torch.core import gf256
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_train_state
    from repro_torch.utils.pytree import tree_flatten, tree_map

    log("gf256 backends (probe: k=4, m=2, 256 KiB sources, best of 5; torch on the card): "
        + json.dumps({k: gf256._PROBE_GBPS.get(k) for k in gf256.available_backends()})
        + f" GB/s; the probe picks {gf256._SELECTED[0]}")
    layers = min(cfg.num_layers, PATH_LAYERS)
    mesh, layout, plan = layout_and_plan(replace(cfg, num_layers=layers), STRIPED_RANKS)
    need = striped_host_need_gib(layout, plan)
    free = host_free_settled_gib(need + HOST_HEADROOM_GIB)
    while need + HOST_HEADROOM_GIB > free and layers > 1:
        layers //= 2
        mesh, layout, plan = layout_and_plan(replace(cfg, num_layers=layers), STRIPED_RANKS)
        need = striped_host_need_gib(layout, plan)
    check(need + HOST_HEADROOM_GIB <= free, f"striped path: {need:.1f} GiB of host RAM needed, {free:.1f} free")
    log(f"striped: {layers} of {cfg.num_layers} layers, width kept (PATH_LAYERS {PATH_LAYERS}, for the run's "
        f"time; fewer only for the host's RAM), {STRIPED_RANKS} ranks: {free:.1f} GiB host RAM free, "
        f"{need:.1f} GiB needed")
    state = init_train_state(layout, mesh, torch.Generator(device="cuda").manual_seed(SEED))
    originals = tree_map(lambda t: t.clone(), state)
    runs = []
    ops.reset_launch_counts()  # this path's counts start here
    try:
        for name, cfg_kw, kills in STRIPED_CYCLES:
            for x, o in zip(tree_flatten(state)[1], tree_flatten(originals)[1]):
                x.copy_(o)
            torch.cuda.reset_peak_memory_stats()
            before = ops.launch_counts()
            run = engine_cycle(state, originals, plan, cfg_kw, n_ranks=STRIPED_RANKS, kills=kills)
            after = ops.launch_counts()
            run["launches"] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            run["killed"] = list(kills)
            check(run["launches"].get("gf256_matmul_dyn", 0) > 0, f"striped {name}: B4 was launched no time")
            check(run["reconstructed"] == 2 * len(kills), f"striped {name}: {run['reconstructed']} shards rebuilt")
            runs.append(run)
            log(f"striped {name}: " + json.dumps(run))
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        gf256.set_backend(None)  # the cycles forced the torch backend process-wide
    counts = ops.launch_counts()
    del state, originals
    return counts, runs


# ---------------------------------------------------------------------------
# phase 8b: failure-domain topology and the adaptive protection policy
# ---------------------------------------------------------------------------

# 16 ranks on 8 racks of 2 hosts: 4 groups of k=4, which the domain-aware
# packer lays out as {0,4,8,12}, {1,5,9,13}, {2,6,10,14}, {3,7,11,15}; 16
# divides every ZeRO-1 data dim (multiples of 16), so every split leaf
# stays split. The rack-1 burst {2, 3} wounds two groups once each and
# leaves two whole (with 8 ranks each group's blobs stripe over the other
# group, and a rack burst wounds both groups and their blobs alike).
TOPO_RANKS = 16
TOPO_HOSTS_PER_RACK = 2
TOPO_CFG = dict(codec="lrc", parity_group=4, rs_parity=2, lrc_locals=2, gf_backend="torch")
TOPO_RACK = 1      # the burst's rack: ranks 2 and 3
TOPO_SINGLE = 5    # the later single loss: a local-subgroup repair of group {1,5,9,13}
TOPO_SPARES = 3    # every stabilize of the phase a spare substitution


def topology_host_need_gib(layout, plan) -> float:
    """Host RAM phase 8b holds at its peak, its second create staging into
    the other bank beside the first generation: two banks of all ranks' own
    and exchange arenas, the held parity of lrc m=2 l=2 (1.0x the exchange
    bytes) and of lrc m=1 (0.75x), the encode scratch (1.0x, reused), the
    restore's blob and output arenas (at most the exchange bytes), and
    ``np_checksum``'s weight table."""
    from repro_torch.utils.pytree import tree_flatten

    sizes = [int(math.prod(sd.shape)) * sd.dtype.itemsize for sd in tree_flatten(layout.sds)[1]]
    split = sum(b for i, b in enumerate(sizes) if plan.split_dim(i, TOPO_RANKS) is not None)
    repl = sum(sizes) - split
    own_max_words = (repl + split // TOPO_RANKS) // 4
    weights = 4 * (1 << max(own_max_words - 1, 1).bit_length())
    need = 2 * (TOPO_RANKS * repl + split) + 2 * split + 1.75 * split + split + split + weights
    return need / 2**30


def topology_path(cfg) -> tuple[dict, dict]:
    """Phase 8b on a seeded train state of PATH_LAYERS layers (fewer if the
    host lacks the RAM), 16 ranks on ``ClusterTopology.regular(16,
    hosts_per_rack=2)``: a domain-aware lrc k=4 m=2 l=2 engine with every
    GF(2^8) product on B4, a ``VirtualCluster`` with spares and the
    ``ProtectionPolicy`` attached. One create; rack 1 killed through
    ``FailureInjector.schedule_domain_burst`` and ``cluster.kill`` (one
    arrival instant); the restore (before the spare substitution, so its
    record names the failed rack), ``stabilize("spare")``; the policy turns
    the single-domain burst into lrc m=1; a second create under it (its
    commit hook re-evaluates and changes nothing); one rank killed, the
    restore decoding lrc m=1 from the payload's codec record, stabilize.
    Returns the kernels' launch counts over this path and its numbers."""
    import gc
    import resource

    import torch

    from repro_torch.core import gf256
    from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
    from repro_torch.core.distribution import placement_conflicts
    from repro_torch.core.policy import ProtectionPolicy
    from repro_torch.core.topology import ClusterTopology
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_train_state
    from repro_torch.obs.journal import fit_failure_stats
    from repro_torch.obs.trace import tracer
    from repro_torch.runtime.cluster import VirtualCluster
    from repro_torch.runtime.failures import FailureInjector
    from repro_torch.runtime.state import RngEntity, ShardedStateEntity
    from repro_torch.utils.pytree import tree_flatten, tree_map

    layers = min(cfg.num_layers, PATH_LAYERS)
    mesh, layout, plan = layout_and_plan(replace(cfg, num_layers=layers), TOPO_RANKS)
    need = topology_host_need_gib(layout, plan)
    free = host_free_settled_gib(need + HOST_HEADROOM_GIB)
    while need + HOST_HEADROOM_GIB > free and layers > 1:
        layers //= 2
        mesh, layout, plan = layout_and_plan(replace(cfg, num_layers=layers), TOPO_RANKS)
        need = topology_host_need_gib(layout, plan)
    check(need + HOST_HEADROOM_GIB <= free, f"topology path: {need:.1f} GiB of host RAM needed, {free:.1f} free")
    split = sum(plan.split_dim(i, TOPO_RANKS) is not None for i in range(len(plan.dims)))
    log(f"topology: {layers} of {cfg.num_layers} layers, width kept (PATH_LAYERS {PATH_LAYERS}, for the run's "
        f"time; fewer only for the host's RAM), {TOPO_RANKS} ranks, {len(plan.dims)} leaves ({split} split): "
        f"{free:.1f} GiB host RAM free, {need:.1f} GiB needed")
    state = init_train_state(layout, mesh, torch.Generator(device="cuda").manual_seed(SEED))
    originals = tree_map(lambda t: t.clone(), state)
    live = tree_flatten(state)[1]

    topo = ClusterTopology.regular(TOPO_RANKS, hosts_per_rack=TOPO_HOSTS_PER_RACK)
    eng = CheckpointEngine(TOPO_RANKS, EngineConfig(**TOPO_CFG, topology=topo))
    rng = RngEntity()
    rng.seed, rng.counter = SEED, 17
    eng.register("state", ShardedStateEntity(lambda: state, plan))
    eng.register("rng", rng)
    cluster = VirtualCluster(TOPO_RANKS, n_spares=TOPO_SPARES, topology=topo)
    cluster.attach_engine(eng)
    pol = ProtectionPolicy(eng).attach()
    out: dict = dict(topology=repr(topo), layers=layers, host_need_gib=need)

    # placement: no group holds two hosts of one rack; the burst's damage
    groups = eng._groups()
    rack = topo.domains("rack")[TOPO_RACK]
    damage = [sum(r in g.members for r in rack.ranks) for g in groups]
    k = TOPO_CFG["parity_group"]
    contiguous = [sum(r // k == gi for r in rack.ranks) for gi in range(len(groups))]
    out.update(groups=[list(g.members) for g in groups], burst=rack.label, burst_ranks=list(rack.ranks),
               damage=damage, contiguous_damage=contiguous)
    log(f"topology: {topo!r}; groups {out['groups']}; burst {rack.label} = ranks {list(rack.ranks)}: "
        f"per-group damage {damage} (the contiguous layout's: {contiguous})")
    check(placement_conflicts(groups, topo) == [], "topology: two hosts of one rack in one parity group")
    check(max(damage) <= 1 < max(contiguous), f"topology: burst damage {damage}, contiguous {contiguous}")

    ops.reset_launch_counts()  # this path's counts start here
    tr = tracer()
    tr.reset()
    tr.enable()
    rss = rss_sampler()
    torch.cuda.reset_peak_memory_stats()

    def launches(before: dict) -> dict:
        after = ops.launch_counts()
        return {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def spans() -> dict:
        acc: dict[str, float] = {}
        for ev in tr.events():
            acc[ev["name"]] = acc.get(ev["name"], 0.0) + ev["dur"]
        tr.reset()
        return {k: round(v, 6) for k, v in sorted(acc.items())}

    def create(step: int) -> dict:
        before = ops.launch_counts()
        torch.cuda.synchronize()
        with d2h_meter() as d2h:
            check(eng.checkpoint_async({"step": step}), f"topology create {step}: the capture failed")
        check(eng.finalize_async() is True, f"topology create {step}: the handshake failed")
        exch = sum(st.buffer.read_only.own_exch["state"][0].numel() for st in eng.stores.values())
        line = dict(**create_line(eng.stats), pinned_bytes=d2h["pinned_bytes"], pin_s=d2h["pin_s"],
                    d2h_gbps=d2h["bytes"] / max(d2h["s"], 1e-9) / 1e9, parity_bytes=eng.stats.last_bytes_exchanged,
                    exchange_bytes=exch, parity_per_exchange_byte=eng.stats.last_bytes_exchanged / max(exch, 1),
                    codecs=dict(eng.stores[0].buffer.read_only.meta["codecs"]), launches=launches(before),
                    span_s=spans())
        check(line["launches"].get("gf256_matmul_dyn", 0) > 0, f"topology create {step}: B4 was launched no time")
        return line

    def restore(killed: list[int], step: int) -> dict:
        for leaf in live:  # the live state moves on: every byte overwritten
            leaf.fill_(7)
        rng.seed = rng.counter = 0
        before = ops.launch_counts()
        meta = eng.restore()
        torch.cuda.synchronize()
        check(meta["step"] == step and (rng.seed, rng.counter) == (SEED, 17), "topology restore: meta or rng")
        for i, (x, o) in enumerate(zip(live, tree_flatten(originals)[1])):
            check(torch.equal(_int_view(x), _int_view(o)), f"topology: leaf {i} differs after the restore")
        line = dict(killed=killed, **restore_line(eng.stats), domains=eng.journal.events("recovery")[-1]["domains"],
                    reconstructed=eng.stats.reconstructed_restores, escalations=eng.stats.tier_escalations,
                    launches=launches(before), span_s=spans())
        check(line["launches"].get("gf256_matmul_dyn", 0) > 0, f"topology restore {killed}: B4 was launched no time")
        return line

    try:
        out["create1"] = create(1)
        log("topology create 1: " + json.dumps(out["create1"]))
        check(out["create1"]["codecs"] == {"state": "lrc:2:2", "rng": "lrc:2:2"}, "topology: create 1's codec record")
        check(abs(out["create1"]["parity_per_exchange_byte"] - 1.0) < 1e-6, "topology: lrc m=2 l=2 parity is not 1.0x")

        # the whole-rack burst, as the injector schedules it, one arrival instant
        inj = FailureInjector(TOPO_RANKS)
        doomed = inj.schedule_domain_burst(1, topo, TOPO_RACK)
        check(tuple(doomed) == rack.ranks, f"topology: the injector doomed {doomed}")
        for r in inj.kills_at_step(1):
            cluster.kill(r, cause="rack burst")
        evs = eng.journal.events("failure")
        evs[-1]["ts"] = evs[-2]["ts"]
        fit = fit_failure_stats(eng.journal.events())
        out["fit"] = {k: fit[k] for k in ("failures", "bursts", "domain_bursts", "by_domain", "max_domain_burst")}
        check(fit["domain_bursts"] == 1 and fit["by_domain"] == {rack.label: 2}, f"topology: journal fit {out['fit']}")
        # restore before the spare substitution: it still sees the failed ranks
        out["restore1"] = restore(list(rack.ranks), 1)
        log("topology restore 1 (rack burst): " + json.dumps(out["restore1"]))
        check(out["restore1"]["domains"] == rack.label, f"topology: recovery record {out['restore1']['domains']!r}")
        out["stabilize1"] = cluster.stabilize("spare").policy

        out["applied"] = pol.apply()
        decisions = {n: (d.codec, d.m) for n, d in pol.decisions.items()}
        check(out["applied"] >= 1 and decisions.get("state") == ("lrc", 1), f"topology: policy decisions {decisions}")
        out["create2"] = create(2)
        log("topology create 2 (policy override): " + json.dumps(out["create2"]))
        check(out["create2"]["codecs"]["state"] == "lrc:1:2", "topology: the override is not in the codec record")
        check(abs(out["create2"]["parity_per_exchange_byte"] - 0.75) < 1e-6, "topology: lrc m=1 parity is not 0.75x")
        check(pol.evaluations == 3 and pol.changes == out["applied"],
              f"topology: {pol.evaluations} evaluations, {pol.changes} changes")

        cluster.kill(TOPO_SINGLE, cause="host")
        out["restore2"] = restore([TOPO_SINGLE], 2)
        log("topology restore 2 (one host, lrc m=1 from the record): " + json.dumps(out["restore2"]))
        out["stabilize2"] = cluster.stabilize("spare").policy
        check(eng.stats.tier_escalations == 0, "topology: a restore escalated to a tier")
        check(out["stabilize1"] == out["stabilize2"] == "spare", "topology: a stabilize was not a spare substitution")
        out["policy"] = pol.report()
        out["memory"] = {k: v for k, v in eng.memory_report().items() if k not in ("bytes_per_rank", "by_kind")}
        log("topology policy: " + json.dumps(out["policy"], default=str))
        log("topology memory: " + json.dumps(out["memory"], default=str))
        out.update(peak_device_gb=torch.cuda.max_memory_allocated() / 1e9, host_cycle_peak_rss_gib=rss(),
                   host_peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
        log(f"topology peaks: card {out['peak_device_gb']:.2f} GB, host RSS {out['host_cycle_peak_rss_gib']:.1f} "
            f"GiB over the phase ({out['host_peak_rss_gib']:.1f} GiB the process's)")
    finally:
        tr.disable()
        tr.reset()
        eng.close()
        gf256.set_backend(None)  # the engine forced the torch backend process-wide
    counts = ops.launch_counts()
    del eng, cluster, pol, state, originals, live
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


# ---------------------------------------------------------------------------
# phase 6: elastic N-to-M restore at full width
# ---------------------------------------------------------------------------

ELASTIC_WORLDS = (4, 2, 8)  # checkpoint on 4, restore on 2; re-protect on 2, restore on 8
ELASTIC_KILL = 2


def _pow2_words_bytes(nbytes: int) -> int:
    """Bytes of ``np_checksum``'s weight table for a buffer of ``nbytes``."""
    return 4 * (1 << max(-(-nbytes // 4) - 1, 1).bit_length())


def elastic_host_need_gib(layout, plan) -> float:
    """Host RAM the two checkpoints of the drill add at their peaks (4 and 2
    ranks, plain copies): the own and exchange arenas, beside
    ``np_checksum``'s weight table growing to the largest own buffer (old and
    new table at once), less the table already held."""
    from repro_torch.core import integrity
    from repro_torch.utils.pytree import tree_flatten

    sizes = [int(math.prod(sd.shape)) * sd.dtype.itemsize for sd in tree_flatten(layout.sds)[1]]
    split = sum(b for i, b in enumerate(sizes) if plan.split_dim(i, ENGINE_RANKS) is not None)
    repl = sum(sizes) - split
    held = integrity._WEIGHTS.nbytes
    table, need = held, 0
    for n in ELASTIC_WORLDS[:2]:
        arenas = n * repl + 2 * split
        grown = max(table, _pow2_words_bytes(repl + split // n))
        need = max(need, arenas + table + (grown if grown > table else 0))
        table = grown
    return (need - held) / 2**30


def elastic_device_need_gb(layout, plan, n_old: int, n_new: int, failed: int) -> float:
    """Card memory a restore_elastic holds at its peak: the live state, the
    recovered payloads (survivors' full shards, adopted copies' split
    leaves; replicated leaves of an adopted copy are shared) and the new
    split shards, which the row gather writes from the payloads in place."""
    from repro_torch.utils.pytree import tree_flatten

    sizes = [int(math.prod(sd.shape)) * sd.dtype.itemsize for sd in tree_flatten(layout.sds)[1]]
    split = [b for i, b in enumerate(sizes) if plan.split_dim(i, n_old) is not None]
    repl = sum(sizes) - sum(split)
    recovered = (n_old - failed) * (repl + sum(split) // n_old) + failed * sum(split) // n_old
    return (sum(sizes) + recovered + sum(split)) / 1e9


@contextlib.contextmanager
def device_timers(*targets):
    """CUDA events and the host clock around every call of each (module or
    class, function name) while the block runs, and the card memory
    allocated as each call starts; yields {name: [(start, end, allocated
    bytes, host seconds), ...]}."""
    import torch

    saved, events = [], {}
    for mod, name in targets:
        fn = getattr(mod, name)
        events[name] = []

        def timed(*args, _fn=fn, _ev=events[name], **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            allocated = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            start.record()
            out = _fn(*args, **kw)
            end.record()
            _ev.append((start, end, allocated, time.perf_counter() - t0))
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, timed)
    try:
        yield events
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def elastic_transition(eng, cluster, state, layout, mesh, plan, n_new: int) -> dict:
    """One restore_elastic onto ``n_new`` ranks and the cluster's resize,
    then every leaf checked byte for byte against the seeded original (made
    anew on the card: no copy of the state is kept beside it). The host peak
    is the process's peak resident set so far."""
    import resource

    import torch

    from repro_torch.core import checkpoint
    from repro_torch.kernels import ops, reshard as rk
    from repro_torch.launch.steps import init_train_state
    from repro_torch.obs.trace import tracer
    from repro_torch.runtime.state import ShardedStateEntity
    from repro_torch.utils.pytree import tree_flatten

    n_old = eng.n_ranks
    failed = n_old - len(cluster.alive())
    log(f"elastic {n_old} -> {n_new}: card memory expected at the peak about "
        f"{elastic_device_need_gb(layout, plan, n_old, n_new, failed):.1f} GB "
        f"(live state + recovered payloads + new split shards)")
    tr = tracer()
    tr.reset()
    tr.enable()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated0 = torch.cuda.memory_allocated()
    segments0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    before = ops.launch_counts()["gather_rows"]
    t0 = time.perf_counter()
    with device_timers((rk, "copy_runs_into"), (checkpoint, "reshard_leaves_device"),
                       (ShardedStateEntity, "restore_shards")) as ev:
        meta = eng.restore_elastic(n_new)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    cluster.resize(n_new)
    tr.disable()
    launches = ops.launch_counts()["gather_rows"] - before
    peak = torch.cuda.max_memory_allocated()
    spans: dict[str, float] = {}
    for e in tr.events():
        spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"]
    tr.reset()
    gathers = ev["copy_runs_into"]
    gather_ms = sum(e[0].elapsed_time(e[1]) for e in gathers)
    allocated = dict(before_gb=allocated0 / 1e9, first_gather_gb=gathers[0][2] / 1e9,
                     last_gather_gb=gathers[-1][2] / 1e9, after_gb=torch.cuda.memory_allocated() / 1e9,
                     segments_allocated=torch.cuda.memory_stats().get("segment.all.allocated", 0) - segments0)
    # host seconds (and card ms) of the reshard's parts: the executor, its
    # launches, the copies into the live leaves
    parts = {name: dict(host_s=sum(e[3] for e in ev[name]), card_ms=sum(e[0].elapsed_time(e[1]) for e in ev[name]))
             for name in ("reshard_leaves_device", "copy_runs_into", "restore_shards")}
    rep = eng.last_elastic_report
    axised = sum(d is not None for d in plan.dims)
    check(launches == axised * n_new, f"elastic {n_old} -> {n_new}: {launches} gather launches, "
          f"expected {axised} leaves with a data axis x {n_new} new ranks")
    check(meta["step"] == 1 and eng.n_ranks == n_new and sorted(eng.stores) == list(range(n_new)),
          "elastic: meta or new world")
    check(rep.bytes_moved == rep.bytes_lower_bound, "elastic: movement above its lower bound")
    check(failed == 0 or eng.stats.last_restore_chunks > 0, "elastic: the recovery did not run the pipeline")

    original = init_train_state(layout, mesh, torch.Generator(device="cuda").manual_seed(SEED))
    for i, (x, o) in enumerate(zip(tree_flatten(state)[1], tree_flatten(original)[1])):
        check(torch.equal(_int_view(x), _int_view(o)), f"elastic {n_old} -> {n_new}: leaf {i} differs")
    del original
    torch.cuda.empty_cache()
    return dict(n_old=n_old, n_new=n_new, failed=failed, **restore_line(eng.stats, failed > 0), wall_s=wall_s,
                span_s={k: round(v, 6) for k, v in sorted(spans.items())},
                bytes_total=rep.bytes_total, bytes_moved=rep.bytes_moved,
                bytes_lower_bound=rep.bytes_lower_bound, movement_ratio=rep.movement_ratio,
                gather_launches=launches, gather_ms=gather_ms,
                gather_share=gather_ms / 1e3 / eng.stats.last_restore_s, reshard_parts=parts,
                adopted=eng.stats.adopted_restores, zero_comm=eng.stats.zero_comm_restores,
                peak_device_gb=peak / 1e9, allocated=allocated, host_free_gib=host_free_gib(),
                host_peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)


def elastic_path(cfg) -> tuple[dict, list[dict]]:
    """The drill of phase 6 on a seeded train state of PATH_LAYERS layers
    (fewer if the host lacks the RAM), written back in place by every
    restore; returns the kernels' launch counts over this path alone."""
    import gc

    import torch

    from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_train_state
    from repro_torch.runtime.cluster import VirtualCluster
    from repro_torch.runtime.state import RngEntity, ShardedStateEntity
    from repro_torch.utils.pytree import tree_flatten

    layers = min(cfg.num_layers, PATH_LAYERS)
    mesh, layout, plan = layout_and_plan(replace(cfg, num_layers=layers), ELASTIC_WORLDS[0])
    need = elastic_host_need_gib(layout, plan)
    free = host_free_settled_gib(need + HOST_HEADROOM_GIB)
    while need + HOST_HEADROOM_GIB > free and layers > 1:
        layers //= 2
        mesh, layout, plan = layout_and_plan(replace(cfg, num_layers=layers), ELASTIC_WORLDS[0])
        need = elastic_host_need_gib(layout, plan)
    check(need + HOST_HEADROOM_GIB <= free, f"elastic path: {need:.1f} GiB of host RAM needed, {free:.1f} free")
    log(f"elastic: {layers} of {cfg.num_layers} layers, width kept (PATH_LAYERS {PATH_LAYERS}, for the run's "
        f"time; fewer only for the host's RAM): {free:.1f} GiB host RAM free, {need:.1f} GiB needed")
    state = init_train_state(layout, mesh, torch.Generator(device="cuda").manual_seed(SEED))

    eng = CheckpointEngine(ELASTIC_WORLDS[0], EngineConfig())
    cluster = VirtualCluster(ELASTIC_WORLDS[0])
    cluster.attach_engine(eng)
    rng = RngEntity()
    rng.seed, rng.counter = SEED, 17
    eng.register("state", ShardedStateEntity(lambda: state, plan))
    eng.register("rng", rng)
    live = tree_flatten(state)[1]
    runs = []
    ops.reset_launch_counts()  # this path's counts start here
    for n_new in ELASTIC_WORLDS[1:]:
        n = eng.n_ranks
        check(eng.checkpoint({"step": 1}), f"checkpoint on {n} ranks: the handshake failed")
        create = dict(**create_line(eng.stats), host_free_gib=host_free_gib())
        log(f"elastic checkpoint on {n} ranks: " + json.dumps(create))
        for leaf in live:  # the live state moves on: every byte overwritten
            leaf.fill_(7)
        rng.seed = rng.counter = 0
        report = None
        if n == ELASTIC_WORLDS[0]:  # the first transition follows a failure
            cluster.kill(ELASTIC_KILL, cause="drill")
            report = cluster.stabilize("elastic")
            check(report.policy == "elastic" and report.n_ranks_after == n - 1, f"stabilize: {report}")
        run = elastic_transition(eng, cluster, state, layout, mesh, plan, n_new)
        check((rng.seed, rng.counter) == (SEED, 17), "elastic: rng entity")
        run["checkpoint"] = create
        if report is not None:
            run["stabilize"] = dict(policy=report.policy, failed=report.failed,
                                    n_ranks_after=report.n_ranks_after, load_factor=report.load_factor)
        runs.append(run)
        log(f"elastic restore {run['n_old']} -> {n_new}: " + json.dumps(run))
    kinds = [e["kind"] for e in eng.journal.events()]
    check(kinds.count("failure") == 1 and kinds.count("resize") == 2, f"elastic journal: {kinds}")
    eng.close()
    del eng, cluster
    gc.collect()
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    check(counts["gather_rows"] > 0, "kernel gather_rows was launched no time on the elastic path")
    return counts, runs


# ---------------------------------------------------------------------------
# phase 9: the storage-tier ladder and differential checkpointing
# ---------------------------------------------------------------------------

TIER_ROOT = ROOT / "build" / "tiers"  # the tier directories (gitignored)
TIER_RANKS = 8
# Depth of phase 9 (width is never cut): one layer. A dedup flush digests
# every byte of a generation (8 ranks' own arenas, exchange subsets and
# parity: 14.9 GB at one layer, the embedding's 3.7 GB of state held
# replicated and split), and a load verifies them again, so each added layer
# costs a flush and two loads 1.6 GB more
TIER_LAYERS = 1
TIER_CFG = dict(codec="rs", parity_group=4, rs_parity=2, gf_backend="torch", delta=True)
TIER_WITHIN = (0, 2)      # two hosts of group 0: within m = 2
TIER_BEYOND = (0, 1, 2)   # three hosts of group 0: beyond m, the disk tier's case
TIER_COLD_WORLD = 4       # the fresh engine's world for the cold N-to-M restart
# the trainer leg: phase 7's run at TIER_LAYERS, no spare, a disk rung
# flushed at every checkpoint, all 4 hosts killed at step 5 (checkpoints at
# 3 and 6, the full restart escalates to step 3's generation); then a fresh
# Trainer on 2 hosts cold-restarts from step 6's (4 -> 2) and takes 2 steps
TIER_TRAIN_KILLS = {5: [0, 1, 2, 3]}
TIER_COLD_HOSTS = 2
# the resumed job flushes every 3rd commit: the checkpoint re-protecting its
# new world is not flushed (the leg would only wait for it at close)
TIER_RESUME_FLUSH_EVERY = 3
# phase 9 runs in a process of its own beside the parent's phases: half the
# host's 8 cores for its host copies
TIER_THREADS = 4


def dir_probe(path) -> dict:
    """The filesystem ``path`` lies on (its /proc/mounts entry) and its free
    bytes."""
    import os
    import shutil

    real, mount, fstype = os.path.realpath(path), "", "?"
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fs = line.split()[:3]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) and len(mnt) >= len(mount):
                mount, fstype = mnt, fs
    return dict(path=str(path), mount=mount, fstype=fstype, free_gb=shutil.disk_usage(path).free / 1e9)


def drop_cached(root) -> bool:
    """``posix_fadvise(POSIX_FADV_DONTNEED)`` on every file under ``root``,
    so a load reads the disk and not the page cache; True if every call
    succeeded."""
    import os

    ok = True
    for dirpath, _, files in os.walk(root):
        for name in files:
            try:
                fd = os.open(os.path.join(dirpath, name), os.O_RDONLY)
                try:
                    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                finally:
                    os.close(fd)
            except OSError:
                ok = False
    return ok


def tier_need(layout, plan, n_ranks: int, parity: float, tmpfs: bool) -> tuple[float, float]:
    """(host RAM GiB, disk GB) the engine leg needs at its peak: two banks of
    a generation (all ranks' own arenas, the exchange subsets, the parity at
    ``parity`` x the exchange bytes) and the encode scratch, beside a loaded
    generation and ``np_checksum``'s weight table; the disk holds two
    generations (dedup shares what they have in common), and on ``tmpfs``
    that too is host RAM."""
    from repro_torch.utils.pytree import tree_flatten

    sizes = [int(math.prod(sd.shape)) * sd.dtype.itemsize for sd in tree_flatten(layout.sds)[1]]
    split = sum(b for i, b in enumerate(sizes) if plan.split_dim(i, n_ranks) is not None)
    repl = sum(sizes) - split
    generation = n_ranks * repl + 2 * split + parity * split
    disk = 2 * generation
    host = 3 * generation + parity * split + _pow2_words_bytes(repl + split // n_ranks) + (disk if tmpfs else 0)
    return host / 2**30, disk / 1e9


def rewrite_layer(state, gen: int) -> None:
    """A seeded share of the live state changes: every leaf of layer 0 (the
    first slice of each stacked ``layers`` leaf) drawn anew from seed
    SEED + ``gen``, and the step."""
    import torch

    from repro_torch.utils.pytree import tree_flatten

    g = torch.Generator(device="cuda").manual_seed(SEED + gen)
    for path, leaf in zip(*tree_flatten(state)):
        if "layers" in path:
            x = leaf[0]
            x.copy_(torch.randn(x.shape, generator=g, device=x.device, dtype=torch.float32).to(x.dtype))
    state["step"] += 1


def _same_state(state, expect) -> int:
    """Leaves of ``state`` byte-equal to ``expect``'s (both on the card)."""
    import torch

    from repro_torch.utils.pytree import tree_flatten

    return sum(torch.equal(_int_view(x), _int_view(o)) for x, o in zip(tree_flatten(state)[1], tree_flatten(expect)[1]))


def _spans(tr) -> dict:
    out: dict[str, float] = {}
    for e in tr.events():
        out[e["name"]] = out.get(e["name"], 0.0) + e["dur"]
    return {k: round(v, 6) for k, v in sorted(out.items())}


def tier_engine_leg(cfg) -> dict:
    """The engine leg of phase 9: three creates with ``delta`` and a dedup
    disk rung (a full encode, then two parity patches after rewriting layer
    0), each flushed; a restore within the codec's tolerance that never
    touches the disk; one beyond it that escalates to the newest generation
    (its pages dropped from the page cache first); and a fresh engine on
    TIER_COLD_WORLD ranks restoring the 8-rank generation through the row
    gather (the cold N-to-M restart). Every leaf is checked byte for byte
    after each restore."""
    import gc
    import resource
    import shutil

    import torch

    from repro_torch.core import storage
    from repro_torch.core.checkpoint import CheckpointEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import init_train_state
    from repro_torch.obs.trace import tracer
    from repro_torch.runtime.state import RngEntity, ShardedStateEntity
    from repro_torch.utils.pytree import tree_flatten, tree_map

    tier_dir = TIER_ROOT / "engine"
    shutil.rmtree(tier_dir, ignore_errors=True)
    tier_dir.mkdir(parents=True)
    fs = dir_probe(tier_dir)
    layers = min(cfg.num_layers, TIER_LAYERS)
    mesh, layout, plan = layout_and_plan(replace(cfg, num_layers=layers), TIER_RANKS)
    need, disk_gb = tier_need(layout, plan, TIER_RANKS, 0.5, fs["fstype"] == "tmpfs")
    free = host_free_settled_gib(need + HOST_HEADROOM_GIB)
    log(f"tier engine: {layers} of {cfg.num_layers} layers, width kept (TIER_LAYERS {TIER_LAYERS}, for the "
        f"run's time), {TIER_RANKS} ranks; tier directory on {fs['fstype']} ({fs['mount']}), "
        f"{fs['free_gb']:.1f} GB free, about {disk_gb:.1f} GB needed; host RAM {free:.1f} GiB free, "
        f"about {need:.1f} GiB needed" + (" (the tier's bytes counted: tmpfs)" if fs["fstype"] == "tmpfs" else ""))
    check(need + HOST_HEADROOM_GIB <= free, f"tier engine: {need:.1f} GiB of host RAM needed, {free:.1f} free")
    check(disk_gb + 1.0 <= fs["free_gb"], f"tier engine: {disk_gb:.1f} GB of disk needed, {fs['free_gb']:.1f} free")
    state = init_train_state(layout, mesh, torch.Generator(device="cuda").manual_seed(SEED))
    live = tree_flatten(state)[1]
    rng = RngEntity()
    cfg_e = EngineConfig(**TIER_CFG, tiers=(storage.disk(str(tier_dir), every=1, dedup=True),))
    eng = CheckpointEngine(TIER_RANKS, cfg_e)
    eng.register("state", ShardedStateEntity(lambda: state, plan))
    eng.register("rng", rng)
    tier = eng.persistent_tiers[0]
    tr = tracer()
    rss = rss_sampler()
    torch.cuda.reset_peak_memory_stats()
    out: dict = dict(layers=layers, fs=fs, creates=[])
    n_units = len(eng._pipeline_units({"state": None}))

    def overwrite() -> None:
        for leaf in live:  # the live state moves on: every byte overwritten
            leaf.fill_(7)
        rng.seed = rng.counter = 0

    def restored(what: str) -> None:
        torch.cuda.synchronize()
        check(_same_state(state, expect) == len(live), f"tier engine {what}: a leaf differs")
        check((rng.seed, rng.counter) == (SEED, 17), f"tier engine {what}: rng entity")

    flushes: list[dict] = []
    real_flush = tier.flush

    def recorded_flush(snap):  # each flush's time and dedup counts, on the flush worker
        t0 = time.perf_counter()
        written = real_flush(snap)
        dt = time.perf_counter() - t0
        d = tier.last_dedup
        flushes.append(dict(gen=snap.created, s=dt, bytes_written=written, logical_bytes=d["logical_bytes"],
                            gbps=d["logical_bytes"] / dt / 1e9, written_gbps=written / dt / 1e9,
                            chunks_written=d["chunks_written"], chunks_reused=d["chunks_reused"],
                            dedup_ratio=d["stored_bytes"] / d["logical_bytes"]))
        log(f"tier engine flush of create {snap.created}: " + json.dumps(flushes[-1]))
        return written

    tier.flush = recorded_flush
    for gen in (1, 2, 3):
        if gen > 1:
            rewrite_layer(state, gen)
        rng.seed, rng.counter = SEED, 17
        s0 = eng.stats.as_dict()
        b4 = ops.launch_counts()["gf256_matmul_dyn"]
        tr.reset()
        tr.enable()
        torch.cuda.synchronize()
        with d2h_meter() as d2h:
            check(eng.checkpoint_async({"step": gen}), f"tier engine: create {gen} failed to capture")
        check(eng.finalize_async() is True, f"tier engine: create {gen}: the handshake failed")
        b4 = ops.launch_counts()["gf256_matmul_dyn"] - b4
        tr.disable()
        # the flush runs behind what follows (the next capture stages into the
        # other bank); the first one finishes first, so the second finds its
        # chunks in the store
        eng.kick_tier_flush()
        join_s = 0.0
        if gen == 1:
            t0 = time.perf_counter()
            eng._join_flush()
            join_s = time.perf_counter() - t0
        s = eng.stats
        spans = {k: v for k, v in _spans(tr).items() if not k.startswith(("flush", "tier_"))}
        run = dict(gen=gen, **create_line(s), pin_s=d2h["pin_s"], pinned_bytes=d2h["pinned_bytes"],
                   d2h_gbps=d2h["bytes"] / max(d2h["s"], 1e-9) / 1e9, span_s=spans,
                   flush_wait_s=s.last_flush_wait_s, flush_join_s=join_s,
                   delta_encodes=s.delta_encodes - s0["delta_encodes"],
                   full_encodes=s.full_encodes - s0["full_encodes"], dirty_fraction=s.last_dirty_fraction,
                   transfer_bytes_skipped=s.last_transfer_bytes_skipped, patched_ranges=s.last_delta_ranges,
                   b4_launches=b4)
        log(f"tier engine create {gen}: " + json.dumps(run))
        out["creates"].append(run)
        if gen == 1:
            check((run["full_encodes"], run["delta_encodes"]) == (n_units, 0), f"tier engine create 1: {run}")
            check([f["gen"] for f in flushes] == [1] and tier.generations() == [1], "tier engine: flush 1 missing")
        else:
            check((run["full_encodes"], run["delta_encodes"]) == (0, n_units),
                  f"tier engine create {gen}: every unit must be patched: {run}")
            check(0.0 < run["dirty_fraction"] < cfg_e.delta_crossover, f"tier engine: dirty fraction {run}")
            check(b4 >= run["patched_ranges"] > 0, f"tier engine create {gen}: B4 did not run the patch: {run}")
        if gen == 3:
            # the staging bank's arenas hold generation 1's stripes: the
            # clean chunks stay in place
            check(run["transfer_bytes_skipped"] > 0, f"tier engine create 3: no transfer skipped: {run}")
    expect = tree_map(lambda t: t.clone(), state)

    # within the tolerance: the codec rebuilds from the patched parity
    for r in TIER_WITHIN:
        eng.stores[r].wipe()
    overwrite()
    t0 = time.perf_counter()
    meta = eng.restore()
    restored("within tolerance")
    out["within"] = dict(killed=list(TIER_WITHIN), wall_s=time.perf_counter() - t0, **restore_line(eng.stats),
                         reconstructed=eng.stats.reconstructed_restores, escalations=eng.stats.tier_escalations)
    check(meta["step"] == 3 and eng.stats.tier_escalations == 0, f"tier engine within: {out['within']}")
    check(eng.stats.reconstructed_restores > 0, "tier engine within: nothing rebuilt")
    log("tier engine restore within tolerance: " + json.dumps(out["within"]))

    # beyond it: escalation to the newest generation on disk
    for r in TIER_BEYOND:
        eng.stores[r].wipe()
    overwrite()
    dropped = drop_cached(tier_dir)
    tr.reset()
    tr.enable()
    t0 = time.perf_counter()
    meta = eng.restore()
    wall = time.perf_counter() - t0
    tr.disable()
    restored("beyond tolerance")
    load = tier.last_load
    out["beyond"] = dict(killed=list(TIER_BEYOND), wall_s=wall, **restore_line(eng.stats),
                         escalations=eng.stats.tier_escalations, load=load,
                         load_gbps=load["bytes"] / max(load["s"], 1e-9) / 1e9,
                         cold=dropped and fs["fstype"] != "tmpfs", fadvise_ok=dropped, span_s=_spans(tr))
    check(meta["step"] == 3 and eng.stats.tier_escalations == 1, f"tier engine beyond: {out['beyond']}")
    log("tier engine restore beyond tolerance (escalated): " + json.dumps(out["beyond"]))
    # the escalation joined every flush: generation 3 was the one it loaded
    out["flushes"] = flushes
    check([f["gen"] for f in flushes] == [1, 2, 3] and eng.stats.tier_flushes == 3 and load["gen"] == 3,
          f"tier engine: flushes {flushes}")
    check(all(f["chunks_reused"] > 0 for f in flushes[1:]), f"tier engine: a later flush reused no chunk: {flushes}")
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # a fresh engine on TIER_COLD_WORLD ranks: the cold N-to-M restart
    eng = CheckpointEngine(TIER_COLD_WORLD, cfg_e)
    eng.register("state", ShardedStateEntity(lambda: state, plan))
    eng.register("rng", rng)
    overwrite()
    dropped = drop_cached(tier_dir)
    gathers = ops.launch_counts()["gather_rows"]
    tr.reset()
    tr.enable()
    t0 = time.perf_counter()
    meta = eng.restore_elastic(TIER_COLD_WORLD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tr.disable()
    gathers = ops.launch_counts()["gather_rows"] - gathers
    restored(f"cold {TIER_RANKS} -> {TIER_COLD_WORLD}")
    axised = sum(d is not None for d in plan.dims)
    load = eng.persistent_tiers[0].last_load
    out["cold"] = dict(n_old=TIER_RANKS, n_new=TIER_COLD_WORLD, wall_s=wall, restore_s=eng.stats.last_restore_s,
                       escalations=eng.stats.tier_escalations, load=load,
                       load_gbps=load["bytes"] / max(load["s"], 1e-9) / 1e9,
                       cold=dropped and fs["fstype"] != "tmpfs", gather_launches=gathers,
                       bytes_moved=eng.last_elastic_report.bytes_moved, span_s=_spans(tr))
    check(meta["step"] == 3 and eng.stats.tier_escalations == 1 and eng.n_ranks == TIER_COLD_WORLD,
          f"tier engine cold: {out['cold']}")
    check(gathers == axised * TIER_COLD_WORLD,
          f"tier engine cold: {gathers} gather launches, expected {axised} x {TIER_COLD_WORLD}")
    log(f"tier engine cold {TIER_RANKS} -> {TIER_COLD_WORLD} restart: " + json.dumps(out["cold"]))
    eng.close()
    del eng, state, expect, live
    out.update(peak_device_gb=torch.cuda.max_memory_allocated() / 1e9, host_leg_peak_rss_gib=rss(),
               host_peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
               disk_free_after_gb=dir_probe(tier_dir)["free_gb"])
    shutil.rmtree(tier_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tier_trainer_leg(cfg) -> dict:
    """The trainer leg of phase 9: phase 7's run at TIER_LAYERS with a disk
    rung, through a whole-system loss at step 5 (the full restart escalates
    to step 3's generation; the replayed steps 3 and 4 must be bit-equal to
    the first pass), then a fresh Trainer on TIER_COLD_HOSTS hosts
    cold-restarting from step 6's generation (4 -> 2) for two steps, whose
    losses must be bit-equal to the first run's steps 6 and 7."""
    import gc
    import resource
    import shutil

    import torch

    from repro_torch.models import build_model
    from repro_torch.runtime.failures import FailureInjector
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    tier_dir = TIER_ROOT / "trainer"
    shutil.rmtree(tier_dir, ignore_errors=True)
    tier_dir.mkdir(parents=True)
    fs = dir_probe(tier_dir)
    layers = min(cfg.num_layers, TIER_LAYERS)
    full_layers, cfg = cfg.num_layers, replace(cfg, num_layers=layers)
    mesh, layout, plan = layout_and_plan(cfg, ENGINE_RANKS)
    need, disk_gb = tier_need(layout, plan, ENGINE_RANKS, 0.0, fs["fstype"] == "tmpfs")
    free = host_free_settled_gib(need + HOST_HEADROOM_GIB)
    log(f"tier trainer: {layers} of {full_layers} layers (width kept), tier directory on {fs['fstype']}, "
        f"{fs['free_gb']:.1f} GB free, about {disk_gb:.1f} GB needed; host RAM {free:.1f} GiB free, about "
        f"{need:.1f} GiB needed")
    check(need + HOST_HEADROOM_GIB <= free, f"tier trainer: {need:.1f} GiB of host RAM needed, {free:.1f} free")
    check(disk_gb + 1.0 <= fs["free_gb"], f"tier trainer: {disk_gb:.1f} GB of disk needed, {fs['free_gb']:.1f} free")
    kw = dict(TRAIN, n_spares=0, total_steps=TRAIN_STEPS, tier_dir=str(tier_dir), disk_flush_every=1)
    torch.use_deterministic_algorithms(True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.cuda.reset_peak_memory_stats()
    try:
        t = Trainer(build_model(cfg), TrainerConfig(**kw), injector=FailureInjector(ENGINE_RANKS,
                                                                                    schedule=TIER_TRAIN_KILLS))
        t0 = time.perf_counter()
        hist = t.run(TRAIN_STEPS)
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        t.engine.close()  # joins step 6's flush
        close_s = time.perf_counter() - t0
        s = t.engine.stats
        losses = [h["loss"] for h in hist]
        first = dict(steps=[h["step"] for h in hist], loss=losses, run_s=run_s, close_s=close_s,
                     flushes=s.tier_flushes, last_flush_s=s.last_flush_s, last_flush_bytes=s.last_flush_bytes,
                     escalations=s.tier_escalations, restore_s=s.last_restore_s,
                     load=t.engine.persistent_tiers[0].last_load)
        check(all(math.isfinite(x) for x in losses), f"tier trainer: a loss is not finite: {losses}")
        check(first["steps"] == TRAIN_HISTORY, f"tier trainer: steps {first['steps']}")
        check(t.n_recoveries == 1 and s.tier_escalations == 1, f"tier trainer: {t.n_recoveries} recoveries, "
              f"{s.tier_escalations} escalations")
        check(losses[3:5] == losses[5:7], f"tier trainer: replayed losses {losses[5:7]} differ from {losses[3:5]}")
        check(s.tier_flushes == 2, f"tier trainer: {s.tier_flushes} flushes, want 2 (steps 3 and 6)")
        log("tier trainer, whole-system loss: " + json.dumps(first))
        del t
        gc.collect()
        torch.cuda.empty_cache()

        b = Trainer(build_model(cfg), TrainerConfig(**{**kw, "n_virtual_hosts": TIER_COLD_HOSTS,
                                                       "disk_flush_every": TIER_RESUME_FLUSH_EVERY}))
        t0 = time.perf_counter()
        meta = b.cold_restart()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        step = int(meta["step"])
        hist2 = b.run(step + 2)
        s = b.engine.stats
        cold = dict(step=step, n_ranks=b.engine.n_ranks, cold_restart_s=cold_s, restore_s=s.last_restore_s,
                    escalations=s.tier_escalations, load=b.engine.persistent_tiers[0].last_load,
                    steps=[h["step"] for h in hist2], loss=[h["loss"] for h in hist2])
        check(step == 2 * TRAIN_PERIOD and b.engine.n_ranks == TIER_COLD_HOSTS and s.tier_escalations == 1,
              f"tier trainer cold restart: {cold}")
        check(cold["steps"] == [step, step + 1] and cold["loss"] == losses[-2:],
              f"tier trainer cold restart: losses {cold['loss']} differ from the first run's {losses[-2:]}")
        b.engine.close()
        log(f"tier trainer cold {ENGINE_RANKS} -> {TIER_COLD_HOSTS} restart: " + json.dumps(cold))
        del b
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    out = dict(layers=layers, fs=fs, first=first, cold=cold, peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
               host_peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
    shutil.rmtree(tier_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tier_path(cfg) -> tuple[dict, dict]:
    """Phase 9: the engine leg, then the trainer leg; both must launch their
    kernels: B4 in the engine leg (the patches, the encodes and the decode
    after the escalation), B6 in both cold restarts. Returns the kernels'
    launch counts over this path alone and the legs' numbers."""
    from repro_torch.core import gf256
    from repro_torch.kernels import ops

    ops.reset_launch_counts()  # this path's counts start here
    before = ops.launch_counts()
    try:
        engine = tier_engine_leg(cfg)
    finally:
        gf256.set_backend(None)  # the leg forced the torch backend process-wide
    mid = ops.launch_counts()
    trainer = tier_trainer_leg(cfg)
    counts = ops.launch_counts()
    engine["launches"] = {k: mid[k] - before[k] for k in mid if mid[k] != before[k]}
    trainer["launches"] = {k: counts[k] - mid[k] for k in counts if counts[k] != mid[k]}
    for name, leg in (("engine", engine), ("trainer", trainer)):
        log(f"tier {name} leg: " + json.dumps({k: v for k, v in leg.items()
                                               if k not in ("creates", "flushes", "within", "beyond", "cold", "first")}))
    check(engine["launches"].get("gf256_matmul_dyn", 0) > 0, "tier engine: B4 was launched no time")
    check(engine["launches"].get("gather_rows", 0) > 0, "tier engine: B6 was launched no time")
    check(trainer["launches"].get("gather_rows", 0) > 0, "tier trainer: B6 was launched no time")
    return counts, dict(engine=engine, trainer=trainer)


def tier_body(rank: int, world: int, init_method: str, cfg) -> dict:
    """Phase 9 in a process of its own (``start_tier``): the GF(2^8) probe
    first, as the parent's phase 3 runs it (so that the path's counts hold
    none of its launches), then ``tier_path``. Returns the path's launch
    counts, its numbers, and when the process entered, began the path and
    ended (``time.time()``)."""
    import torch

    from repro_torch.core import gf256

    entered = time.time()
    torch.set_num_threads(TIER_THREADS)
    _HOST_START[:] = [host_free_gib(), host_rss_gib()]
    gf256.active_backend_name()
    began = time.time()
    counts, runs = tier_path(cfg)
    return dict(counts=counts, runs=runs, entered=entered, began=began, done=time.time())


def start_tier(cfg):
    """Start phase 9 (``tier_body``) in a process of its own, so that it
    runs beside the phases that follow it in the script: its legs are bound
    by the tier directory's filesystem (85 GB written and read at 0.4-1.0
    GB/s), and leave the card and most of the host's cores idle. The
    kernels are built by then: the process loads the libraries."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import RankGroup

    check(all(_build.lib_path(n).exists() for n in _build.KERNELS), "phase 9: the kernels are not built")
    group = RankGroup(tier_body, 1, args=(cfg,))
    group.started = time.time()
    return group


def tier_wait(group, phase_ends: dict) -> tuple[dict, dict]:
    """Wait for phase 9's process (``start_tier``) and return its launch
    counts and numbers; logs its seconds, from its start to its end, the
    phases of ``phase_ends`` it ran beside, and the wait here."""
    t0 = time.perf_counter()
    try:
        (res,) = group.join(timeout=1200)
    finally:
        group.stop()
    wait_s = time.perf_counter() - t0
    beside = phases_beside(phase_ends, group.started, res["done"])
    runs = res["runs"]
    runs.update(wall_s=res["done"] - group.started, startup_s=res["began"] - group.started, wait_s=wait_s,
                beside=beside)
    log(f"phase 9: {runs['wall_s']:.1f} s in its own process (start-up and the GF(2^8) probe "
        f"{runs['startup_s']:.1f} s), beside {', '.join(beside) or 'no phase'}; {wait_s:.1f} s of wait after them")
    return res["counts"], runs


# ---------------------------------------------------------------------------
# phase 7: the fault-tolerant training loop (Algorithm 3) at full width
# ---------------------------------------------------------------------------

# launch/train.py's defaults (batch, seq, lr); a checkpoint every 3 steps,
# host 2 killed at step 5: checkpoints at 3 and 6, a rollback to 3, steps 3
# and 4 replayed
TRAIN_PERIOD = 3
TRAIN = dict(batch=8, seq=128, lr=1e-3, warmup_steps=2, n_virtual_hosts=ENGINE_RANKS, n_spares=1,
             recovery_policy="spare", checkpoint_period=TRAIN_PERIOD)
TRAIN_STEPS, TRAIN_KILLS = 8, {5: [2]}
TRAIN_HISTORY = [0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
# depth of the sync run and of the async run (width kept), for the run's
# time: one each of the 16 layers leave it for phases 8b, 9, 10 and 13 (the
# async run drives the sync run's path with the drain behind the next step)
TRAIN_LAYERS = 1
TRAIN_ASYNC_LAYERS = 1


def trainer_host_need_gib(layout, plan, n_ranks: int = ENGINE_RANKS, redundancy: float = 1.0) -> float:
    """Host RAM the trainer's engine adds at its peak, the capture of its
    second checkpoint: the committed generation (every rank's own arena and
    the exchange arenas, ``redundancy`` times the split bytes: 1 for the
    copy codec, m/k for a striped one) beside the one being captured, and
    the growth of ``np_checksum``'s weight table to the largest own buffer.
    The capture copies each leaf from the card straight into its pinned
    arena."""
    from repro_torch.core import integrity
    from repro_torch.utils.pytree import tree_flatten

    sizes = [int(math.prod(sd.shape)) * sd.dtype.itemsize for sd in tree_flatten(layout.sds)[1]]
    split = sum(b for i, b in enumerate(sizes) if plan.split_dim(i, n_ranks) is not None)
    repl = sum(sizes) - split
    held = integrity._WEIGHTS.nbytes
    generation = n_ranks * repl + (1 + redundancy) * split
    need = 2 * generation + max(_pow2_words_bytes(repl + split // n_ranks) - held, 0)
    return need / 2**30


def _leaf_sums(leaves) -> list[tuple[int, int]]:
    from repro_torch.core.integrity import np_checksum

    return [np_checksum(_int_view(x.detach().reshape(-1)).cpu().numpy()) for x in leaves]


def step_split_ms(trainer, reps: int = 3) -> dict:
    """Where a step's time goes: ``reps`` more steps of the trainer's
    arithmetic, timed with CUDA events at the split between the loss and its
    gradient (forward, recomputed forward, backward) and the AdamW update;
    means in ms."""
    import torch

    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.utils.pytree import tree_flatten, tree_unflatten

    tc, st = trainer.tcfg, trainer.state
    hp, sched = AdamWConfig(lr=tc.lr), warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    grad_ms = update_ms = 0.0
    for _ in range(reps):
        batch = trainer.data.next()
        paths, live = tree_flatten(st["params"])
        leaves = [p.detach().requires_grad_() for p in live]
        torch.cuda.synchronize()
        ev[0].record()
        loss, _ = trainer.model.loss(tree_unflatten(paths, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        ev[1].record()
        adamw_update(tree_unflatten(paths, list(grads)), st["params"], st["opt"], st["step"], hp, sched)
        ev[2].record()
        torch.cuda.synchronize()
        grad_ms += ev[0].elapsed_time(ev[1]) / reps
        update_ms += ev[1].elapsed_time(ev[2]) / reps
    return dict(loss_grad_ms=grad_ms, update_ms=update_ms)


def trainer_path(cfg, mode: str, engine=None, train: dict | None = None, label: str = "trainer",
                 probe=None) -> tuple[dict, dict]:
    """The port's Trainer on the card with ``checkpoint_mode=mode`` and
    ``engine`` (None: the Trainer's default, the reference's default
    engine): ``train`` (TRAIN by default) over TRAIN_STEPS steps through
    TRAIN_KILLS under deterministic algorithms. Checks every
    loss finite, one recovery, the replayed steps' losses bit-equal to their
    first pass, and every state leaf right after the restore byte-equal to
    the state at the step-3 checkpoint (a host copy where the host has room
    for it, else the leaves' ``np_checksum``s). ``probe(trainer)``, if
    given, runs after the counts are read and before the trainer is torn
    down; its dict lands in the run's numbers under "probe". Returns the
    run's numbers (each create's and the restore's times as the engine
    recorded them) and the kernels' launch counts over it (the copy codec
    launches none)."""
    import gc
    import resource

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import train_state_layout
    from repro_torch.models import build_model
    from repro_torch.runtime.failures import FailureInjector
    from repro_torch.runtime.state import ShardPlan
    from repro_torch.core.checkpoint import EngineConfig
    from repro_torch.runtime.trainer import PROD_MESH, Trainer, TrainerConfig
    from repro_torch.sharding.mesh import make_mesh
    from repro_torch.utils.pytree import tree_flatten

    train = TRAIN if train is None else train
    hosts = train["n_virtual_hosts"]
    redundancy = 1.0 if engine is None or not engine.parity_group else engine.rs_parity / engine.parity_group

    def reckon(c):
        layout = train_state_layout(c, make_mesh(*PROD_MESH))
        plan = ShardPlan.from_pspecs(layout.sds, layout.pspecs)
        return layout, trainer_host_need_gib(layout, plan, hosts, redundancy)

    layers = cfg.num_layers
    layout, need = reckon(cfg)
    full_gib = sum(int(math.prod(sd.shape)) * sd.dtype.itemsize for sd in tree_flatten(layout.sds)[1]) / 2**30
    free = host_free_settled_gib(need + full_gib + HOST_HEADROOM_GIB)  # room for the host copy too
    while need + HOST_HEADROOM_GIB > free and layers > 1:
        layers -= 1
        layout, need = reckon(replace(cfg, num_layers=layers))
    check(need + HOST_HEADROOM_GIB <= free, f"{label} path: {need:.1f} GiB of host RAM needed, {free:.1f} free")
    if layers != cfg.num_layers:
        log(f"{label} ({mode}): depth cut to {layers} of {cfg.num_layers} layers (width kept): "
            f"{free:.1f} GiB host RAM free, {need:.1f} GiB needed at {layers} layers")
        cfg = replace(cfg, num_layers=layers)
    state_gib = sum(int(math.prod(sd.shape)) * sd.dtype.itemsize for sd in tree_flatten(layout.sds)[1]) / 2**30
    keep_copy = need + state_gib + HOST_HEADROOM_GIB <= free
    log(f"{label} ({mode}): {layers} layers, state {state_gib * 2**30 / 1e9:.3f} GB, host RAM {free:.1f} GiB "
        f"free, about {need:.1f} GiB needed; the step-3 state kept as "
        + ("a host copy" if keep_copy else "per-leaf np_checksums (no room for a host copy)"))

    class CheckedTrainer(Trainer):
        """The Trainer, recording each committed create's stats and holding
        its state right after the restore against ``at_ckpt``, the state at
        the step-3 checkpoint."""

        at_ckpt: list
        restored: dict | None = None
        creates: list

        def recover(self) -> None:
            super().recover()
            torch.cuda.synchronize()
            leaves = tree_flatten(self.state)[1]
            if keep_copy:
                same = [torch.equal(_int_view(x.reshape(-1)).cpu(), _int_view(c.reshape(-1)))
                        for x, c in zip(leaves, self.at_ckpt)]
            else:
                same = [a == b for a, b in zip(_leaf_sums(leaves), self.at_ckpt)]
            self.restored = dict(step=int(self.state["step"]), **restore_line(self.engine.stats),
                                 leaves=len(same), leaves_equal=sum(same),
                                 compared="bytes" if keep_copy else "np_checksum")

    tcfg = TrainerConfig(total_steps=TRAIN_STEPS, checkpoint_mode=mode, **train,
                         **({} if engine is None else {"engine": engine}))
    torch.use_deterministic_algorithms(True)
    # every tensor the path allocates is written before it is read; filling
    # fresh allocations would only slow the path
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = CheckedTrainer(build_model(cfg), tcfg, injector=FailureInjector(hosts, schedule=TRAIN_KILLS))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    want_engine = EngineConfig() if engine is None else engine
    check(tcfg.engine == want_engine and trainer.engine.cfg == want_engine, f"{label}: the trainer's engine")
    trainer.creates = []
    finalize = trainer.engine.finalize_async

    def finalize_and_record():
        ok = finalize()
        if ok:
            trainer.creates.append(dict(step=int(trainer.engine.checkpoint_step()["step"]),
                                        **create_line(trainer.engine.stats)))
        return ok

    trainer.engine.finalize_async = finalize_and_record
    n_params = sum(x.numel() for x in tree_flatten(trainer.state["params"])[1])
    ops.reset_launch_counts()  # this path's counts start here
    with d2h_meter() as d2h:
        trainer.run(TRAIN_PERIOD)
        t0 = time.perf_counter()
        leaves = tree_flatten(trainer.state)[1]
        trainer.at_ckpt = [x.detach().to("cpu", copy=True) for x in leaves] if keep_copy else _leaf_sums(leaves)
        keep_s = time.perf_counter() - t0
        hist = trainer.run(TRAIN_STEPS)
    counts = ops.launch_counts()
    split = step_split_ms(trainer)
    torch.use_deterministic_algorithms(False)
    torch.utils.deterministic.fill_uninitialized_memory = fill
    s = trainer.engine.stats
    for h in hist:
        log(f"train step {h['step']} ({mode if label == 'trainer' else label + ', ' + mode}): loss {h['loss']!r} in {h['step_s']:.4f} s")
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"{label}: a loss is not finite: {losses}")
    check([h["step"] for h in hist] == TRAIN_HISTORY, f"{label}: steps {[h['step'] for h in hist]}")
    check(trainer.n_recoveries == 1, f"{label}: {trainer.n_recoveries} recoveries, want 1")
    check(losses[3:5] == losses[5:7], f"{label}: replayed losses {losses[5:7]} differ from {losses[3:5]}")
    r = trainer.restored
    check(r is not None and r["step"] == TRAIN_PERIOD and r["leaves_equal"] == r["leaves"],
          f"{label}: the restored state differs from the step-{TRAIN_PERIOD} checkpoint's: {r}")
    check([c["step"] for c in trainer.creates] == [TRAIN_PERIOD, 2 * TRAIN_PERIOD],
          f"{label}: committed creates {trainer.creates}")
    run = dict(mode=mode, layers=layers, n_params=n_params, state_gb=state_gib * 2**30 / 1e9, setup_s=setup_s,
               step_s=[h["step_s"] for h in hist], loss=losses, checkpoints=trainer.creates,
               created=s.created, aborted=s.aborted, restore=r, keep_state_s=keep_s, step_split_ms=split,
               d2h_gbps=d2h["bytes"] / max(d2h["s"], 1e-9) / 1e9, d2h_bytes=d2h["bytes"], d2h_s=d2h["s"],
               pinned_bytes=d2h["pinned_bytes"], pin_s=d2h["pin_s"],
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
               host_peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
               host_free_before_gib=free)
    if probe is not None:
        run["probe"] = probe(trainer)
    trainer.engine.close()
    del trainer.engine.finalize_async  # the recording wrapper holds the trainer
    del trainer, leaves, finalize, finalize_and_record
    gc.collect()
    torch.cuda.empty_cache()
    return run, counts


# ---------------------------------------------------------------------------
# phase 7c: the sharded train step, Trainer(mesh=) over a process mesh
# ---------------------------------------------------------------------------

# 4 processes share the card on the (2, 2) ("data", "model") mesh over gloo:
# its all-gather of a card's tensors ends the processes, so the mesh's
# DTensor groups are on the staged backend (core/transport.py). Phase 7's
# TRAIN and TRAIN_STEPS through TRAIN_KILLS at TRAIN_LAYERS, under rank 0's
# engine, rs 4+2 over 8 virtual hosts (its restore rebuilds host 2 with B4).
MESH7C = ((2, 2), ("data", "model"))
MESH7C_BACKEND = "gloo"
MESH7C_HOSTS = 8
MESH7C_TRAIN = {**TRAIN, "n_virtual_hosts": MESH7C_HOSTS}
MESH7C_ENGINE = dict(codec="rs", parity_group=4, rs_parity=2, gf_backend="torch")
MESH7C_KERNELS = ("gf256_matmul_dyn",)
# then, on the same processes (a second feed, after phase 5): (a) phase 11's
# Mamba-2 trainer traffic (batch 4 x 512) on the mesh under the default
# engine over 4 hosts with no spare, so the kill at step 5 is an elastic
# 4 -> 3 recovery (B6 in rank 0's restore_elastic, then the re-protect
# create); (b) MESH7C_MOE_STEPS train steps of phase 11's mixtral layer
# (3.43 GB of bf16 params, about 24 GB of train state; f32 compute) on the
# mesh under the tp rules, then the same steps on one process (rank 0), one
# after the other
MESH7C_SSM_HOSTS = dict(n_virtual_hosts=ENGINE_RANKS, n_spares=0, recovery_policy="elastic")  # over ZOO_TRAIN
MESH7C_SSM_KERNELS = ("gather_rows",)
MESH7C_MOE_BATCH, MESH7C_MOE_SEQ, MESH7C_MOE_STEPS = 8, 128, 2


def checked_trainer(on_card: bool):
    """The Trainer class of phase 7c's runs: it holds this process's blocks
    right after each restore's scatter against ``kept``, its blocks at the
    step-3 checkpoint (``restored``: the step, the equal leaves, the
    leaves), and records rank 0's committed creates (``creates``)."""
    import torch

    from repro_torch.runtime.trainer import Trainer
    from repro_torch.utils.pytree import tree_flatten

    class CheckedTrainer(Trainer):
        kept: list | None = None
        restored: list | None = None

        def _scatter(self, policy: str | None = None) -> None:
            super()._scatter(policy)
            if self.kept is not None:
                if on_card:
                    torch.cuda.synchronize()
                now = [x.to_local() for x in tree_flatten(self.state)[1]]
                self.restored = [self._step_count(), sum(torch.equal(_int_view(a), _int_view(b))
                                                          for a, b in zip(now, self.kept)), len(now)]

        def record_creates(self) -> list:
            creates = []
            finalize = self.engine.finalize_async

            def finalize_and_record():
                ok = finalize()
                if ok:
                    creates.append(dict(step=int(self.engine.checkpoint_step()["step"]),
                                        **create_line(self.engine.stats)))
                return ok

            self.engine.finalize_async = finalize_and_record
            return creates

        def checked_run(self) -> list:
            """TRAIN_PERIOD steps, this process's blocks kept, then to
            TRAIN_STEPS."""
            self.run(TRAIN_PERIOD)
            self.kept = [x.to_local().clone() for x in tree_flatten(self.state)[1]]
            return self.run(TRAIN_STEPS)

    return CheckedTrainer


def mesh_trainer_body(rank: int, world: int, init_method: str, device: str, cfg, receive) -> dict:
    """Phase 7c in one process, started before phase 7 (``start_mesh_trainer``):
    join the (2, 2) process mesh, build the Trainer on it (each process draws
    the state from the seed and keeps its blocks) and take one step of its
    train step on a copy of the state (DTensor's sharding propagation for
    these shapes, off the measured run); then wait for ``receive()`` and run
    TRAIN_PERIOD steps, keep this process's blocks, and run to TRAIN_STEPS.
    Each process checks its blocks right after the restore against the kept
    ones. Returns the history, the check, rank 0's creates and restore, the
    launch counts, step times, card peak and the staged backend's traffic;
    with the second feed's configs, (a) under "ssm" (``mesh_ssm_run``) and
    (b) under "moe" (``mesh_moe_steps``)."""
    import gc

    import torch

    from repro_torch.core.checkpoint import EngineConfig
    from repro_torch.core.transport import staged_traffic
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime.failures import FailureInjector
    from repro_torch.runtime.trainer import TrainerConfig
    from repro_torch.utils.pytree import tree_map

    entered = time.time()
    on_card = device != "cpu"
    mesh = init_process_mesh(*MESH7C, MESH7C_BACKEND, rank=rank, world_size=world, init_method=init_method,
                             device=None if on_card else "cpu")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False

    tcfg = TrainerConfig(total_steps=TRAIN_STEPS, engine=EngineConfig(**MESH7C_ENGINE), **MESH7C_TRAIN)
    t0 = time.perf_counter()
    trainer = checked_trainer(on_card)(build_model(cfg), tcfg,
                                       injector=FailureInjector(MESH7C_HOSTS, schedule=TRAIN_KILLS), mesh=mesh)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spare = tree_map(lambda x: x.clone(), trainer.state)  # the warm-up step's copy of the state
    trainer._train_step(spare, trainer.data.peek(0))
    del spare
    if on_card:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    initialised = time.time()
    receive()
    ready = time.time()
    creates = trainer.record_creates() if rank == 0 else []
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    staged_traffic(mesh, reset=True)
    ops.reset_launch_counts()  # the main path's counts start here
    t0 = time.perf_counter()
    hist = trainer.checked_run()
    if on_card:
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    out = dict(rank=rank, coords=mesh.coords, steps=[h["step"] for h in hist], loss=[h["loss"] for h in hist],
               step_s=[h["step_s"] for h in hist], n_recoveries=trainer.n_recoveries, restored=trainer.restored,
               launches=ops.launch_counts(), setup_s=setup_s, warm_s=warm_s, run_s=run_s,
               staged=staged_traffic(mesh), entered=entered,
               initialised=initialised, ready=ready, done=time.time(),
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0)
    if rank == 0:
        s = trainer.engine.stats
        out.update(creates=creates, created=s.created, aborted=s.aborted, restore=restore_line(s))
        trainer.engine.close()
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ssm_cfg, moe_cfg = receive()
    out["ssm"] = mesh_ssm_run(mesh, ssm_cfg, on_card)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out["moe"] = mesh_moe_steps(mesh, moe_cfg, on_card)
    return out


def mesh_ssm_run(mesh, cfg, on_card: bool) -> dict:
    """(a): the Trainer on the Mamba-2 config on the mesh, on phase 11's
    ZOO_TRAIN over MESH7C_SSM_HOSTS, through an elastic recovery; the same history, checks and
    numbers as the first run's, and rank 0's engine's rank count at the
    end."""
    import torch

    from repro_torch.core.checkpoint import EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.runtime.failures import FailureInjector
    from repro_torch.runtime.trainer import TrainerConfig

    started = time.time()
    tcfg = TrainerConfig(total_steps=TRAIN_STEPS, engine=EngineConfig(), **{**ZOO_TRAIN, **MESH7C_SSM_HOSTS})
    t0 = time.perf_counter()
    trainer = checked_trainer(on_card)(build_model(cfg), tcfg,
                                       injector=FailureInjector(ENGINE_RANKS, schedule=TRAIN_KILLS), mesh=mesh)
    setup_s = time.perf_counter() - t0
    creates = trainer.record_creates() if mesh.rank == 0 else []
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # (a)'s counts start here
    t0 = time.perf_counter()
    hist = trainer.checked_run()
    if on_card:
        torch.cuda.synchronize()
    out = dict(steps=[h["step"] for h in hist], loss=[h["loss"] for h in hist], step_s=[h["step_s"] for h in hist],
               n_recoveries=trainer.n_recoveries, restored=trainer.restored, launches=ops.launch_counts(),
               setup_s=setup_s, run_s=time.perf_counter() - t0, started=started, done=time.time(),
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0)
    if mesh.rank == 0:
        s = trainer.engine.stats
        out.update(creates=creates, n_ranks=trainer.engine.n_ranks, restore=restore_line(s))
        trainer.engine.close()
    return out


def mesh_moe_steps(mesh, cfg, on_card: bool, compute: str = "float32") -> dict:
    """(b): MESH7C_MOE_STEPS of ``launch/steps.py::train_step`` on the mixtral
    config (its bf16 params, f32 compute) on the mesh (each process makes its
    blocks leaf by leaf from the seed: the whole state would be 24 GB a
    process), then, the mesh's state
    freed, the same steps on rank 0 alone from the same seed and batches.
    Returns the losses and step times of both (rank 0's one-process run
    under "one") and each process's card peak."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.synthetic import SyntheticDataPipeline
    from repro_torch.launch.steps import train_step
    from repro_torch.models import build_model
    from repro_torch.models.common import ShardCtx
    from repro_torch.optim.adamw import AdamWConfig, abstract_opt_state, init_opt_state
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.sharding.axes import tree_pspecs, tree_zero1_pspecs
    from repro_torch.sharding.mesh import distribute
    from repro_torch.utils import threefry
    from repro_torch.utils.pytree import tree_flatten, tree_unflatten

    started = time.time()
    # bf16 params, f32 compute: in bf16 two right step-0 gradients of this
    # layer, sharded and not, part by a few percent and in some signs, and
    # AdamW's first update, nearly a sign step, then parts the second loss
    # by more than 1e-4 (tools/moe_mesh_probe.py; PERF.md, PR 30)
    cfg = replace(cfg, compute_dtype=getattr(torch, compute))
    model = build_model(cfg)
    hp, sched = AdamWConfig(lr=TRAIN["lr"]), warmup_cosine(TRAIN["lr"], TRAIN["warmup_steps"], TRAIN_STEPS)

    def steps(state, pipe, ctx) -> tuple[list, list]:
        losses, times = [], []
        for _ in range(MESH7C_MOE_STEPS):
            t0 = time.perf_counter()
            loss = train_step(model, state, pipe.next(), hp, sched, ctx)[0].detach()
            losses.append(float(loss.full_tensor() if ctx is not None else loss))
            if on_card:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return losses, times

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(threefry.PRNGKey(SEED), mesh.device)
    paths, leaves = tree_flatten(params)
    del params
    p_specs = model.abstract_params
    ps = tree_flatten(tree_pspecs(p_specs, model.rules, mesh))[1]
    zs = tree_flatten(tree_zero1_pspecs(abstract_opt_state(p_specs)["master"], model.rules, mesh))[1]
    blocks, master = [], []
    for i in range(len(leaves)):  # leaf by leaf, each whole leaf freed once its blocks are made
        x, leaves[i] = leaves[i], None
        blocks.append(distribute(x, ps[i], mesh))
        master.append(distribute(x.to(torch.float32), zs[i], mesh))
        del x
    state = {"params": tree_unflatten(paths, blocks),
             "opt": {"master": tree_unflatten(paths, master),
                     "m": tree_unflatten(paths, [torch.zeros_like(x) for x in master]),
                     "v": tree_unflatten(paths, [torch.zeros_like(x) for x in master])},
             "step": distribute(torch.zeros((), dtype=torch.int32, device=mesh.device), (), mesh)}
    del blocks, master
    setup_s = time.perf_counter() - t0
    pipe = SyntheticDataPipeline(cfg, MESH7C_MOE_BATCH, MESH7C_MOE_SEQ, SEED, mesh=mesh, rules=model.rules)
    loss, step_s = steps(state, pipe, ShardCtx(mesh, model.rules))
    out = dict(loss=loss, step_s=step_s, setup_s=setup_s, started=started,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0)
    del state
    if on_card:
        torch.cuda.empty_cache()
    dist.barrier(group=mesh.group)  # every process's share freed before the one-process run
    out["mesh_done"] = time.time()
    if mesh.rank == 0:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        params = model.init(threefry.PRNGKey(SEED), mesh.device)
        state = {"params": params, "opt": init_opt_state(params),
                 "step": torch.zeros((), dtype=torch.int32, device=mesh.device)}
        del params
        loss, step_s = steps(state, SyntheticDataPipeline(cfg, MESH7C_MOE_BATCH, MESH7C_MOE_SEQ, SEED,
                                                          device=mesh.device), None)
        out["one"] = dict(loss=loss, step_s=step_s,
                          peak_device_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0)
        del state
        if on_card:
            torch.cuda.empty_cache()
    dist.barrier(group=mesh.group)
    out["done"] = time.time()
    return out


def start_mesh_trainer(cfg):
    """Start phase 7c's processes (``mesh_trainer_body``) before phase 7, so
    that their start-up (the interpreter, CUDA, the groups, the state, the
    warm-up step) and their run go beside phases 7 and 5. The kernels are
    built here, once."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import RankGroup

    _build.build()
    check(all(_build.lib_path(n).exists() for n in _build.KERNELS), "phase 7c: the kernels are not built")
    group = RankGroup(mesh_trainer_body, math.prod(MESH7C[0]), args=("cuda", cfg), late=True)
    group.started = time.time()
    return group


def feed_mesh_trainer(group) -> None:
    """Let phase 7c's processes run (each once its start-up is done)."""
    group.feed([()] * group.world_size)
    group.fed = time.time()


def feed_mesh_zoo(group, ssm_cfg, moe_cfg) -> None:
    """Let phase 7c's processes run (a) and (b) once their first run is
    done."""
    group.feed([(ssm_cfg, moe_cfg)] * group.world_size)
    group.fed_zoo = time.time()


def mesh_trainer_path(group, sync_loss: list, phase_ends: dict) -> tuple[dict, dict]:
    """Phase 7c: the processes of ``start_mesh_trainer`` run the Trainer on
    the (2, 2) mesh. Checks every loss finite, one recovery, the replayed
    steps' losses bit-equal to their first pass, every process's blocks
    right after the restore byte-equal to its blocks at the step-3
    checkpoint, the same history on every process, the losses before the
    kill within rtol 1e-4 of phase 7's sync run (``sync_loss``: the same
    model, seed and TRAIN, on one card), and B4 launched in rank 0's engine;
    then (a) and (b) (``feed_mesh_zoo``): (a) the same checks but the last
    (its losses against phase 11's one-card run: ``check_mesh_ssm_losses``),
    rank 0's engine on 3 ranks after the elastic recovery and B6 launched;
    (b) finite losses on the mesh within rtol 1e-4 of the one-process run's.
    ``phase_ends`` holds each earlier phase's end (``time.time()``), to name
    the phases that the start-up and the runs went beside. Returns the
    processes' launch counts, summed over the three runs, and the runs'
    numbers."""
    if not hasattr(group, "fed"):
        feed_mesh_trainer(group)
    t0, fed = time.perf_counter(), group.fed
    try:
        results = group.join(timeout=900)
    finally:
        group.stop()
    wait_s = time.perf_counter() - t0  # what the script waited here: the rest ran beside earlier phases
    counts: dict = {}
    for res in results:
        for c in (res["launches"], res["ssm"]["launches"]):
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
    r0 = results[0]
    losses = r0["loss"]
    check(all(math.isfinite(x) for res in results for x in res["loss"]), f"phase 7c: a loss is not finite: {losses}")
    check(r0["steps"] == TRAIN_HISTORY, f"phase 7c: steps {r0['steps']}")
    check(all(res["steps"] == r0["steps"] and res["loss"] == losses for res in results),
          "phase 7c: the processes' histories differ")
    check(all(res["n_recoveries"] == 1 for res in results),
          f"phase 7c: recoveries {[r['n_recoveries'] for r in results]}")
    check(losses[3:5] == losses[5:7], f"phase 7c: replayed losses {losses[5:7]} differ from {losses[3:5]}")
    for res in results:
        rr = res["restored"]
        check(rr is not None and rr[0] == TRAIN_PERIOD and rr[1] == rr[2],
              f"phase 7c: rank {res['rank']}'s blocks after the restore differ from the step-{TRAIN_PERIOD} "
              f"checkpoint's: {rr}")
    ref = sync_loss[:5]
    check(all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(losses[:5], ref)),
          f"phase 7c: losses before the kill {losses[:5]} not within rtol 1e-4 of phase 7's {ref}")
    check([c["step"] for c in r0["creates"]] == [TRAIN_PERIOD, 2 * TRAIN_PERIOD],
          f"phase 7c: committed creates {r0['creates']}")
    for name in MESH7C_KERNELS:
        check(sum(res["launches"].get(name, 0) for res in results) > 0,
              f"phase 7c: kernel {name} was launched no time")
    for res in results:
        log(f"phase 7c rank {res['rank']} {res['coords']}: steps " + ", ".join(f"{x:.3f}" for x in res["step_s"])
            + f" s; card peak {res['peak_device_gb']:.2f} GB; setup {res['setup_s']:.1f} s, warm-up step "
              f"{res['warm_s']:.1f} s; staged {json.dumps(res['staged'])}")
    log("phase 7c rank 0: creates " + ", ".join(f"step {c['step']} {c['create_s']:.3f} s (capture "
                                               f"{c['capture_s']:.3f})" for c in r0["creates"])
        + f"; restore {r0['restore']['restore_s']:.3f} s")
    initialised, done = max(res["initialised"] for res in results), max(res["done"] for res in results)
    wall_s = done - fed  # the first run's own seconds: from the feed to the last process's end

    startup_beside = phases_beside(phase_ends, group.started, initialised)
    run_beside = phases_beside(phase_ends, fed, done)
    log(f"phase 7c: {wall_s:.1f} s from the feed to the last process's end, beside "
        f"{', '.join(run_beside) or 'no phase'}; start-up {initialised - group.started:.1f} s beside "
        f"{', '.join(startup_beside) or 'no phase'}")
    ssm, moe = mesh_ssm_checks(results, phase_ends, group), mesh_moe_checks(results, phase_ends)
    log(f"phase 7c: {wait_s:.1f} s of wait after the phases beside")
    out = dict(
        wall_s=wall_s, wait_s=wait_s, startup_beside=startup_beside, run_beside=run_beside, world=group.world_size, mesh=MESH7C, backend=MESH7C_BACKEND, hosts=MESH7C_HOSTS,
        loss=losses, sync_loss=ref, creates=r0["creates"], restore=r0["restore"], created=r0["created"],
        aborted=r0["aborted"],
        entered_s=max(res["entered"] for res in results) - group.started,
        initialised_s=initialised - group.started,
        ready_s=max(res["ready"] for res in results) - fed,
        runs_s=done - max(res["ready"] for res in results),
        ranks=[dict(rank=res["rank"], step_s=res["step_s"], peak_device_gb=res["peak_device_gb"],
                    run_s=res["run_s"], setup_s=res["setup_s"], warm_s=res["warm_s"], staged=res["staged"])
               for res in results],
        ssm=ssm, moe=moe)
    log("phase 7c: " + json.dumps(out))
    log(f"phase 7c launches (the processes'): {json.dumps(counts)}")
    return counts, out


def mesh_ssm_checks(results: list, phase_ends: dict, group) -> dict:
    """Phase 7c's (a) on every process: the first run's checks (the losses
    against a one-card run aside), 3 engine ranks and B6 launched."""
    runs = [res["ssm"] for res in results]
    r0 = runs[0]
    losses = r0["loss"]
    check(all(math.isfinite(x) for r in runs for x in r["loss"]), f"phase 7c (a): a loss is not finite: {losses}")
    check(r0["steps"] == TRAIN_HISTORY, f"phase 7c (a): steps {r0['steps']}")
    check(all(r["steps"] == r0["steps"] and r["loss"] == losses for r in runs),
          "phase 7c (a): the processes' histories differ")
    check(all(r["n_recoveries"] == 1 for r in runs), f"phase 7c (a): recoveries {[r['n_recoveries'] for r in runs]}")
    check(losses[3:5] == losses[5:7], f"phase 7c (a): replayed losses {losses[5:7]} differ from {losses[3:5]}")
    for res, r in zip(results, runs):
        rr = r["restored"]
        check(rr is not None and rr[0] == TRAIN_PERIOD and rr[1] == rr[2],
              f"phase 7c (a): rank {res['rank']}'s blocks after the restore differ from the step-{TRAIN_PERIOD} "
              f"checkpoint's: {rr}")
    check(r0["n_ranks"] == ENGINE_RANKS - 1, f"phase 7c (a): the engine ends on {r0['n_ranks']} ranks")
    check([c["step"] for c in r0["creates"]] == [TRAIN_PERIOD, TRAIN_PERIOD, 2 * TRAIN_PERIOD],
          f"phase 7c (a): committed creates {r0['creates']}")
    for name in MESH7C_SSM_KERNELS:
        check(sum(r["launches"].get(name, 0) for r in runs) > 0, f"phase 7c (a): kernel {name} was launched no time")
    started, done = min(r["started"] for r in runs), max(r["done"] for r in runs)
    beside = phases_beside(phase_ends, started, done)
    for res, r in zip(results, runs):
        log(f"phase 7c (a) rank {res['rank']}: steps " + ", ".join(f"{x:.3f}" for x in r["step_s"])
            + f" s; card peak {r['peak_device_gb']:.2f} GB; setup {r['setup_s']:.1f} s")
    log("phase 7c (a) rank 0: creates " + ", ".join(f"step {c['step']} {c['create_s']:.3f} s" for c in r0["creates"])
        + f"; restore_elastic {r0['restore']['restore_s']:.3f} s; engine on {r0['n_ranks']} ranks")
    log(f"phase 7c (a): {done - group.fed_zoo:.1f} s from the feed to the last process's end ({done - started:.1f} "
        f"s of its own), beside {', '.join(beside) or 'no phase'}")
    return dict(loss=losses, steps=r0["steps"], creates=r0["creates"], restore=r0["restore"], n_ranks=r0["n_ranks"],
                wall_s=done - started, fed_to_end_s=done - group.fed_zoo, beside=beside,
                ranks=[dict(step_s=r["step_s"], peak_device_gb=r["peak_device_gb"], setup_s=r["setup_s"],
                            run_s=r["run_s"]) for r in runs])


def mesh_moe_checks(results: list, phase_ends: dict) -> dict:
    """Phase 7c's (b): the same finite losses on every process, within rtol
    1e-4 of rank 0's one-process run of the same steps."""
    runs = [res["moe"] for res in results]
    loss, one = runs[0]["loss"], runs[0]["one"]["loss"]
    check(all(math.isfinite(x) for x in loss + one), f"phase 7c (b): a loss is not finite: {loss}, {one}")
    check(all(r["loss"] == loss for r in runs), "phase 7c (b): the processes' losses differ")
    check(all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(loss, one)) and len(loss) == len(one) == MESH7C_MOE_STEPS,
          f"phase 7c (b): the mesh's losses {loss} not within rtol 1e-4 of one process's {one}")
    started, done = min(r["started"] for r in runs), max(r["done"] for r in runs)
    mesh_done = max(r["mesh_done"] for r in runs)
    beside = phases_beside(phase_ends, started, done)
    log(f"phase 7c (b): losses {loss} on the mesh, {one} on one process; mesh steps "
        + "; ".join(", ".join(f"{x:.3f}" for x in r["step_s"]) for r in runs)
        + f" s (setup {max(r['setup_s'] for r in runs):.1f} s); one-process steps "
        + ", ".join(f"{x:.3f}" for x in runs[0]["one"]["step_s"]) + " s; card peak per process "
        + ", ".join(f"{r['peak_device_gb']:.2f}" for r in runs) + f" GB on the mesh, "
        f"{runs[0]['one']['peak_device_gb']:.2f} GB on one process")
    log(f"phase 7c (b): {done - started:.1f} s ({mesh_done - started:.1f} s on the mesh), beside "
        f"{', '.join(beside) or 'no phase'}")
    return dict(loss=loss, one=runs[0]["one"], wall_s=done - started, mesh_s=mesh_done - started, beside=beside,
                ranks=[dict(step_s=r["step_s"], peak_device_gb=r["peak_device_gb"], setup_s=r["setup_s"])
                       for r in runs])


def check_mesh_ssm_losses(ssm: dict, one_card: list) -> None:
    """Phase 7c's (a) against phase 11's one-card Trainer on the same model,
    seed and batches: the losses before the kill within rtol 1e-4."""
    got, ref = ssm["loss"][:5], one_card[:5]
    check(len(ref) == 5 and all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(got, ref)),
          f"phase 7c (a): losses before the kill {got} not within rtol 1e-4 of phase 11's one-card run {ref}")
    log(f"phase 7c (a): losses before the kill within {max(abs(a - b) / abs(b) for a, b in zip(got, ref)):.2e} "
        f"relative of phase 11's one-card run")


# ---------------------------------------------------------------------------
# phase 10: the fault-tolerant server (paper Algorithm 3 over decode sessions)
# ---------------------------------------------------------------------------

# every run: 16 sessions, prompts of 1024 tokens, a max_seq 2048 KV cache, 48
# decoded tokens, a session checkpoint every 16, 4 virtual hosts (8 for the
# rs run: with one group of 4 a group's parity stripes die with its hosts)
SERVE = dict(batch=16, max_seq=2048, checkpoint_every_tokens=16, n_virtual_hosts=4)
SERVE_PROMPT, SERVE_GEN = 1024, 48
# (name, ServerConfig fields, EngineConfig fields, kills {tick: ranks},
# silent kills {tick: ranks}, recoveries)
SERVE_RUNS = (
    ("clean", {}, {}, {}, {}, 0),
    ("spare+heartbeat", {}, {}, {20: [2]}, {34: [1]}, 2),
    ("async", {"checkpoint_mode": "async"}, {}, {20: [2]}, {}, 1),
    ("replica", {"replica_team": True}, {}, {30: [0, 1, 2, 3]}, {}, 1),
    ("compress", {}, {"compress": True}, {20: [2]}, {}, 1),
    ("rs", {"n_virtual_hosts": 8}, {"codec": "rs", "parity_group": 4, "rs_parity": 2, "gf_backend": "torch"},
     {20: [0, 2]}, {}, 1),
    ("elastic", {"n_spares": 0, "recovery_policy": "elastic"}, {}, {11: [2], 26: [0]}, {}, 2),
)
# B4 (rs run), B5a/B5b (compress run), B6 (elastic run)
SERVE_KERNELS = ("gf256_matmul_dyn", "quantize_blockwise", "dequantize_blockwise", "gather_rows")


def _p99(xs: list[float]) -> float:
    ys = sorted(xs)
    return ys[max(math.ceil(0.99 * len(ys)) - 1, 0)]


def decode_profile(server, step_s: float, steps: int = 4) -> dict:
    """``steps`` more greedy steps of the server's sessions under
    ``torch.profiler`` (CPU and CUDA activities), each ending in
    ``torch.cuda.synchronize()``: the device's busy time per step (the sum of
    its kernels' times: decode runs on one stream), the idle share against
    ``step_s`` (the unprofiled step's median: tracing slows the host) and
    against the profiled steps, the kernel launches per step and the kernels
    that take most device time. Device numbers are None where the profiler
    saw no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pos = int(server.sessions["pos"])
    check(pos + steps < server.scfg.max_seq, "no room in the cache for the profiled steps")
    server.steps.clear()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            server._decode_one(pos + i)
    wall = sum(server.steps)
    averages = prof.key_averages()
    profile_s = time.perf_counter() - t0

    def dev_us(e) -> float:
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    return dict(steps=steps, profile_s=profile_s, profiled_step_ms=wall / steps * 1e3,
                device_busy_ms_per_step=busy / steps * 1e3 if kernels else None,
                idle_share=1 - busy / steps / step_s if kernels else None,
                idle_share_profiled=1 - busy / wall if kernels else None,
                launches_per_step=sum(e.count for e in kernels) / steps if kernels else None,
                top_kernels_ms_per_step=[[e.key[:60], dev_us(e) / 1e3 / steps] for e in top])


def cross_leaves(server) -> list:
    """The sessions' cross-attention cache leaves (the VLM's "cross" slots:
    filled at prefill, read by decode); empty for other models."""
    cfg = server.model.cfg
    cache = server.sessions["cache"]
    return [cache[f"slot{j}"][k] for j, kind in enumerate(cfg.layer_pattern) if kind == "cross" for k in ("k", "v")]


def serve_run(model, params, prompts, ref, name: str, scfg_kw: dict, eng_kw: dict, kills: dict,
              silent: dict, recoveries: int, extra: dict | None = None,
              cross_ref: list | None = None) -> tuple[dict, object, list]:
    """One run of SERVE_RUNS: the port's Server through its kills, timed
    (prefill, every decode step ending in ``torch.cuda.synchronize()``,
    every committed create, every recovery); its tokens held against
    ``ref``, the clean run's (None for the clean run itself). ``extra`` are
    the model's other prefill inputs (the VLM's vision stub). After every
    recovery the sessions' cross-attention cache is held byte for byte
    against ``cross_ref``, the clean run's. Returns the run's numbers, its
    tokens and (clean run) a copy of its cross-attention cache."""
    import gc

    import numpy as np
    import torch

    from repro_torch.core.checkpoint import EngineConfig
    from repro_torch.obs.trace import tracer
    from repro_torch.runtime.failures import FailureInjector
    from repro_torch.runtime.server import Server, ServerConfig

    class TimedServer(Server):
        def __init__(self, *a, **k) -> None:
            self.creates, self.steps, self.recoveries = [], [], []
            super().__init__(*a, **k)

        def _new_engine(self, n_ranks: int):
            eng = super()._new_engine(n_ranks)
            finalize = eng.finalize_async

            def finalize_and_record():
                ok = finalize()
                if ok:
                    self.creates.append(dict(pos=eng.checkpoint_step()["pos"], ranks=eng.n_ranks,
                                             **create_line(eng.stats)))
                return ok

            eng.finalize_async = finalize_and_record
            return eng

        def prefill(self, prompts, **inputs) -> None:
            t0 = time.perf_counter()
            super().prefill(prompts, **inputs)
            torch.cuda.synchronize()
            self.prefill_s = time.perf_counter() - t0

        def _decode_one(self, pos: int) -> None:
            t0 = time.perf_counter()
            super()._decode_one(pos)
            torch.cuda.synchronize()
            self.steps.append(time.perf_counter() - t0)

        def recover(self) -> None:
            promotions = self.promotions
            t0 = time.perf_counter()
            super().recover()
            torch.cuda.synchronize()
            rec = dict(recover_s=time.perf_counter() - t0, pos=int(self.sessions["pos"]),
                       ranks=self.engine.n_ranks, promoted=self.promotions > promotions,
                       **restore_line(self.engine.stats))
            if cross_ref:
                rec["cross_cache_equal"] = all(torch.equal(a, b) for a, b in zip(cross_leaves(self), cross_ref))
                check(rec["cross_cache_equal"], f"serve {name}: the restored cross-attention cache differs "
                                                f"from the clean run's at position {rec['pos']}")
            rep = self.engine.last_elastic_report
            if rep is not None:
                rec.update(bytes_moved=rep.bytes_moved, bytes_lower_bound=rep.bytes_lower_bound,
                           moved_over_bound=rep.bytes_moved / max(rep.bytes_lower_bound, 1))
                self.engine.last_elastic_report = None
            self.recoveries.append(rec)

    scfg = ServerConfig(**{**SERVE, **scfg_kw}, engine=EngineConfig(**eng_kw))
    hosts = scfg.n_virtual_hosts
    injector = FailureInjector(hosts, schedule=kills, silent_schedule=silent)
    torch.cuda.reset_peak_memory_stats()
    replica = scfg.replica_team
    if replica:
        tracer().reset()
        tracer().enable()
    stop_rss = rss_sampler()
    server = TimedServer(model, scfg, params=params, injector=injector)
    check(server.device.type == "cuda", f"serve {name}: the server runs on {server.device}")
    t0 = time.perf_counter()
    out = server.prefill_and_decode(prompts, SERVE_GEN, **(extra or {}))
    serve_s = time.perf_counter() - t0
    host_peak = stop_rss()
    run = dict(name=name, hosts=hosts, engine=eng_kw, server=scfg_kw, kills=kills, silent_kills=silent,
               prefill_s=server.prefill_s, steps=len(server.steps),
               step_ms_median=statistics.median(server.steps) * 1e3, step_ms_p99=_p99(server.steps) * 1e3,
               decode_tokens_per_s=SERVE["batch"] * len(server.steps) / sum(server.steps),
               serve_s=serve_s, tokens_per_s=SERVE["batch"] * SERVE_GEN / (serve_s - server.prefill_s),
               checkpoints=server.creates, blocked_s=[c["blocked_s"] for c in server.creates],
               recoveries=server.recoveries, n_recoveries=server.n_recoveries, promotions=server.promotions,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9, host_peak_rss_gib=host_peak)
    if replica:
        rt = server.replica
        spans = tracer().events()
        tracer().disable()
        tracer().reset()
        commits = sorted(e["t0"] for e in spans if e["name"] == "commit")
        check(len(commits) >= 2, f"serve {name}: {len(commits)} commits traced, need two for the interval")
        interval = (commits[-1] - commits[0]) / (len(commits) - 1)
        stall = sum(e["dur"] for e in spans if e["name"] == "replica_promote_restore")
        run.update(bytes_synced=rt.bytes_synced, syncs=rt.syncs, blocked_sync_s=rt.blocked_sync_s,
                   rebuild_s=rt.rebuild_s, replica_state=rt.state, promotion_stall_s=stall,
                   checkpoint_interval_s=interval)
        check(server.promotions == 1, f"serve {name}: {server.promotions} promotions, want 1")
        check(stall < interval, f"serve {name}: promotion stall {stall:.3f} s >= one checkpoint interval "
                                f"{interval:.3f} s")
    check(server.n_recoveries == recoveries, f"serve {name}: {server.n_recoveries} recoveries, want {recoveries}")
    if ref is not None and eng_kw.get("compress"):
        # int8 partner copies are lossy: the killed ranks' sessions restore
        # from dequantize(quantize(cache)), so only their rows may decode
        # differently after the rollback; every other row and every token up
        # to the rollback position must be bit-equal
        per = SERVE["batch"] // hosts
        lossy = {b for ranks in kills.values() for r in ranks for b in range(r * per, (r + 1) * per)}
        diff = out != ref
        rows = set(np.nonzero(diff.any(1))[0].tolist())
        rollback = min(r["pos"] for r in server.recoveries)
        check(rows <= lossy, f"serve {name}: rows {sorted(rows - lossy)} outside the restored ranks differ")
        check(not diff[:, : rollback + 1].any(), f"serve {name}: tokens up to the rollback position differ")
        run.update(lossy_rows=sorted(lossy), rows_differing=sorted(rows), tokens_differing=int(diff.sum()))
    elif ref is not None:
        check(np.array_equal(out, ref), f"serve {name}: tokens differ from the clean run's "
                                        f"({int((out != ref).sum())} tokens)")
    run["tokens_equal"] = ref is None or bool(np.array_equal(out, ref))
    cross = [x.clone() for x in cross_leaves(server)] if ref is None else []
    if ref is None:
        run["decode_profile"] = decode_profile(server, statistics.median(server.steps))
    server.close()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return run, out, cross


def serve_path(cfg, runs_spec=SERVE_RUNS, kernels=SERVE_KERNELS, label: str = "serve",
               extra=None) -> tuple[dict, list[dict]]:
    """Phase 10: the port's Server on the card with llama3.2-1b at full
    width and depth (bf16 params from the seed, not snapshotted) through
    SERVE_RUNS under deterministic algorithms; every faulted run's tokens
    held against the clean run's (the first of ``runs_spec``). Phases 11
    and 12 drive their servers through the same path with their own runs;
    ``extra(cfg)`` makes the model's other prefill inputs on the card (the
    VLM's vision stub), drawn once for every run. Returns the kernels'
    launch counts over the whole phase and the runs' numbers, each run's B4
    launches among them."""
    import gc

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.utils import threefry
    from repro_torch.utils.pytree import tree_leaves

    model = build_model(cfg)
    cache_bytes = sum(int(math.prod(s.shape)) * s.dtype.itemsize
                      for s in tree_leaves(model.abstract_cache(SERVE["batch"], SERVE["max_seq"])))
    # the largest run's host arenas: two teams (replica), two banks each,
    # every rank's own shard and exchange subset of the cache
    need = 8 * cache_bytes / 2**30
    free = host_free_settled_gib(need + HOST_HEADROOM_GIB)
    check(need + HOST_HEADROOM_GIB <= free, f"{label} path: {need:.1f} GiB of host RAM needed, {free:.1f} free")
    t0 = time.perf_counter()
    params = model.init(threefry.PRNGKey(SEED), "cuda")
    prompts = threefry.randint(threefry.fold_in(threefry.PRNGKey(SEED), 10), (SERVE["batch"], SERVE_PROMPT), 0,
                               cfg.vocab_size, device="cuda").cpu().numpy().astype("int32")
    inputs = {} if extra is None else extra(cfg)
    torch.cuda.synchronize()
    params_gb = sum(x.numel() * x.element_size() for x in tree_leaves(params)) / 1e9
    log(f"{label}: {cfg.name}, {cfg.num_layers} layers, params {params_gb:.3f} GB ({model.n_params} bf16) in "
        f"{time.perf_counter() - t0:.1f} s; KV cache {cache_bytes / 1e9:.3f} GB; host RAM {free:.1f} GiB free, "
        f"about {need:.1f} GiB needed")
    torch.use_deterministic_algorithms(True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    runs, ref, cross = [], None, None
    ops.reset_launch_counts()  # this path's counts start here
    for name, scfg_kw, eng_kw, kills, silent, recoveries in runs_spec:
        b4 = ops.launch_counts()["gf256_matmul_dyn"]
        run, out, clean_cross = serve_run(model, params, prompts, ref, name, scfg_kw, eng_kw, kills, silent,
                                          recoveries, inputs, cross)
        run["b4_launches"] = ops.launch_counts()["gf256_matmul_dyn"] - b4
        if ref is None:
            ref, cross = out, clean_cross
        runs.append(run)
        log(f"{label} {name}: " + json.dumps(run))
    counts = ops.launch_counts()
    torch.use_deterministic_algorithms(False)
    torch.utils.deterministic.fill_uninitialized_memory = fill
    for k in kernels:
        check(counts[k] > 0, f"kernel {k} was launched no time on the {label} path")
    del params, inputs, cross
    gc.collect()
    torch.cuda.empty_cache()
    return counts, runs

# ---------------------------------------------------------------------------
# phase 11: the model zoo (MoE and Mamba-2 through kills)
# ---------------------------------------------------------------------------

# depth of the Mamba-2 runs (of 48 layers) and of the mixtral server (of
# 32), width kept: for the run's time
ZOO_SSM_LAYERS = 2  # 4 before phase 7c joined the run
ZOO_MOE_LAYERS = 1
# (a) phase 7's run on mamba2-780m with 4 sequences of 512 tokens (4 SSD
# chunks of 128: the inter-chunk recurrence runs) and rs g=4 m=2 with every
# GF(2^8) product through B4. 8 hosts: a striped blob lives on the next
# group's hosts, so with one group of 4 any loss takes every blob with it
ZOO_TRAIN = {**TRAIN, "batch": 4, "seq": 512, "n_virtual_hosts": 8}
ZOO_TRAIN_ENGINE = dict(codec="rs", parity_group=4, rs_parity=2, gf_backend="torch")
# (b) phase 10's traffic on mixtral-8x7b: clean, and rs over 8 hosts with
# {0, 2} killed at tick 20
ZOO_MOE_RUNS = tuple(r for r in SERVE_RUNS if r[0] in ("clean", "rs"))
# (c) the same traffic on mamba2-780m: clean, and the default engine with
# host 2 killed at tick 20 (a spare); the restore writes the SSM's conv
# history and state back in place
ZOO_SSM_RUNS = (ZOO_MOE_RUNS[0], ("spare", {}, {}, {20: [2]}, {}, 1))


def zoo_configs():
    """(mamba2-780m at ZOO_SSM_LAYERS, mixtral-8x7b at ZOO_MOE_LAYERS): the
    published widths."""
    from repro_torch.configs import get_config

    return (replace(get_config("mamba2-780m"), num_layers=ZOO_SSM_LAYERS),
            replace(get_config("mixtral-8x7b"), num_layers=ZOO_MOE_LAYERS))


def zoo_path() -> tuple[dict, dict]:
    """Phase 11: (a) the Trainer on the Mamba-2 config through a kill with
    the rs engine on the card, phase 7's checks; (b) the Server on the
    mixtral config, clean and rs over 8 hosts through two kills; (c) the
    Server on the Mamba-2 config, clean and through a kill. Checks B4
    launched in (a) and (b). Returns the kernels' launch counts over the
    phase and each run's numbers."""
    from repro_torch.core.checkpoint import EngineConfig

    ssm_cfg, moe_cfg = zoo_configs()
    log(f"zoo: {ssm_cfg.name} at {ssm_cfg.num_layers} of 48 layers and {moe_cfg.name} at {moe_cfg.num_layers} "
        f"of 32, width kept (ZOO_SSM_LAYERS, ZOO_MOE_LAYERS: for the run's time)")
    out, counts = {}, {}

    def add(c: dict) -> None:
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    t0 = time.perf_counter()
    run, c = trainer_path(ssm_cfg, "sync", engine=EngineConfig(**ZOO_TRAIN_ENGINE), train=ZOO_TRAIN,
                          label="zoo trainer")
    run.update(b4_launches=c["gf256_matmul_dyn"], phase_s=time.perf_counter() - t0)
    log("zoo trainer: " + json.dumps(run))
    check(run["b4_launches"] > 0, "zoo trainer: B4 was launched no time")
    out["trainer"] = run
    add(c)
    for name, cfg, runs in (("moe serve", moe_cfg, ZOO_MOE_RUNS), ("ssm serve", ssm_cfg, ZOO_SSM_RUNS)):
        t0 = time.perf_counter()
        c, served = serve_path(cfg, runs, kernels=("gf256_matmul_dyn",) if name == "moe serve" else (),
                               label=f"zoo {name}")
        out[name] = dict(runs=served, phase_s=time.perf_counter() - t0)
        add(c)
    r = out["trainer"]
    log(f"zoo trainer ({ssm_cfg.name}): setup {r['setup_s']:.2f} s, creates "
        + json.dumps([round(x["create_s"], 4) for x in r["checkpoints"]])
        + f" s, restore {r['restore']['restore_s']:.3f} s, step median "
        f"{statistics.median(r['step_s']) * 1e3:.1f} ms, card peak {r['peak_device_gb']:.2f} GB, host peak "
        f"{r['host_peak_rss_gib']:.2f} GiB, B4 launches {r['b4_launches']}")
    for name in ("moe serve", "ssm serve"):
        for r in out[name]["runs"]:
            log(f"zoo {name} {r['name']}: prefill {r['prefill_s']:.2f} s, creates "
                + json.dumps([round(x["create_s"], 4) for x in r["checkpoints"]])
                + " s, restores " + json.dumps([round(x["recover_s"], 4) for x in r["recoveries"]])
                + f" s, decode median {r['step_ms_median']:.2f} ms, p99 {r['step_ms_p99']:.2f} ms, card peak "
                f"{r['peak_device_gb']:.2f} GB, host peak {r['host_peak_rss_gib']:.2f} GiB, "
                f"B4 launches {r['b4_launches']}")
    return counts, out


# ---------------------------------------------------------------------------
# phase 12: the encoder and the VLM (hubert-xlarge, llama-3.2-vision-90b)
# ---------------------------------------------------------------------------

# depth of the hubert trainer (of 48 layers) and of the VLM server (one
# period of its 100 layers: 4 self-attention slots and 1 cross slot), width
# kept: for the run's time
HUBERT_LAYERS = 2
VLM_LAYERS = 5
# (a) phase 11's trainer traffic (4 x 512 frames, 8 hosts) with xor g=4 on
# B4 (its encode and the pipelined decode): with one group of 4 a group's
# parity stripe dies with its hosts, so 8 hosts, two groups
HUBERT_ENGINE = dict(codec="xor", parity_group=4, gf_backend="torch")
# (b) phase 10's traffic on the VLM with the serve CLI's vision stub: clean,
# and rs over 8 hosts with {0, 2} killed at tick 20
VLM_RUNS = ZOO_MOE_RUNS
# (c) compressed_psum in a one-process NCCL group: its rendezvous file
PSUM_BACKEND = "nccl"
PSUM_RDV = ROOT / "build" / "psum_rdv"
PSUM_LEAF = ("layers", "slot0", "ffn", "w_in")  # (a)'s, 4 x 1280 x 5120: a multiple of 8192


def encoder_vlm_configs():
    """(hubert-xlarge at HUBERT_LAYERS, llama-3.2-vision-90b at VLM_LAYERS):
    the published widths."""
    from repro_torch.configs import get_config

    return (replace(get_config("hubert-xlarge"), num_layers=HUBERT_LAYERS),
            replace(get_config("llama-3.2-vision-90b"), num_layers=VLM_LAYERS))


def vision_stub(cfg) -> dict:
    """The serve CLI's vision stub on the card: ``threefry.normal`` of
    ``PRNGKey(0)``, (sessions, vision_tokens, frontend_stub_dim)."""
    from repro_torch.utils import threefry

    return {"vision": threefry.normal(threefry.PRNGKey(0), (SERVE["batch"], cfg.vision_tokens,
                                                            cfg.frontend_stub_dim), device="cuda")}


def encoder_probe(grads: dict):
    """(a)'s probe: the encoder is bidirectional on the card (a prefill of
    the step-0 frames and one with the last frame changed differ at the
    first position), and one gradient of the trained params for (c)."""

    def probe(trainer) -> dict:
        import torch

        from repro_torch.utils.pytree import tree_flatten, tree_unflatten

        frames = trainer.data.peek(0)["frames"]
        moved = frames.clone()
        moved[:, -1] += 1.0
        params = trainer.state["params"]
        with torch.no_grad():
            l1, c1 = trainer.model.prefill(params, frames=frames)
            l2, _ = trainer.model.prefill(params, frames=moved)
        first = float((l1[:, 0] - l2[:, 0]).abs().max())
        check(c1 is None and tuple(l1.shape) == (*frames.shape[:2], trainer.model.cfg.padded_vocab),
              f"encoder prefill: logits {tuple(l1.shape)}, cache {type(c1).__name__}")
        check(first > 0, "encoder: changing the last frame left the first position's logits unchanged")
        paths, live = tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in live]
        loss, _ = trainer.model.loss(tree_unflatten(paths, leaves), trainer.data.peek(0))
        grads["leaf"] = torch.autograd.grad(loss, leaves[paths.index(PSUM_LEAF)])[0].detach()
        return dict(first_position_max_abs_change=first, logits_shape=list(l1.shape))

    return probe


def psum_run(grad) -> dict:
    """(c): ``compressed_psum`` of ``grad`` in a one-process NCCL group
    (rendezvous through a ``file://`` path under ``build/``), held bit for
    bit against its plain version: ``ref.quantize_blockwise`` then the plain
    multiply (the all-reduce over one rank is the identity). Returns its
    numbers; the kernels' launch counts are set to 0 at its start."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops, ref
    from repro_torch.optim.grad_compress import compressed_psum

    PSUM_RDV.parent.mkdir(parents=True, exist_ok=True)
    PSUM_RDV.unlink(missing_ok=True)
    dist.init_process_group(PSUM_BACKEND, init_method=f"file://{PSUM_RDV}", world_size=1, rank=0)
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = compressed_psum(grad)
        torch.cuda.synchronize()
        psum_s = time.perf_counter() - t0
        launches = ops.launch_counts()["quantize_blockwise"]
    finally:
        dist.destroy_process_group()
        PSUM_RDV.unlink(missing_ok=True)
    x = grad.reshape(-1)
    q, scale = ref.quantize_blockwise(x.to(torch.float32), 256)
    plain = (q.to(torch.float32) * scale.repeat_interleave(256)).reshape(grad.shape).to(grad.dtype)
    check(tuple(out.shape) == tuple(grad.shape) and out.dtype == grad.dtype,
          f"compressed_psum: {tuple(out.shape)} {out.dtype} from {tuple(grad.shape)} {grad.dtype}")
    equal = bool(torch.equal(out.view(torch.int16), plain.view(torch.int16))) if out.dtype == torch.bfloat16 \
        else bool(torch.equal(out, plain))
    check(equal, "compressed_psum differs from the plain quantize then multiply")
    check(launches > 0, "compressed_psum: B5a was launched no time")
    return dict(elements=grad.numel(), dtype=str(grad.dtype), psum_s=psum_s, b5a_launches=launches,
                bit_equal=equal, max_abs_err=float((out.float() - plain.float()).abs().max()))


def encoder_vlm_path() -> tuple[dict, dict]:
    """Phase 12: (a) the Trainer on the hubert-xlarge config through a kill
    with xor over 8 hosts on B4, phase 7's checks, and its encoder shown
    bidirectional on the card; (b) the Server on the VLM config with the
    serve CLI's vision stub, clean and rs over 8 hosts through two kills,
    tokens bit-equal and the restored cross-attention cache byte-equal to
    the clean run's; (c) ``compressed_psum`` of a gradient leaf of (a)
    through B5a. Returns the kernels' launch counts over the phase and each
    part's numbers."""
    from repro_torch.core.checkpoint import EngineConfig
    from repro_torch.kernels import ops

    enc_cfg, vlm_cfg = encoder_vlm_configs()
    log(f"encoder/vlm: {enc_cfg.name} at {enc_cfg.num_layers} of 48 layers and {vlm_cfg.name} at "
        f"{vlm_cfg.num_layers} of 100, width kept (HUBERT_LAYERS, VLM_LAYERS: for the run's time)")
    out, counts, grads = {}, {}, {}

    def add(c: dict) -> None:
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    t0 = time.perf_counter()
    run, c = trainer_path(enc_cfg, "sync", engine=EngineConfig(**HUBERT_ENGINE), train=ZOO_TRAIN,
                          label="encoder trainer", probe=encoder_probe(grads))
    run.update(b4_launches=c["gf256_matmul_dyn"], phase_s=time.perf_counter() - t0)
    log("encoder trainer: " + json.dumps(run))
    check(run["b4_launches"] > 0, "encoder trainer: B4 was launched no time")
    out["trainer"] = run
    add(c)
    t0 = time.perf_counter()
    out["psum"] = dict(**psum_run(grads.pop("leaf")), phase_s=time.perf_counter() - t0)
    log("compressed_psum: " + json.dumps(out["psum"]))
    add(ops.launch_counts())
    t0 = time.perf_counter()
    c, served = serve_path(vlm_cfg, VLM_RUNS, kernels=("gf256_matmul_dyn",), label="vlm serve", extra=vision_stub)
    out["vlm serve"] = dict(runs=served, phase_s=time.perf_counter() - t0)
    add(c)
    r = out["trainer"]
    log(f"encoder trainer ({enc_cfg.name}): {r['n_params']} params, setup {r['setup_s']:.2f} s, creates "
        + json.dumps([round(x["create_s"], 4) for x in r["checkpoints"]])
        + f" s, restore {r['restore']['restore_s']:.3f} s, step median "
        f"{statistics.median(r['step_s']) * 1e3:.1f} ms, card peak {r['peak_device_gb']:.2f} GB, host peak "
        f"{r['host_peak_rss_gib']:.2f} GiB, B4 launches {r['b4_launches']}, first-position change "
        f"{r['probe']['first_position_max_abs_change']:.4g}")
    for r in out["vlm serve"]["runs"]:
        log(f"vlm serve {r['name']}: prefill {r['prefill_s']:.2f} s, creates "
            + json.dumps([round(x["create_s"], 4) for x in r["checkpoints"]])
            + " s, restores " + json.dumps([round(x["recover_s"], 4) for x in r["recoveries"]])
            + f" s, decode median {r['step_ms_median']:.2f} ms, p99 {r['step_ms_p99']:.2f} ms, card peak "
            f"{r['peak_device_gb']:.2f} GB, host peak {r['host_peak_rss_gib']:.2f} GiB, "
            f"B4 launches {r['b4_launches']}")
    return counts, out


# ---------------------------------------------------------------------------
# phase 13: the paper's phase-field application (examples/phase_field_stencil_torch.py)
# ---------------------------------------------------------------------------

# one f32 field of 8192 x 8192 cells (268 MB), 8 hosts of 1024-row blocks
# (33.5 MB each): a per-GPU size of a 2-D stencil code. At 16384 x 16384
# (1.074 GB) phase 13 took 50.6 s on an H100 whose host ran the whole script
# in 1263.6 s, past its 1200 s limit; this size takes about a third of that
PF_SHAPE = (8192, 8192)
PF_KILLS = {120: 3, 260: 6}   # the reference's kills, (a)
PF_BURST = (1, 2)             # two hosts of group 0, (b) and (c)
PF_BURST_STEP = 120
PF_KEEP = 150                 # (b) runs to here; (a)'s clean field at this step is kept
PF_RS = dict(codec="rs", parity_group=4, rs_parity=2, gf_backend="torch")
PF_XOR = dict(parity_group=4, gf_backend="torch")
# field passes (reads + writes) of step_field's 18 eager ops: 4 rolls, 3
# adds and 4.0*phi and a subtract for the Laplacian (13 reads, 9 writes);
# 5 ops for the double well (7, 5); 4 ops for the update (6, 4)
PF_EAGER_PASSES = 44


def load_phase_field():
    """``examples/phase_field_stencil_torch.py`` as a module (its pieces run
    under its ``main()``, so importing it runs nothing)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("phase_field_stencil_torch",
                                                  ROOT / "examples" / "phase_field_stencil_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_field_run(pf, label: str, kill_at: dict, cfg, steps: int, keep: dict | None = None) -> dict:
    """One ``pf.run`` on a fresh PF_SHAPE field on the card, recording every
    create's and restore's engine stats and B4's launches in the run up to
    each; ``keep[step]`` receives a copy of the field (on the card) at that
    step of the first pass. Returns the run's numbers (the window offset at
    its last event, B4's launches over it) and its final field (or the
    ``DataLostError`` that ended it) under "field" / "error"."""
    import torch

    from repro_torch.core.distribution import DataLostError
    from repro_torch.kernels import ops

    creates, restores, seen, offset = [], [], set(), [None]
    b4 = lambda: ops.launch_counts()["gf256_matmul_dyn"] - b4_start  # noqa: E731

    def observe(event, sim, engine):
        offset[0] = sim.window_offset
        if event == "step" and keep is not None and sim.step in keep and sim.step not in seen:
            seen.add(sim.step)
            keep[sim.step] = sim.phi.clone()
        elif event == "checkpoint":
            creates.append(dict(step=sim.step, **create_line(engine.stats), b4=b4()))
        elif event == "restore":
            restores.append(dict(step=sim.step, **restore_line(engine.stats), b4=b4()))

    sampler = rss_sampler()
    torch.cuda.reset_peak_memory_stats()
    b4_start = ops.launch_counts()["gf256_matmul_dyn"]
    t0 = time.perf_counter()
    out = dict(label=label, kills={str(k): v for k, v in kill_at.items()}, steps=steps)
    try:
        field, step, recoveries = pf.run(kill_at, cfg=cfg, steps=steps, shape=PF_SHAPE, device="cuda",
                                         observe=observe)
        torch.cuda.synchronize()
        out.update(field=field, step=step, recoveries=recoveries, error=None)
    except DataLostError as e:  # (c) expects it; the caller checks every run's
        out.update(field=None, step=None, recoveries=None, error=e)
    out.update(run_s=time.perf_counter() - t0, creates=creates, restores=restores, window_offset=offset[0],
               b4_launches=b4(), peak_device_gb=torch.cuda.max_memory_allocated() / 1e9, host_peak_rss_gib=sampler())
    return out


def phase_field_path() -> tuple[dict, dict]:
    """Phase 13: the paper's phase-field application at PF_SHAPE on the
    card under deterministic algorithms. The stencil timed; (a) the
    reference's drill under ``EngineConfig()``: a clean run and one with
    host 3 killed at step 120 and host 6 at step 260, the final fields
    bit-equal, 2 recoveries, the window offset at 24; (b) rs 4+2 on B4 to
    step PF_KEEP through the burst of PF_BURST at step 120, bit-equal to
    (a)'s clean field there, B4 launched in the encodes and the decode; (c)
    xor over groups of 4 on B4 to step 50, one create, the burst: the
    restore raises ``DataLostError``, B4 launched in the encode. Returns the
    kernels' launch counts over the phase and the numbers."""
    import torch

    from repro_torch.core.checkpoint import EngineConfig
    from repro_torch.core.distribution import DataLostError
    from repro_torch.kernels import ops

    pf = load_phase_field()
    cells = math.prod(PF_SHAPE)
    field_bytes = cells * 4
    log(f"phase field: {PF_SHAPE[0]} x {PF_SHAPE[1]} f32 ({field_bytes / 1e9:.3f} GB) over {pf.N_HOSTS} hosts "
        f"of {PF_SHAPE[0] // pf.N_HOSTS} rows ({field_bytes / pf.N_HOSTS / 1e6:.1f} MB each); host RAM "
        f"{host_free_gib():.1f} GiB free")
    torch.use_deterministic_algorithms(True)
    ops.reset_launch_counts()  # this path's counts start here
    out = {}
    try:
        t0 = time.perf_counter()
        sim = pf.PhaseFieldEntity(PF_SHAPE, "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        check(tuple(sim.phi.shape) == PF_SHAPE and bool(torch.isfinite(sim.phi).all()),
              f"phase field: the initial field is {tuple(sim.phi.shape)} or not finite")
        step_ms = time_ms(lambda: pf.step_field(sim.phi), reps=10, warmup=2)
        del sim
        out["stencil"] = dict(
            init_s=init_s, step_ms=step_ms,
            floor_ms=2 * field_bytes / HBM_BYTES_PER_S * 1e3,
            eager_floor_ms=PF_EAGER_PASSES * field_bytes / HBM_BYTES_PER_S * 1e3)
        log("phase field stencil: " + json.dumps(out["stencil"]))

        keep = {PF_KEEP: None}
        clean = phase_field_run(pf, "clean", {}, EngineConfig(), pf.STEPS, keep=keep)
        faulty = phase_field_run(pf, "faulty", PF_KILLS, EngineConfig(), pf.STEPS)
        for r in (clean, faulty):
            check(r["error"] is None, f"phase field {r['label']}: {r['error']!r}")
            check(r["step"] == pf.STEPS, f"phase field {r['label']}: ended at step {r['step']}")
        ref, got = clean.pop("field"), faulty.pop("field")
        check(bool(torch.isfinite(ref).all()), "phase field: the clean field is not finite")
        check(torch.equal(ref, got), "phase field: the faulty run's final field differs from the clean run's")
        check(faulty["recoveries"] == len(PF_KILLS) and clean["recoveries"] == 0,
              f"phase field: {faulty['recoveries']} recoveries, want {len(PF_KILLS)}")
        offset = pf.STEPS // pf.WINDOW_SHIFT_EVERY * pf.WINDOW_ROWS
        check(clean["window_offset"] == faulty["window_offset"] == offset,
              f"phase field: window offsets {clean['window_offset']}, {faulty['window_offset']}, want {offset}")
        check([c["step"] for c in faulty["creates"]] == list(range(pf.CKPT_EVERY, pf.STEPS + 1, pf.CKPT_EVERY)),
              f"phase field: faulty run's creates at {[c['step'] for c in faulty['creates']]}")
        clean.update(field_min=float(ref.min()), field_max=float(ref.max()),
                     field_mean=float(ref.double().mean()))
        del ref, got
        check(keep[PF_KEEP] is not None, f"phase field: the clean field at step {PF_KEEP} was not kept")

        burst = phase_field_run(pf, "rs burst", {PF_BURST_STEP: PF_BURST}, EngineConfig(**PF_RS), PF_KEEP)
        check(burst["error"] is None, f"phase field rs burst: {burst['error']!r}")
        check(burst["recoveries"] == 1 and burst["step"] == PF_KEEP,
              f"phase field rs burst: {burst['recoveries']} recoveries, step {burst['step']}")
        field = burst.pop("field")
        check(torch.equal(field, keep[PF_KEEP]),
              f"phase field rs burst: the field at step {PF_KEEP} differs from the clean run's")
        del field, keep[PF_KEEP]
        before = [c for c in burst["creates"] if c["step"] <= PF_BURST_STEP]
        rest = burst["restores"][0]
        burst.update(encode_b4=before[0]["b4"], decode_b4=rest["b4"] - before[-1]["b4"])
        check(burst["encode_b4"] > 0, "phase field rs burst: B4 was launched no time in the encode")
        check(burst["decode_b4"] > 0, "phase field rs burst: B4 was launched no time in the decode")

        lost = phase_field_run(pf, "xor burst", {pf.CKPT_EVERY: PF_BURST}, EngineConfig(**PF_XOR),
                               pf.CKPT_EVERY + 1)
        lost.pop("field")
        err = lost.pop("error")
        check(isinstance(err, DataLostError), f"phase field xor burst: the restore gave {err!r}, not DataLostError")
        check(len(lost["creates"]) == 1 and lost["creates"][0]["b4"] > 0,
              f"phase field xor burst: creates {lost['creates']} (B4 must launch in the encode)")
        lost["error"] = f"{type(err).__name__}: {err}"
        for r in (clean, faulty, burst):
            r.pop("error")
        out.update(clean=clean, faulty=faulty, rs_burst=burst, xor_burst=lost)
    finally:
        torch.use_deterministic_algorithms(False)
    counts = ops.launch_counts()
    st = out["stencil"]
    log(f"phase field stencil: {st['step_ms']:.3f} ms a step ({PF_SHAPE[0]} x {PF_SHAPE[1]} f32), bytes floor "
        f"{st['floor_ms']:.3f} ms (one read and one write at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), the eager ops' "
        f"{PF_EAGER_PASSES} passes {st['eager_floor_ms']:.3f} ms; "
        f"initial field drawn in {st['init_s']:.2f} s")
    for key in ("clean", "faulty", "rs_burst", "xor_burst"):
        r = out[key]
        cr = [c["create_s"] for c in r["creates"]]
        log(f"phase field {r['label']}: {r['run_s']:.1f} s; creates {json.dumps([round(x, 4) for x in cr])} s "
            f"(first {cr[0]:.3f}, warm {(statistics.median(cr[1:]) if len(cr) > 1 else float('nan')):.3f}), "
            f"{r['creates'][0]['bytes_staged'] / 1e9:.3f} GB staged a create; restores "
            + json.dumps([round(x["restore_s"], 4) for x in r["restores"]])
            + f" s; B4 launches {r['b4_launches']}; "
            f"card peak {r['peak_device_gb']:.2f} GB, host peak {r['host_peak_rss_gib']:.2f} GiB"
            + (f"; {r['error']}" if key == "xor_burst" else ""))
    log("phase field: " + json.dumps(out))
    log(f"phase field launches: {json.dumps(counts)}")
    return counts, out


def main() -> int:
    import gc
    import os

    # before the first cuBLAS call: a fixed workspace makes cuBLAS
    # deterministic, which phase 7's bitwise replay needs
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    log(f"build: {len(_build.KERNELS)} libraries in {build_s:.1f} s (each until done: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in _build.build_seconds.items()) + ")")
    for name, text in logs.items():
        ptxas_summary(name, text)
    kernel_tests_done = kernel_tests_phase()  # phase 2 runs in a child process beside the disassembly
    sass_phase()
    card = gpu_line()
    last, phase_ends = [t_start], {}

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        log(f"{name}: {now - last[0]:.1f} s")
        last[0] = now
        phase_ends[name] = time.time()

    phase_done("phase 1 (build, SASS)")
    kernel_tests_done()
    phase_done("phase 2 (kernel tests, the rest of the wait)")
    _HOST_START[:] = [host_free_gib(), host_rss_gib()]  # once the tests' process has ended
    log(f"host free memory: {_HOST_START[0]:.1f} GiB")
    from repro_torch.configs import get_config
    from repro_torch.core.device_tier import build_snapshot_program
    from repro_torch.launch.steps import init_train_state, train_state_layout
    from repro_torch.sharding.mesh import make_mesh
    from repro_torch.utils.pytree import tree_flatten

    cfg = get_config(ARCH)
    mesh = make_mesh((8, 1), ("data", "model"))
    layout = train_state_layout(cfg, mesh)
    words = build_snapshot_program(mesh, layout.sds, layout.pspecs, codec="rs", parity_group=4).buckets[0].words
    log(f"main path bucket data:float32: (8, {words}) uint32 words")
    kernels = kernel_phase_main(words, torch.Generator(device="cuda").manual_seed(SEED))
    kernels.append(gather_kernel_main(cfg, torch.Generator(device="cuda").manual_seed(SEED)))
    torch.cuda.empty_cache()

    # the GF(2^8) backend probe, once per process, before any path resets
    # the launch counts (the engines' planners seed from its rates)
    from repro_torch.core import gf256

    t0 = time.perf_counter()
    best = gf256.active_backend_name()
    log(f"gf256 probe ({time.perf_counter() - t0:.2f} s): picks {best}; GB/s "
        + json.dumps({k: gf256.probed_gbps(k, float("nan")) for k in gf256.available_backends()}))
    phase_done("phase 3 (kernels at the main path's shapes, the probe)")

    # the trainer first: it needs the most host RAM (two committed
    # generations), and runs before any staged fetch caches pinned blocks.
    # Phase 7c's processes start and run beside phases 7 and 5 (each of its
    # processes ends, freeing its memory, when its run is done); its checks,
    # against phase 7's sync losses among them, come after both
    counts7, sync_loss = {}, []
    mesh7c = start_mesh_trainer(replace(cfg, num_layers=TRAIN_LAYERS))
    feed_mesh_trainer(mesh7c)
    try:
        for mode in ("sync", "async"):
            layers = min(cfg.num_layers, TRAIN_LAYERS if mode == "sync" else TRAIN_ASYNC_LAYERS)
            log(f"trainer ({mode}): {layers} of {cfg.num_layers} layers, width kept (TRAIN_LAYERS, "
                f"TRAIN_ASYNC_LAYERS: for the run's time)")
            run7, counts = trainer_path(replace(cfg, num_layers=layers), mode)
            gc.collect()
            log(f"trainer path ({mode}): " + json.dumps(run7))
            log(f"trainer path ({mode}) launches: {json.dumps(counts)}")
            counts7 = {k: counts7.get(k, 0) + v for k, v in counts.items()}
            sync_loss = run7["loss"] if mode == "sync" else sync_loss
            phase_done(f"phase 7 ({mode})")

        # the engine path first: it needs the most host RAM, and the
        # device-tier path's staged fetches leave pinned host blocks in
        # PyTorch's cache
        counts5, runs5 = engine_path(cfg)
        log(f"engine path launches: {json.dumps(counts5)}")
        gc.collect()
        phase_done("phase 5")
        # phase 7c's (a) and (b) on the same processes, beside phases 8 and 8b
        feed_mesh_zoo(mesh7c, *zoo_configs())
        counts8, runs8 = striped_path(cfg)
        log(f"striped path launches: {json.dumps(counts8)}")
        phase_done("phase 8")
        counts8b, run8b = topology_path(cfg)
        log(f"topology path launches: {json.dumps(counts8b)}")
        phase_done("phase 8b")
        counts7c, run7c = mesh_trainer_path(mesh7c, sync_loss, phase_ends)
    finally:
        mesh7c.stop()
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("phase 7c's wait (the sharded Trainer over processes, after its runs beside earlier phases)")
    # phase 9 runs in a process of its own beside phases 6, 10, 11, 12 and
    # 13 (their host RAM and card memory fit beside its own; 8 and 8b's do
    # not), and is waited for before phase 4. The dry-run CLI counts on one
    # thread in a child process beside phases 12, 13 and 4 (its imports alone
    # take most of a minute on the checkout's filesystem); phase 4b reads its
    # records. Phase 4c's processes start up beside phase 4.
    tier, cli, ranks = start_tier(cfg), None, None
    try:
        counts6, runs6 = elastic_path(cfg)
        log(f"elastic path launches: {json.dumps(counts6)}")
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("phase 6")
        counts10, runs10 = serve_path(cfg)
        log(f"serve path launches: {json.dumps(counts10)}")
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("phase 10")
        counts11, runs11 = zoo_path()
        log(f"zoo path launches: {json.dumps(counts11)}")
        check_mesh_ssm_losses(run7c["ssm"], runs11["trainer"]["loss"])
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("phase 11")
        cli = DryrunCli()
        counts12, runs12 = encoder_vlm_path()
        log(f"encoder/vlm path launches: {json.dumps(counts12)}")
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("phase 12")
        counts13, runs13 = phase_field_path()
        gc.collect()
        torch.cuda.empty_cache()
        phase_done("phase 13")
        counts9, runs9 = tier_wait(tier, phase_ends)
        log(f"tier path launches (its process's): {json.dumps(counts9)}")
        phase_done("phase 9's wait (the storage tiers in their own process, after their run beside earlier "
                   "phases)")
        ranks = start_ranks(cfg)
        t0 = time.perf_counter()
        cfg4 = replace(cfg, num_layers=PHASE4_LAYERS)
        layout4 = train_state_layout(cfg4, mesh)
        state = init_train_state(layout4, mesh, torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        n_params = sum(x.numel() for x in tree_flatten(state["params"])[1])
        state_bytes = sum(x.numel() * x.element_size() for x in tree_flatten(state)[1])
        log(f"main: {ARCH} state at {PHASE4_LAYERS} of {cfg.num_layers} layers (PHASE4_LAYERS), {n_params} params, "
            f"{state_bytes / 1e9:.3f} GB on the card ({time.perf_counter() - t0:.1f} s to make)")
        counts4, runs4 = device_tier_path(state, layout4, mesh)
        log(f"device-tier path launches: {json.dumps(counts4)}")
        phase_done("phase 4")
        dryrun_path(cfg4, state, layout4, mesh, runs4, cli)
        phase_done("phase 4b (the dry run's accounting)")
        del state  # phase 4's
        gc.collect()
        torch.cuda.empty_cache()
        free_pinned_cache()
        counts4c, runs4c = rank_path(cfg, ranks)
    finally:
        tier.stop()
        if cli is not None:
            cli.stop()
        if ranks is not None:
            ranks.stop()
    phase_done("phase 4c (the device tier over processes)")
    for k in kernels:
        k["launches"] = sum(c.get(k["name"], 0) for c in (counts4, counts4c, counts5, counts6, counts7, counts7c,
                                                          counts8, counts8b, counts9, counts10, counts11, counts12,
                                                          counts13))
        k["route"] = "cuda"
        check(k["launches"] > 0, f"kernel {k['name']} was launched no time on the main paths")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
