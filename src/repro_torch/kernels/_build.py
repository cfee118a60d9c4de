"""Build and bind the CUDA kernels: ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own (all started together) into
``build/kernels/lib<name>-<hash>.so`` at the repository root, at first use.
The GF(2^8) sources (``PARTS``) compile as several objects at once, one
holding the C entry point and each of the others a share of the 128
(K, M) instantiations (``-DGF_PART=p``, see ``csrc/gf256.cuh``), then link.
The hash covers the source, every shared header (``csrc/*.cuh``) and the
flags, so a stale library never loads. No
source includes PyTorch's headers: tensors cross as ``data_ptr()`` integers
and the stream as ``torch.cuda.current_stream().cuda_stream``. Importing this
module builds nothing; a CPU-only process never calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("checksum", "xor_parity", "rs_encode", "rs_decode", "quantize", "reshard")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: libraries built in parts: name -> objects holding instantiations
#: (passed to csrc/gf256.cuh as -DGF_PARTS)
PARTS = {"rs_encode": 4, "rs_decode": 4}
MAX_K = 16  # kMaxK in csrc/common.cuh
MAX_M = 8   # kMaxM

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_U64P = ctypes.POINTER(ctypes.c_uint64)
# call name -> (library, C function, argument types)
_SIGNATURES = {
    "checksum": ("checksum", "repro_checksum", [_P, _I64, _I64, _I64, _P, _P]),
    "xor_parity": ("xor_parity", "repro_xor_reduce", [_U64P, _I, _P, _I64, _P]),
    "rs_encode": ("rs_encode", "repro_rs_encode", [_U64P, _I, _U64P, _I, ctypes.POINTER(ctypes.c_uint32), _I64, _P]),
    "rs_decode": ("rs_decode", "repro_rs_decode", [_U64P, _I, _U64P, _I, _P, _I64, _P]),
    "quantize": ("quantize", "repro_quantize", [_P, _I, _I64, _I64, _P, _P, _P]),
    "dequantize": ("quantize", "repro_dequantize", [_P, _P, _I64, _P, _P]),
    "copy_runs": ("reshard", "repro_copy_runs", [_P, _P, _I64, _I64, _P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each library built here
build_logs: dict[str, str] = {}
#: seconds from the start of its ``build`` call until each library built
#: here was done (the ``nvcc`` runs overlap)
build_seconds: dict[str, float] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(str(PARTS.get(name, 0)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all running at once. Returns ``{name: ptxas report}``;
    raises ``RuntimeError`` with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        base = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC)]
        src = str(CSRC / f"{name}.cu")
        if name in PARTS:
            objs = [tmp.with_name(f"{tmp.name}.{p}.o") for p in ("entry", *range(PARTS[name]))]
            cmds = [[*base, "-c", "-o", str(objs[0]), src]]
            cmds += [[*base, f"-DGF_PARTS={PARTS[name]}", f"-DGF_PART={p}", "-c", "-o", str(o), src]
                     for p, o in enumerate(objs[1:])]
        else:
            objs, cmds = [], [[*base, "-shared", "-o", str(tmp), src]]
        started = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
        procs[name] = (started, objs, tmp, out)
    failed = []
    for name, (started, objs, tmp, out) in procs.items():
        log = "".join(p.communicate()[0] for p in started)
        rc = max(p.returncode for p in started)
        if rc == 0 and objs:
            link = subprocess.run([nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log, rc = log + link.stdout, link.returncode
        for o in objs:
            o.unlink(missing_ok=True)
        build_logs[name] = log
        build_seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exited {rc}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: build_logs.get(n, "") for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built first if
    needed), with every C function it exports bound."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for lib_name, fn_name, argtypes in _SIGNATURES.values():
                if lib_name == name:
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def call(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream; raise if the launch was
    refused (the C function returns ``cudaGetLastError()``)."""
    lib_name, fn_name, _ = _SIGNATURES[name]
    rc = getattr(library(lib_name), fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (status {rc})")


def ptr_array(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_uint64 * len(tensors))(*[t.data_ptr() for t in tensors])


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_rows(rows: Sequence[torch.Tensor], n: int, device: torch.device, what: str, limit: int) -> None:
    """Every row a contiguous (n,) uint32 vector on ``device``; at most
    ``limit`` rows per launch."""
    if not 1 <= len(rows) <= limit:
        raise ValueError(f"{what}: {len(rows)} rows, the kernel takes 1..{limit}")
    for r in rows:
        if r.dtype != torch.uint32 or r.ndim != 1 or r.numel() != n:
            raise ValueError(f"{what}: rows must be ({n},) uint32, got {tuple(r.shape)} {r.dtype}")
        if r.device != device:
            raise ValueError(f"{what}: row on {r.device}, expected {device}")
        if n > 1 and r.stride(0) != 1:
            raise ValueError(f"{what}: rows must be contiguous")


def device_kind(t: torch.Tensor) -> str:
    """'cpu' or 'cuda'; anything else raises (no quiet fallback)."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"unsupported device {t.device}")
