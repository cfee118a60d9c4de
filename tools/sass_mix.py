#!/usr/bin/env python3
"""Instruction mix of the port's CUDA kernels, read from their compiled SASS.

Run from the repository root on a machine with the CUDA toolkit:
``python3 tools/sass_mix.py [outdir]`` (default ``chiprun_out/sass``). It
builds the kernels if needed (``repro_torch.kernels._build``), disassembles
each library with ``cuobjdump -sass``, writes the listing to
``<outdir>/<name>.sass``, and prints for every kernel function the count of
each opcode over the whole function and over each loop body (the
instructions from a backward branch's target up to the branch). A loop's
counts are static: a forward branch inside it (a ``j < m`` test) still
counts the instructions it skips.

``gf_word_mix`` (used by ``chip_smoke.py``) reads one (K, M) instantiation
of the GF(2^8) kernels and gives the instructions its grid-stride loops
issue per uint32 word of each row, sorted by pipe.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_LABEL_REF = re.compile(r"\.L_x_\d+")
_HEX = re.compile(r"\b0x[0-9a-f]+\b")


def opcode(text: str) -> str:
    """``@!P0 LOP3.LUT R1, ...`` -> ``LOP3``."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def parse(sass: str) -> dict[str, list[tuple[int, str]]]:
    """{function: [(address, instruction text)]}, with labels resolved to
    the address of the instruction that follows them under key ``:label``."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur, pending = None, []
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            funcs[cur] = []
            continue
        if cur is None:
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = _INSN.search(line)
        if ins:
            addr = int(ins.group(1), 16)
            for name in pending:
                funcs[cur].append((addr, f":{name}"))
            pending = []
            funcs[cur].append((addr, ins.group(2)))
    return funcs


def loops(body: list[tuple[int, str]]) -> list[tuple[int, int]]:
    """(start, end) address of every backward branch's loop body."""
    labels = {t[1:]: a for a, t in body if t.startswith(":")}
    out = []
    for addr, text in body:
        if text.startswith(":") or opcode(text) != "BRA":
            continue
        lab, hexa = _LABEL_REF.search(text), _HEX.search(text)
        target = labels.get(lab.group(0)) if lab else int(hexa.group(0), 16) if hexa else None
        if target is not None and target <= addr:
            out.append((target, addr))
    return out


def mix(body, lo: int = -1, hi: int = 1 << 62) -> Counter:
    return Counter(opcode(t) for a, t in body if not t.startswith(":") and lo <= a <= hi)


# Hopper issue pipes by opcode (CUDA C++ Programming Guide, arithmetic
# instruction throughput for compute capability 9.0: 64 results per clock
# per SM for 32-bit integer multiply-add on the FMA pipe, and for 32-bit
# logical, shift and add on the integer ALU pipe)
FMA_PIPE = {"IMAD", "IMUL", "FFMA", "FMUL", "FADD", "HFMA2", "HMUL2", "HADD2", "IDP"}
CONTROL = {"BRA", "EXIT", "BAR", "BSSY", "BSYNC", "NOP", "CALL", "RET", "WARPSYNC", "YIELD", "S2R", "S2UR",
           "CS2R", "DEPBAR", "MEMBAR", "CCTL", "VOTE", "VOTEU", "R2UR", "ERRBAR"}


def pipes(c: Counter) -> dict[str, int]:
    """Opcode counts -> counts per pipe: ``alu`` (LOP3, SHF, IADD3, LEA,
    ISETP, SEL, PRMT, MOV, ...), ``fma`` (IMAD and its MOV/SHL/HI/WIDE
    forms, float arithmetic), ``uniform`` (the U* uniform datapath),
    ``load``, ``store``, ``control``."""
    out = dict.fromkeys(("alu", "fma", "uniform", "load", "store", "control"), 0)
    for op, n in c.items():
        if op in FMA_PIPE:
            key = "fma"
        elif op in CONTROL:
            key = "control"
        elif op.startswith("LD"):
            key = "load"
        elif op.startswith(("ST", "RED", "ATOM")):
            key = "store"
        elif op.startswith("U"):
            key = "uniform"
        else:
            key = "alu"
        out[key] += n
    return out


def blocks(body, lo: int, hi: int) -> list[list[str]]:
    """The instructions of [lo, hi] cut into basic blocks: a new block at
    every label and after every branch."""
    out: list[list[str]] = [[]]
    for a, t in body:
        if not lo <= a <= hi:
            continue
        if t.startswith(":"):
            out.append([])
            continue
        out[-1].append(t)
        if opcode(t) == "BRA":
            out.append([])
    return [b for b in out if b]


def gf_word_mix(sass: str, k: int, m: int) -> dict[str, float]:
    """Per-word pipe counts of the (k, m) instantiation's grid-stride loop
    in the SASS of ``rs_encode`` or ``rs_decode``, on the path of a whole
    aligned quad of words: the blocks that load or store plain 4-byte words
    (the ragged tail and unaligned rows) are left out. An iteration covers
    4 words of each row: 4 x its 16-byte loads / k."""
    tag = f"ILi{k}ELi{m}E"
    funcs = [body for name, body in parse(sass).items() if tag in name]
    if len(funcs) != 1:
        raise ValueError(f"{len(funcs)} kernels match {tag}")
    body = funcs[0]
    vec = []
    for lo, hi in loops(body):
        kept = [t for b in blocks(body, lo, hi)
                if not any(opcode(t) in ("LDG", "STG") and ".128" not in t for t in b) for t in b]
        wide_loads = sum(1 for t in kept if opcode(t) == "LDG")
        if wide_loads:
            c = Counter(opcode(t) for t in kept)
            words = 4 * wide_loads / k
            vec.append({key: v / words for key, v in pipes(c).items()})
    if len(vec) != 1:
        raise ValueError(f"{tag}: {len(vec)} loops with 16-byte loads, expected 1")
    return vec[0]


def fmt(c: Counter) -> str:
    return f"{sum(c.values())} insns: " + ", ".join(f"{k} {v}" for k, v in c.most_common())


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    outdir = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "chiprun_out" / "sass"
    outdir.mkdir(parents=True, exist_ok=True)
    _build.build()
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    for name in _build.KERNELS:
        sass = subprocess.run([cuobjdump, "-sass", str(_build.lib_path(name))],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        (outdir / f"{name}.sass").write_text(sass)
        for func, body in parse(sass).items():
            print(f"{name} {func}: {fmt(mix(body))}")
            for lo, hi in loops(body):
                print(f"  loop {lo:#06x}-{hi:#06x}: {fmt(mix(body, lo, hi))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
