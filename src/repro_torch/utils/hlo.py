"""Post-optimization HLO analysis (carried over from the JAX package's
``utils/hlo.py``, which imports no JAX): the port has no XLA of its own, so
it reads HLO text that an XLA compile saved, as ``launch/reanalyze.py``
does for a dry-run cell that comes with an ``.hlo.gz``.

``compiled.cost_analysis()`` gives FLOPs / bytes-accessed but (a) contains no
collective traffic and (b) counts while-loop bodies ONCE (verified: a
10-iteration scan reports the same flops as one iteration). This module
parses ``compiled.as_text()`` and:

  * sums operand sizes of every collective op, per kind;
  * tracks which computation each op lives in, builds the computation call
    graph, and weights ops reachable from a while body by the trip count
    (``while_trip``, = the scan-over-layers period count for our programs);
  * extracts structural signals for perf iteration (fusions, whiles,
    duplicate-op counts as a remat smell).

Post-opt HLO prints operands without inline types, so a first pass builds a
%name -> bytes table from every defining line.
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

_DTYPE_BYTES = {
    "pred": 1,
    "s4": 1, "u4": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"\b([a-z]+[0-9]+[a-z0-9]*|pred)\[([0-9,]*)\]")
_DEF_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\([^)]*\)|[\w\[\]{},\/ ]+?)\s+([a-z][a-z0-9\-]*)\("
)
# Computation headers are unindented, contain `->`, end with `{`, and may have
# tuple-typed (nested-paren) parameter lists — match loosely on those anchors.
_COMP_NAME_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(")


def _comp_header(line: str) -> str | None:
    if line[:1].isspace() or not line.rstrip().endswith("{"):
        return None
    if "->" not in line or "=" in line.split("->")[0].split("(")[0]:
        return None
    m = _COMP_NAME_RE.match(line.strip())
    return m.group(1) if m else None
_OPERAND_RE = re.compile(r"%([\w.\-]+)")
_CALLED_RE = re.compile(r"(?:to_apply|calls|body|condition)=%?([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")


def shape_bytes(dtype: str, dims_str: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    if not dims_str:
        return _DTYPE_BYTES[dtype]
    dims = [int(d) for d in dims_str.split(",") if d]
    return int(np.prod(dims, dtype=np.int64)) * _DTYPE_BYTES[dtype]


def _type_bytes(type_str: str) -> int:
    return sum(shape_bytes(dt, dims) for dt, dims in _SHAPE_RE.findall(type_str))


@dataclass
class CollectiveStats:
    """Collective traffic summary of one compiled HLO module (per-device view).

    ``bytes_by_kind`` is while-trip weighted (dynamic estimate);
    ``static_bytes_by_kind`` counts each op once.
    """

    bytes_by_kind: dict[str, int] = field(default_factory=dict)
    static_bytes_by_kind: dict[str, int] = field(default_factory=dict)
    count_by_kind: dict[str, int] = field(default_factory=dict)
    n_fusions: int = 0
    n_while: int = 0
    duplicate_ops: int = 0
    while_trip: int = 1

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_static_bytes(self) -> int:
        return sum(self.static_bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def summary(self) -> str:
        parts = [
            f"{k}: n={self.count_by_kind.get(k, 0)} bytes={self.bytes_by_kind.get(k, 0):,}"
            for k in COLLECTIVE_KINDS
            if self.count_by_kind.get(k, 0)
        ]
        return "; ".join(parts) if parts else "no collectives"


_DOT_DIMS_RE = re.compile(
    r"lhs_contracting_dims=\{([0-9,]*)\}"
)
_FIRST_SHAPE_RE = re.compile(r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*([a-z0-9]+)\[([0-9,]*)\]")

# Ops whose output/operand sizes approximate real HBM traffic at the top level
# of a computation (fusion bodies are skipped; the fusion op is atomic).
_TRAFFIC_OPS = {
    "fusion", "dot", "copy", "broadcast", "reshape", "transpose", "reduce",
    "convolution", "dynamic-slice", "dynamic-update-slice", "scatter",
    "gather", "pad", "concatenate", "slice", "select-and-scatter", "iota",
    "add", "multiply", "subtract", "divide", "select", "compare", "exponential",
    "tanh", "rsqrt", "sqrt", "maximum", "minimum", "convert", "negate", "log",
}


def _operand_names(line: str) -> list[str]:
    m = _DEF_RE.match(line)
    if not m:
        return []
    lparen = line.find("(", m.end(3) - 1)
    if lparen < 0:
        return []
    rparen = line.find(")", lparen)
    if rparen < 0:
        rparen = len(line)
    return _OPERAND_RE.findall(line[lparen:rparen])


def analyze_hlo_collectives(hlo_text: str, while_trip: int = 1) -> CollectiveStats:
    sizes: dict[str, int] = {}
    stats = CollectiveStats(while_trip=while_trip)
    names: Counter[str] = Counter()

    current_comp = "<module>"
    comp_of_op: list[tuple[str, str, str, list[str]]] = []  # (kind, opname, comp, operands)
    edges: dict[str, set[str]] = {}
    while_bodies: set[str] = set()

    for raw_line in hlo_text.splitlines():
        line = raw_line.rstrip()
        stripped = line.strip()
        if not stripped or stripped.startswith(("//", "#", "HloModule")):
            continue
        header = _comp_header(line)
        if header is not None:
            current_comp = header
            edges.setdefault(current_comp, set())
            continue
        m = _DEF_RE.match(line)
        if not m:
            continue
        name, type_str, op = m.group(1), m.group(2), m.group(3)
        sizes[name] = _type_bytes(type_str)
        for callee in _CALLED_RE.findall(line):
            edges.setdefault(current_comp, set()).add(callee)
        bm = _BRANCHES_RE.search(line)
        if bm:
            for callee in _OPERAND_RE.findall(bm.group(1)):
                edges.setdefault(current_comp, set()).add(callee)
        if op == "fusion":
            stats.n_fusions += 1
        elif op == "while":
            stats.n_while += 1
            wb = re.search(r"body=%?([\w.\-]+)", line)
            if wb:
                while_bodies.add(wb.group(1))
        kind = None
        for k in COLLECTIVE_KINDS:
            if op == k or op == f"{k}-start":
                kind = k
                break
        if kind is not None:
            comp_of_op.append((kind, name, current_comp, _operand_names(line)))
            names[name.split(".")[0]] += 1

    # Computations reachable from any while body inherit the trip multiplier.
    in_loop: set[str] = set()
    frontier = list(while_bodies)
    while frontier:
        c = frontier.pop()
        if c in in_loop:
            continue
        in_loop.add(c)
        frontier.extend(edges.get(c, ()))

    for kind, name, comp, operands in comp_of_op:
        stats.count_by_kind[kind] = stats.count_by_kind.get(kind, 0) + 1
        nbytes = sum(sizes.get(o, 0) for o in operands)
        if nbytes == 0:
            nbytes = sizes.get(name, 0)
        stats.static_bytes_by_kind[kind] = stats.static_bytes_by_kind.get(kind, 0) + nbytes
        mult = while_trip if comp in in_loop else 1
        stats.bytes_by_kind[kind] = stats.bytes_by_kind.get(kind, 0) + nbytes * mult
    stats.duplicate_ops = sum(c - 1 for c in names.values() if c > 1)
    return stats


@dataclass
class HloCostEstimate:
    """Trip-weighted FLOP / HBM-traffic estimate from the optimized HLO.

    XLA's cost_analysis counts while bodies once; this estimator re-derives
    dot FLOPs (exact: output elems x contraction size) and approximate HBM
    traffic (operand+output bytes of top-level ops, fusions atomic), each
    weighted by the while trip count for ops inside loop bodies.
    """

    flops_weighted: float = 0.0
    flops_static: float = 0.0
    traffic_bytes_weighted: float = 0.0
    traffic_bytes_static: float = 0.0
    n_dots: int = 0


def estimate_hlo_costs(hlo_text: str, while_trip: int = 1) -> HloCostEstimate:
    shapes: dict[str, tuple[str, list[int]]] = {}
    sizes: dict[str, int] = {}
    est = HloCostEstimate()

    current_comp = "<module>"
    edges: dict[str, set[str]] = {}
    while_bodies: set[str] = set()
    inlined: set[str] = set()  # fusion/reduce bodies: not real traffic
    ops: list[tuple[str, str, str, list[str], str]] = []  # op, name, comp, operands, line

    for raw_line in hlo_text.splitlines():
        line = raw_line.rstrip()
        stripped = line.strip()
        if not stripped or stripped.startswith(("//", "#", "HloModule")):
            continue
        header = _comp_header(line)
        if header is not None:
            current_comp = header
            edges.setdefault(current_comp, set())
            continue
        m = _DEF_RE.match(line)
        if not m:
            continue
        name, type_str, op = m.group(1), m.group(2), m.group(3)
        sizes[name] = _type_bytes(type_str)
        fs = _SHAPE_RE.search(type_str)
        if fs:
            dims = [int(d) for d in fs.group(2).split(",") if d]
            shapes[name] = (fs.group(1), dims)
        for callee in _CALLED_RE.findall(line):
            edges.setdefault(current_comp, set()).add(callee)
            if op in ("fusion", "reduce", "sort", "scatter", "map", "reduce-window", "select-and-scatter"):
                inlined.add(callee)
        if op == "while":
            wb = re.search(r"body=%?([\w.\-]+)", line)
            if wb:
                while_bodies.add(wb.group(1))
        ops.append((op, name, current_comp, _operand_names(line), line))

    in_loop: set[str] = set()
    frontier = list(while_bodies)
    while frontier:
        c = frontier.pop()
        if c in in_loop:
            continue
        in_loop.add(c)
        frontier.extend(edges.get(c, ()))

    # Computations transitively inlined (fusion bodies and their callees).
    all_inlined: set[str] = set()
    frontier = list(inlined)
    while frontier:
        c = frontier.pop()
        if c in all_inlined:
            continue
        all_inlined.add(c)
        frontier.extend(edges.get(c, ()))

    for op, name, comp, operands, line in ops:
        if comp in all_inlined:
            continue
        w = while_trip if comp in in_loop else 1
        if op == "dot":
            lhs = operands[0] if operands else None
            if lhs in shapes:
                _, lhs_dims = shapes[lhs]
                mdims = _DOT_DIMS_RE.search(line)
                contracting = (
                    [int(d) for d in mdims.group(1).split(",") if d] if mdims else []
                )
                k = 1
                for d in contracting:
                    if d < len(lhs_dims):
                        k *= lhs_dims[d]
                out_elems = 1
                if name in shapes:
                    for d in shapes[name][1]:
                        out_elems *= d
                flops = 2.0 * out_elems * k
                est.flops_static += flops
                est.flops_weighted += flops * w
                est.n_dots += 1
        if op in _TRAFFIC_OPS:
            traffic = sizes.get(name, 0) + sum(sizes.get(o, 0) for o in operands)
            est.traffic_bytes_static += traffic
            est.traffic_bytes_weighted += traffic * w
    return est
