"""Nested-dict trees of state leaves (the port's counterpart of the
``jax.tree`` calls in ``repro``).

State and specs are nested dicts whose non-dict values are leaves.
``tree_flatten`` and ``tree_leaves`` walk dict keys in sorted order, as
``jax.tree.flatten`` does: bucket leaf indices, word offsets and the
checksum mix all depend on that order (``torch.utils._pytree`` keeps
insertion order instead). Below them, the reference's sizing, comparison
and casting helpers on such trees.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

Path = tuple[str, ...]


def tree_flatten(tree: Any) -> tuple[list[Path], list[Any]]:
    """(paths, leaves) of a nested dict, keys sorted at every level."""
    paths: list[Path] = []
    leaves: list[Any] = []
    _walk(tree, (), paths, leaves)
    return paths, leaves


def _walk(node: Any, path: Path, paths: list[Path], leaves: list[Any]) -> None:
    # A module-level function, not a closure that calls itself: such a
    # closure is a reference cycle holding ``leaves``, so every flattened
    # tensor (gigabytes of card memory) would live until the cyclic garbage
    # collector happened to run.
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (k,), paths, leaves)
    else:
        paths.append(path)
        leaves.append(node)


def tree_leaves(tree: Any) -> list[Any]:
    return tree_flatten(tree)[1]


def tree_unflatten(paths: list[Path], leaves: list[Any]) -> Any:
    """The nested dict with ``leaves`` at ``paths`` (inverse of
    :func:`tree_flatten`)."""
    if paths == [()]:
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """The same nested dict with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# The reference's sizing, comparison and casting helpers (repro/utils/pytree.py)
# ---------------------------------------------------------------------------

def flatten_with_names(tree: Any) -> list[tuple[str, Any]]:
    """(dotted path, leaf) pairs in sorted-key order: the names of
    checkpoint blocks (the root leaf of a bare tensor is named ``""``)."""
    paths, leaves = tree_flatten(tree)
    return [(".".join(str(k) for k in p), leaf) for p, leaf in zip(paths, leaves)]


def tree_map_with_names(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """Map ``fn(name, leaf)`` over a tree, keeping its structure."""
    paths, leaves = tree_flatten(tree)
    return tree_unflatten(paths, [fn(".".join(str(k) for k in p), leaf) for p, leaf in zip(paths, leaves)])


def _leaf_bytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if hasattr(x, "nbytes"):
        return int(x.nbytes)
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return math.prod(int(s) for s in x.shape) * x.dtype.itemsize
    return 0


def tree_bytes(tree: Any) -> int:
    """Total bytes of all array leaves (global, before sharding)."""
    return sum(_leaf_bytes(x) for x in tree_leaves(tree))


def tree_num_params(tree: Any) -> int:
    """Total element count of all array leaves."""
    return sum(math.prod(int(s) for s in x.shape) for x in tree_leaves(tree) if hasattr(x, "shape"))


def _wide(x: Any) -> torch.Tensor:
    """A leaf's values as float64 (for a comparison within a tolerance)."""
    return torch.as_tensor(x).to(torch.float64)


def tree_allclose(a: Any, b: Any, rtol: float = 1e-6, atol: float = 1e-6) -> bool:
    """``np.allclose`` leaf by leaf, after casting both sides to float64."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    return all(torch.allclose(_wide(x), _wide(y), rtol=rtol, atol=atol) for x, y in zip(la, lb))


def tree_equal(a: Any, b: Any) -> bool:
    """Equality of two trees, leaf by leaf: the same shape and dtype, equal
    values, NaN equal to NaN (the recovery-continuation check)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        same = x == y
        if x.is_floating_point():
            same |= x.isnan() & y.isnan()
        if not bool(same.all()):
            return False
    return True


def tree_zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def tree_cast(tree: Any, dtype: torch.dtype) -> Any:
    """Cast floating leaves to ``dtype``; leave integer leaves untouched."""
    return tree_map(lambda x: x.to(dtype) if torch.as_tensor(x).is_floating_point() else x, tree)
