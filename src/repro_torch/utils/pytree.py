"""Nested-dict trees of state leaves (the port's counterpart of the
``jax.tree`` calls in ``repro``).

State and specs are nested dicts whose non-dict values are leaves.
``tree_flatten`` and ``tree_leaves`` walk dict keys in sorted order, as
``jax.tree.flatten`` does: bucket leaf indices, word offsets and the
checksum mix all depend on that order (``torch.utils._pytree`` keeps
insertion order instead).
"""

from __future__ import annotations

from typing import Any, Callable

Path = tuple[str, ...]


def tree_flatten(tree: Any) -> tuple[list[Path], list[Any]]:
    """(paths, leaves) of a nested dict, keys sorted at every level."""
    paths: list[Path] = []
    leaves: list[Any] = []

    def walk(node: Any, path: Path) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            paths.append(path)
            leaves.append(node)

    walk(tree, ())
    return paths, leaves


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
