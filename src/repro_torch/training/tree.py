"""Trees of tensors, as the training code walks them.

What ``jax.tree`` does for the reference: a tree is nested dicts, lists
and tuples (named tuples such as ``TrainState`` and ``Q8Tensor`` included);
anything else is a leaf. Dicts are walked in insertion order, so the
parameter trees of ``models.transformer`` flatten in the order of its own
``_leaves``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[str, ...]


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if hasattr(tree, "_fields"):                   # a named tuple
        return list(zip(tree._fields, tree))
    return [(str(i), v) for i, v in enumerate(tree)]


def _rebuild(tree, values: List[Any]):
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), values))
    if hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten_with_paths(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) for every leaf, in the tree's order."""
    if not _is_node(tree):
        return [(path, tree)]
    out: List[Tuple[Path, Any]] = []
    for key, child in _children(tree):
        out += flatten_with_paths(child, path + (key,))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it: Iterator[Any] = iter(new_leaves)

    def build(node):
        if not _is_node(node):
            return next(it)
        return _rebuild(node, [build(c) for _, c in _children(node)])

    out = build(tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


def map_leaves(fn: Callable, tree) -> Any:
    """``tree``'s structure with ``fn`` of each leaf in its place."""
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])


def leaves_up_to(tree, other) -> List[Any]:
    """``other``'s subtrees at the positions of ``tree``'s leaves (``other``
    has ``tree``'s structure, a subtree where ``tree`` has a leaf: the
    ``Q8Tensor`` moments of a parameter)."""
    if not _is_node(tree):
        return [other]
    out: List[Any] = []
    for (_, a), (_, b) in zip(_children(tree), _children(other),
                              strict=True):
        out += leaves_up_to(a, b)
    return out
