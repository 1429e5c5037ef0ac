"""Parameter and state trees: nested dicts, lists, tuples and NamedTuples
of tensors, walked as the reference's ``jax.tree_util`` walks them.

Leaves come in the reference's order: dict keys sorted, sequences and
NamedTuple fields in order; ``None`` is an empty subtree. A leaf's path
names it as the reference's checkpointer does: dict keys and sequence
indices as they are, NamedTuple fields as ``.field``, joined by ``/``
(``.params/embed/embedding``, ``.opt/.m/stack/slots/0/3/...``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(path part, child) of a node, in the reference's order; [] for a
    leaf or None."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return []


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's order."""
    if tree is None:
        return
    if not _is_node(tree):
        yield prefix, tree
        return
    for part, child in _children(tree):
        yield from items(child, f"{prefix}/{part}" if prefix else part)


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in items(tree)]


def flatten(tree) -> Dict[str, Any]:
    """{path: leaf}, as the reference's checkpointer flattens a tree."""
    return dict(items(tree))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest`` (of
    the same structure), in a tree of that structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, c, *(r[i] for r in rest))
                            for i, c in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, c, *(r[i] for r in rest))
                          for i, c in enumerate(tree))
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves, in a tree of the same structure."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(prefix, tree)

    def sub(part, child):
        return map_with_path(fn, child, f"{prefix}/{part}" if prefix
                             else part)

    if isinstance(tree, dict):
        return {k: sub(str(k), tree[k]) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(sub(f".{f}", getattr(tree, f))
                            for f in tree._fields))
    return type(tree)(sub(str(i), c) for i, c in enumerate(tree))
