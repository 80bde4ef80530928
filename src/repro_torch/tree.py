"""The port's parameter and optimizer-state trees: nested dicts of tensors,
with ``NamedTuple``s (``OptState``) and lists or tuples inside them.

``flatten`` walks a tree in the order and with the key paths that JAX's
``tree_flatten_with_path`` gives for the same tree, as the JAX package's
checkpoint format joins them: dict keys sorted, a ``NamedTuple`` field as
``.name``, a list or tuple item by its index; ``None`` holds no leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _items(tree):
    """(key, child) of a node in JAX's order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten(tree) -> List[Tuple[str, Any]]:
    """[(path joined with '/', leaf)] in JAX's leaf order."""
    return list(_walk(tree, ""))


def _walk(tree, prefix: str) -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    items = _items(tree)
    if items is None:
        yield prefix, tree
        return
    for key, child in items:
        yield from _walk(child, f"{prefix}/{key}" if prefix else key)


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(template, new_leaves) -> Any:
    """A tree of ``template``'s structure holding ``new_leaves`` in
    ``flatten``'s order."""
    it = iter(new_leaves)
    out = _rebuild(template, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _rebuild(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: built[k] for k in tree}        # the template's key order
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the template holds") from None


def tree_map(fn: Callable, tree) -> Any:
    """``fn`` over the leaves of ``tree``, in a tree of its structure."""
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])
