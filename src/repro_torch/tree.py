"""Trees of tensors: the nested dicts, lists and tuples the LM's
parameters and optimizer state are made of.

Leaves come in the reference's order (``jax.tree_util``'s): a dict's
values by sorted key, a list's or tuple's (a ``NamedTuple``'s fields
included) in order.  As there, only a dict, a list, a tuple and a
``NamedTuple`` are nodes: any other object, a subclass of tuple such as
a sharding spec among them, is a leaf.  So the i-th leaf of a port tree
is the i-th leaf of the reference's tree of the same structure, which is
what lets a checkpoint written by one package restore in the other.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _is_sequence(t) -> bool:
    return type(t) in (list, tuple) or _is_namedtuple(t)


def is_node(t) -> bool:
    """Whether ``t`` is a node of a tree (a dict, a list, a tuple or a
    ``NamedTuple``), not a leaf."""
    return isinstance(t, dict) or _is_sequence(t)


def leaves(tree: PyTree) -> List[Any]:
    """The leaves of ``tree`` in the reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if _is_sequence(tree):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def leaves_with_paths(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in ``leaves``' order.  A path joins the keys from
    the root with ``/`` as the reference's ``sharding._path_str`` does: a
    dict's key, a list's or tuple's index, ``.name`` for a
    ``NamedTuple``'s field (``"groups/0/p0/attn/wq"``)."""
    def join(key) -> str:
        return f"{prefix}/{key}" if prefix else str(key)
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_paths(tree[k], join(k))]
    if _is_namedtuple(tree):
        return [x for f, v in zip(tree._fields, tree)
                for x in leaves_with_paths(v, join(f".{f}"))]
    if _is_sequence(tree):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_paths(v, join(i))]
    return [(prefix, tree)]


def unflatten(tree_like: PyTree, new_leaves) -> PyTree:
    """A tree of ``tree_like``'s structure holding ``new_leaves`` (in the
    order ``leaves`` gives), which must be exactly as many."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}          # keep the key order
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if _is_sequence(t):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` (and the same leaves of each tree
    of ``rest``, which have its structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])


def structure(tree: PyTree) -> str:
    """A readable description of the tree's structure, ``*`` a leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={structure(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if type(tree) is list:
        return "[" + ", ".join(structure(v) for v in tree) + "]"
    if type(tree) is tuple:
        return "(" + ", ".join(structure(v) for v in tree) + ")"
    return "*"
