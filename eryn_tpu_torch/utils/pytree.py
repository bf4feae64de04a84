"""Flattening of nested tuples, lists and dicts (a move's kernel state).

The port's counterpart of the ``jax.tree_util`` calls :mod:`eryn_tpu` makes
on kernel states: dicts are walked in sorted key order, as JAX walks them,
and anything else is a leaf.
"""

from __future__ import annotations

__all__ = ["tree_flatten", "tree_unflatten"]


def tree_flatten(tree):
    """``(leaves, spec)``: the leaves of ``tree`` in order, and what
    :func:`tree_unflatten` needs to rebuild it."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([x for leaves, _ in parts for x in leaves],
                (dict, keys, [spec for _, spec in parts]))
    if isinstance(tree, (tuple, list)):
        parts = [tree_flatten(x) for x in tree]
        return ([x for leaves, _ in parts for x in leaves],
                (type(tree), None, [spec for _, spec in parts]))
    return [tree], None


def tree_unflatten(spec, leaves):
    """The tree of structure ``spec`` holding ``leaves`` in order."""
    it = iter(leaves)
    out = _build(spec, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the structure holds")
    return out


def _build(spec, it):
    if spec is None:
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the structure holds") from None
    kind, keys, children = spec
    items = [_build(child, it) for child in children]
    if kind is dict:
        return dict(zip(keys, items))
    if hasattr(kind, "_fields"):  # a NamedTuple
        return kind(*items)
    return kind(items)
