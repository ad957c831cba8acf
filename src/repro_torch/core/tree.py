"""Nested parameter trees: dicts (keys in sorted order, as ``jax.tree``
flattens them) and lists of tensors, the port's counterpart of the pytree
functions the JAX package calls. A leaf's path is written as
``jax.tree_util.keystr`` writes it: ``['layers'][0]['wq']``."""
from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def leaves_with_paths(tree, prefix: str = ""):
    """[(path, leaf)] in flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, sub in kids:
        out += leaves_with_paths(sub, prefix + key)
    return out


def leaves(tree):
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def unzip(tree, n: int):
    """A tree whose leaves are n-tuples -> n trees."""
    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        if isinstance(t, list):
            return [pick(v, i) for v in t]
        return t[i]
    return tuple(pick(tree, i) for i in range(n))


def unflatten(tree, flat):
    """A tree shaped like ``tree`` whose leaves are ``flat``, taken in the
    order of ``leaves(tree)``."""
    it = iter(flat)

    def build(t):
        kids = _children(t)
        if kids is None:
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return type(t)(build(v) for v in t)
    return build(tree)
