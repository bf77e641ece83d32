"""Parameter and state trees: nested dicts, lists and tuples of tensors,
walked in JAX's flatten order (dict keys sorted, lists and tuples in
order), so that leaf ``i`` here is leaf ``i`` of the reference's tree."""
from __future__ import annotations


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, flat) -> object:
    """A tree shaped like ``like`` holding ``flat`` (in ``leaves`` order)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def map_tree(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("map_tree: trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def treedef_str(tree) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` prints it."""
    def rec(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {rec(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(rec(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(rec(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({rec(tree)})"
