"""Trees of tensors in JAX's leaf order: the port's stand-in for
``jax.tree``, beneath both the models and the training path.  Their
trees are nested dicts, lists, tuples and NamedTuples
(``train.optimizer.AdamWState``) of tensors, and ``None`` as an empty
subtree.  ``flatten`` lists the leaves in the order
``jax.tree.flatten`` does: dict keys sorted, sequences and NamedTuple
fields in order.  A checkpoint's ``leaf_<i>`` is the i-th leaf in that
order, so each package reads the other's checkpoints, and ``str`` of a
``TreeDef`` is ``str`` of JAX's ``PyTreeDef`` of the same tree.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple


class TreeDef(NamedTuple):
    """A tree's structure: ``kind`` is "leaf", "none", "dict", "list",
    "tuple" or "named"; ``meta`` the sorted keys or the NamedTuple type;
    ``children`` the sub-structures in leaf order."""
    kind: str
    meta: Any = None
    children: tuple = ()

    def __str__(self) -> str:
        return f"PyTreeDef({_repr(self)})"


LEAF = TreeDef("leaf")


def _is_named(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _walk(t, leaves: list) -> TreeDef:
    if t is None:
        return TreeDef("none")
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return TreeDef("dict", keys, tuple(_walk(t[k], leaves) for k in keys))
    if _is_named(t):
        return TreeDef("named", type(t), tuple(_walk(x, leaves) for x in t))
    if isinstance(t, (list, tuple)):
        return TreeDef(type(t).__name__, None,
                       tuple(_walk(x, leaves) for x in t))
    leaves.append(t)
    return LEAF


def flatten(tree) -> tuple[list, TreeDef]:
    """(leaves in JAX's order, structure)."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def leaves(tree) -> list:
    return flatten(tree)[0]


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` holding ``leaves`` (in flatten's order)."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        kids = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.meta, kids))
        if td.kind == "named":
            return td.meta(*kids)
        return list(kids) if td.kind == "list" else tuple(kids)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map(fn: Callable, tree, *rest) -> Any:            # noqa: A001
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (of the same structure), as ``jax.tree.map``."""
    flat, td = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(td, [fn(*xs) for xs in zip(flat, *others)])


def _repr(td: TreeDef) -> str:
    if td.kind == "leaf":
        return "*"
    if td.kind == "none":
        return "None"
    kids = [_repr(c) for c in td.children]
    if td.kind == "dict":
        return "{" + ", ".join(f"{k!r}: {v}" for k, v in zip(td.meta, kids)) \
            + "}"
    if td.kind == "named":
        return (f"CustomNode(namedtuple[{td.meta.__name__}], "
                f"[{', '.join(kids)}])")
    if td.kind == "list":
        return "[" + ", ".join(kids) + "]"
    return "(" + ", ".join(kids) + (",)" if len(kids) == 1 else ")")
