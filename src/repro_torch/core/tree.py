"""Trees of tensors in JAX's leaf order: the port's stand-in for
``jax.tree``, beneath both the models and the training path.  Their
trees are nested dicts, lists, tuples and NamedTuples
(``train.optimizer.AdamWState``) of tensors, and ``None`` as an empty
subtree.  ``flatten`` lists the leaves in the order
``jax.tree.flatten`` does: dict keys sorted, sequences and NamedTuple
fields in order.  A checkpoint's ``leaf_<i>`` is the i-th leaf in that
order, so each package reads the other's checkpoints, and ``str`` of a
``TreeDef`` is ``str`` of JAX's ``PyTreeDef`` of the same tree.
``flatten_with_path`` gives each leaf's path as JAX's key entries do
(``DictKey``, ``SequenceKey``, ``GetAttrKey``, with their ``key``,
``idx`` and ``str``): the sharding rules decide by those paths.
``value_and_grad`` is ``jax.value_and_grad`` over such a tree of
params, by autograd.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


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


class DictKey:
    """A dict entry of a path: ``key``, printed ``['key']``."""
    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key

    def __str__(self) -> str:
        return f"[{self.key!r}]"


class SequenceKey:
    """A list or tuple entry of a path: ``idx``, printed ``[idx]``."""
    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx

    def __str__(self) -> str:
        return f"[{self.idx}]"


class GetAttrKey:
    """A NamedTuple field of a path: ``name``, printed ``.name``."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __str__(self) -> str:
        return f".{self.name}"


def _is_named(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _walk(t, leaves: list, is_leaf=None, path: tuple = ()) -> TreeDef:
    """Append ``(path, leaf)`` for each leaf of ``t`` to ``leaves``."""
    if is_leaf is not None and is_leaf(t):
        leaves.append((path, t))
        return LEAF
    if t is None:
        return TreeDef("none")
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return TreeDef("dict", keys, tuple(
            _walk(t[k], leaves, is_leaf, path + (DictKey(k),))
            for k in keys))
    if _is_named(t):
        return TreeDef("named", type(t), tuple(
            _walk(x, leaves, is_leaf, path + (GetAttrKey(f),))
            for f, x in zip(t._fields, t)))
    if isinstance(t, (list, tuple)):
        return TreeDef(type(t).__name__, None, tuple(
            _walk(x, leaves, is_leaf, path + (SequenceKey(i),))
            for i, x in enumerate(t)))
    leaves.append((path, t))
    return LEAF


def flatten_with_path(tree, is_leaf=None) -> tuple[list, TreeDef]:
    """([(path, leaf), ...] in JAX's order, structure); ``is_leaf``
    stops the walk at the nodes it accepts."""
    pairs: list = []
    return pairs, _walk(tree, pairs, is_leaf)


def flatten(tree, is_leaf=None) -> tuple[list, TreeDef]:
    """(leaves in JAX's order, structure)."""
    pairs, td = flatten_with_path(tree, is_leaf)
    return [x for _, x in pairs], td


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


def map(fn: Callable, tree, *rest, is_leaf=None) -> Any:   # noqa: A001
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (of the same structure), as ``jax.tree.map``."""
    flat, td = flatten(tree, is_leaf)
    others = [flatten(r, is_leaf)[0] for r in rest]
    return unflatten(td, [fn(*xs) for xs in zip(flat, *others)])


def map_with_path(fn: Callable, tree) -> Any:
    """``fn(path, leaf)`` over the leaves, as
    ``jax.tree_util.tree_map_with_path``."""
    pairs, td = flatten_with_path(tree)
    return unflatten(td, [fn(p, x) for p, x in pairs])


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)`` by autograd: each param
    enters as a fresh leaf (``detach``), so nothing of ``params`` is
    written, and the grads mirror the params' tree and dtypes."""
    flat, td = flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss = loss_fn(unflatten(td, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(td, grads)


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
