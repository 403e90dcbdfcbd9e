"""Parameter and state trees (nested dicts, lists and tuples of tensors)
flattened in the reference's leaf order: dict keys sorted, sequences in
order, as ``jax.tree_util`` flattens them; each leaf's path in
``jax.tree_util.keystr``'s form (``['params']['blocks'][0]['w']``), which
the checkpoint format names leaves by."""
from __future__ import annotations

from typing import Any, List, Optional, Tuple


class TreeDef:
    """The nesting of a flattened tree: ("dict", keys, children),
    (list or tuple, None, children) or None for a leaf."""

    def __init__(self, kind, keys, children):
        self.kind, self.keys, self.children = kind, keys, children


LEAF = TreeDef(None, None, ())


def flatten(tree, upto: Optional[TreeDef] = None) -> Tuple[List[Any], TreeDef]:
    """(leaves in order, treedef).  With ``upto`` the walk stops at that
    treedef's leaves, whatever they hold (a moments dict per parameter)."""
    leaves: List[Any] = []

    def walk(t, d: Optional[TreeDef]):
        if (d is not None and d.kind is None) or (d is None and not isinstance(
                t, (dict, list, tuple))):
            leaves.append(t)
            return LEAF
        if isinstance(t, dict):
            keys = sorted(t)
            kids = [walk(t[k], None if d is None else d.children[i])
                    for i, k in enumerate(keys)]
            return TreeDef("dict", keys, kids)
        kids = [walk(v, None if d is None else d.children[i]) for i, v in enumerate(t)]
        return TreeDef(type(t), None, kids)

    return leaves, walk(tree, upto)


def unflatten(tdef: TreeDef, leaves) -> Any:
    it = iter(leaves)

    def build(d: TreeDef):
        if d.kind is None:
            return next(it)
        kids = [build(c) for c in d.children]
        if d.kind == "dict":
            return dict(zip(d.keys, kids))
        return d.kind(kids)

    return build(tdef)


def paths(tree) -> List[Tuple[str, Any]]:
    """(keystr path, leaf) for every leaf, in order."""
    out: List[Tuple[str, Any]] = []

    def walk(t, prefix: str):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}[{k!r}]")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{prefix}[{i}]")
        else:
            out.append((prefix, t))

    walk(tree, "")
    return out
