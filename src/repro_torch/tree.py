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
    return leaves, _flatten(tree, upto, leaves)


# The walks are module-level functions, not closures: a recursive closure
# refers to itself, and the reference cycle would keep every leaf it saw
# alive until the garbage collector runs.
def _flatten(t, d: Optional[TreeDef], leaves: List[Any]) -> TreeDef:
    if (d is not None and d.kind is None) or (d is None and not isinstance(
            t, (dict, list, tuple))):
        leaves.append(t)
        return LEAF
    if isinstance(t, dict):
        keys = sorted(t)
        kids = [_flatten(t[k], None if d is None else d.children[i], leaves)
                for i, k in enumerate(keys)]
        return TreeDef("dict", keys, kids)
    kids = [_flatten(v, None if d is None else d.children[i], leaves) for i, v in enumerate(t)]
    return TreeDef(type(t), None, kids)


def unflatten(tdef: TreeDef, leaves) -> Any:
    return _build(tdef, iter(leaves))


def _build(d: TreeDef, it):
    if d.kind is None:
        return next(it)
    kids = [_build(c, it) for c in d.children]
    if d.kind == "dict":
        return dict(zip(d.keys, kids))
    return d.kind(kids)


def paths(tree) -> List[Tuple[str, Any]]:
    """(keystr path, leaf) for every leaf, in order."""
    out: List[Tuple[str, Any]] = []
    _paths(tree, "", out)
    return out


def _paths(t, prefix: str, out: List[Tuple[str, Any]]) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _paths(t[k], f"{prefix}[{k!r}]", out)
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            _paths(v, f"{prefix}[{i}]", out)
    else:
        out.append((prefix, t))
