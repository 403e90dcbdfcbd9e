"""Async, atomic checkpoints in the reference's layout, so either package
restores the other's.

``<dir>/step_<N:08d>/`` holds one ``.npy`` per leaf, named by the first
16 hex digits of the sha1 of its ``jax.tree_util.keystr`` path, and
``index.json`` with the step, the caller's extras (the data cursor) and
each leaf's path, file, shape and dtype.  A checkpoint is written into a
temporary directory and renamed into place; with ``async_write`` a
thread writes it from host copies taken before ``save`` returns.  Only
the last ``keep_last`` are kept.

A bfloat16 leaf is stored as its 16-bit patterns (the ``.npy`` holds
2-byte void items, as a bfloat16 array of the reference's is written)
and read back by the index's "bfloat16" dtype: the items viewed as
uint16, then as ``torch.bfloat16``.

Files hold logical, unsharded leaves, as the reference's do, so restore
is elastic.  ``save(shardings=)`` takes a sharded state (this rank's
blocks; ``shardings`` its ``dist.sharding.state_sharding_tree``): each
leaf is gathered whole, one at a time, and the mesh's first rank writes
it, so the files are byte for byte those of the unsharded state
whatever mesh wrote them.  ``restore(shardings=)`` gives each rank its
blocks under the restoring mesh's shardings: a checkpoint written on one
mesh restores onto another, or into one process.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..tree import flatten, paths, unflatten


def _leaf_name(path_str: str) -> str:
    return hashlib.sha1(path_str.encode()).hexdigest()[:16] + ".npy"


def _to_host(leaf):
    """(a numpy copy of the leaf, its dtype's name)."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")).copy(), "bfloat16"
    arr = t.numpy().copy()
    return arr, str(arr.dtype)


def save(directory, step: int, tree: Any, extras: Optional[dict] = None, keep_last: int = 3,
         async_write: bool = False, shardings: Any = None):
    """Write ``tree`` (params, optimizer state, ...) and ``extras`` as
    step ``step``; returns the writer thread when ``async_write``.  With
    ``shardings`` (a ``LeafSharding`` a leaf of ``tree``, whose blocks
    this rank holds) every rank of the mesh calls ``save``: the leaves
    are gathered whole and the first rank writes them; the others return
    once it has (None; with ``async_write``, once the gathers are done)."""
    directory = pathlib.Path(directory)
    writer = True
    if shardings is None:
        host = [(p, *_to_host(leaf)) for p, leaf in paths(tree)]
    else:
        ctxs = [ls.ctx for _, ls in paths(shardings)]
        writer = not ctxs or all(c == 0 for c in ctxs[0].coords.values())
        host = []
        for (p, leaf), (_, ls) in zip(paths(tree), paths(shardings)):
            whole = ls.ctx.gather_block(leaf, ls.spec)
            if writer:
                host.append((p, *_to_host(whole)))
            del whole
    if writer:
        directory.mkdir(parents=True, exist_ok=True)

    def _write():
        tmp = directory / f".tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        index = {"step": step, "extras": extras or {}, "leaves": []}
        for pstr, arr, dtype in host:
            fname = _leaf_name(pstr)
            np.save(tmp / fname, arr)
            index["leaves"].append({"path": pstr, "file": fname, "shape": list(arr.shape),
                                    "dtype": dtype})
        (tmp / "index.json").write_text(json.dumps(index))
        final = directory / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        _gc(directory, keep_last)

    if async_write:
        if not writer:
            return None
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    if writer:
        _write()
    if shardings is not None and ctxs:
        _barrier(ctxs[0])
    return None


def _barrier(ctx) -> None:
    """Every rank of ``ctx``'s mesh waits here for the others (a summed
    zero over each axis); nothing for a context without process groups."""
    if ctx.mesh is None:
        return
    z = torch.zeros(1)
    for a in ctx.axis_names:
        ctx.sum_over(z, (a,))


def _gc(directory: pathlib.Path, keep_last: int):
    for old in sorted(directory.glob("step_*"))[:-keep_last]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    ckpts = sorted(directory.glob("step_*"))
    if not ckpts:
        return None
    return int(ckpts[-1].name.split("_")[1])


def _load(d: pathlib.Path, e: dict) -> torch.Tensor:
    arr = np.load(d / e["file"])
    if e["dtype"] == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory, step: int, target_tree: Any, shardings: Any = None):
    """Load step ``step`` into the structure of ``target_tree``: each leaf
    found by its path, cast to the target leaf's dtype and placed on its
    device.  With ``shardings`` (a ``LeafSharding`` a leaf, the restoring
    mesh's ``state_sharding_tree``) each leaf is this rank's block of the
    stored one; the target's leaves may then be whole or blocks.
    Returns (tree, extras, step)."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    index = json.loads((d / "index.json").read_text())
    by_path = {e["path"]: e for e in index["leaves"]}
    flat, tdef = flatten(target_tree)
    shard_of = (None if shardings is None else dict(paths(shardings)))
    leaves = []
    for (pstr, _), leaf in zip(paths(target_tree), flat):
        e = by_path.get(pstr)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {pstr}")
        t = _load(d, e)
        want = {tuple(t.shape)}
        if shard_of is not None:
            ls = shard_of[pstr]
            t = ls.ctx.block(t, ls.spec).clone()
            want.add(tuple(t.shape))
        if tuple(leaf.shape) not in want:
            raise ValueError(f"checkpoint leaf {pstr}: shape {tuple(e['shape'])}, the target's "
                             f"{tuple(leaf.shape)}")
        leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return unflatten(tdef, leaves), index["extras"], index["step"]
