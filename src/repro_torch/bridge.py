"""Carry reference state across as numpy: parameter trees, training
states and scenario tables, so both packages can be fed identical
inputs.

The reference side converts first (``jax.tree.map(np.asarray, tree)``,
or a ``ScenarioTable``'s fields to numpy); nothing here imports it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.cells import CellLibrary
from .core.scenario import DATA_FIELDS, ScenarioTable
from .device import resolve
from .dist.sharding import leaf_at, map_tree, state_sharding_tree


def params_from_numpy(tree, device="cuda"):
    """A nested dict/list/tuple of numpy arrays -> the same nesting of
    tensors on ``device``, with the reference's layout kept (a dense
    ``w`` stays (K, N))."""
    device = resolve(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        # numpy knows bfloat16 only through ml_dtypes, which torch cannot
        # read: carry a copy of the bits as uint16, viewed as bfloat16.
        bits = torch.from_numpy(np.array(arr.view(np.uint16)))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)   # a copy: the tensor owns it


def train_state_from_numpy(state, device="cuda", mesh=None):
    """A reference TrainState as numpy (``jax.tree.map(np.asarray,
    state)``) -> the port's: {"params", "opt": {"mu", "step"}, "step"[,
    "err"]} with every leaf a tensor on ``device`` of the same dtype and
    shape (AdamW's f32 m / v, 8-bit AdamW's int8 codes and f32 scales,
    Adafactor's vr / vc / v; the 0-d int32 steps; bfloat16 as its bits,
    as ``params_from_numpy`` carries it).  With ``mesh`` (a
    ``DeviceMesh``, ``{axis: size}`` or a ``MeshContext``) each leaf is
    this rank's block of it under ``dist.sharding.state_sharding_tree``:
    a sharded train step's state."""
    want = {"params", "opt", "step"} | ({"err"} if "err" in state else set())
    if set(state) != want or set(state["opt"]) != {"mu", "step"}:
        raise ValueError(f"not a TrainState: keys {sorted(state)}, opt "
                         f"{sorted(state.get('opt', {}))}")
    if mesh is None:
        return params_from_numpy(state, device)
    shardings = state_sharding_tree(state, mesh)
    return map_tree(lambda p, a: _block_from_numpy(a, leaf_at(shardings, p), device), state)


def _block_from_numpy(arr, ls, device):
    """The rank's block (``ls``: its ``LeafSharding``) of a numpy leaf, as
    a tensor on ``device``."""
    return params_from_numpy(ls.ctx.block(np.asarray(arr), ls.spec), device)


def scenario_table_from_numpy(fields: dict, device="cuda") -> ScenarioTable:
    """A reference ``ScenarioTable``'s fields, by name (the data fields as
    numpy arrays) -> the port's table on ``device``.  The plain fields
    carry over as they are, the cell library rebuilt as the port's own
    ``CellLibrary`` from its field values."""
    meta = {f.name: fields[f.name] for f in dataclasses.fields(ScenarioTable)
            if f.name not in DATA_FIELDS}
    meta["lib"] = CellLibrary(**dataclasses.asdict(meta["lib"]))
    data = {f: np.asarray(fields[f]) for f in DATA_FIELDS}
    return ScenarioTable.from_numpy(data, device=device, **meta)
