"""Tiny JSON result persistence shared by the explorer and the compiler's
output (``smoke.run`` records the DSE front and each generated design).

A *record* is a plain JSON-able dict.  :class:`ResultStore` keeps one
record per name under a root directory (``<root>/<name>.json``), written
atomically, with a small ``_record`` envelope (name / kind / wall-time /
creation time) merged in so downstream tooling can inventory runs
without knowing each producer's schema.  Payload keys stay at the top
level, as in the reference's records.

``to_jsonable`` normalizes numpy scalars/arrays, torch tensors,
dataclasses, paths and sets so producers can hand over raw result
objects (Pareto fronts, reports) without per-site conversion
boilerplate.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def to_jsonable(obj: Any) -> Any:
    """Recursively convert ``obj`` into JSON-serializable primitives."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return to_jsonable(obj.tolist())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return to_jsonable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, pathlib.Path):
        return str(obj)
    if hasattr(obj, "tolist"):  # torch tensors and other array-likes
        return to_jsonable(obj.tolist())
    return str(obj)


def dump_json(path: os.PathLike | str, record: Dict[str, Any]) -> pathlib.Path:
    """Atomic JSON write (tmp file + rename) with numpy-safe encoding."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(to_jsonable(record), indent=2, sort_keys=False))
    os.replace(tmp, path)
    return path


class ResultStore:
    """One JSON record per name under ``root`` (``<root>/<name>.json``)."""

    def __init__(self, root: os.PathLike | str):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def path(self, name: str) -> pathlib.Path:
        if "/" in name or name.startswith("."):
            raise ValueError(f"record names must be flat, got {name!r}")
        return self.root / f"{name}.json"

    def __contains__(self, name: str) -> bool:
        return self.path(name).exists()

    def names(self) -> List[str]:
        return sorted(p.stem for p in self.root.glob("*.json"))

    def put(
        self,
        name: str,
        payload: Dict[str, Any],
        kind: str = "record",
        wall_s: Optional[float] = None,
    ) -> pathlib.Path:
        """Persist ``payload`` (top-level keys preserved) with a
        ``_record`` envelope merged in."""
        rec = dict(payload)
        rec["_record"] = {
            "name": name,
            "kind": kind,
            "wall_s": wall_s,
            "created_unix": time.time(),
        }
        return dump_json(self.path(name), rec)

    def get(self, name: str) -> Dict[str, Any]:
        return json.loads(self.path(name).read_text())

    def records(self) -> Iterator[Dict[str, Any]]:
        for name in self.names():
            yield self.get(name)


def front_payload(points) -> Dict[str, Any]:
    """Serialize a list of ``explorer.ParetoPoint`` into a record payload
    (shared by ``explore_multi``, benchmarks and reports)."""
    return {
        "n_points": len(points),
        "points": [to_jsonable(p) for p in points],
    }
