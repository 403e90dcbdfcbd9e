"""Architecture/config registry: 10 assigned archs x 4 shapes (see
DESIGN.md §4).  ``get_config(name)`` builds the full production config,
``get_smoke_config(name)`` the reduced same-family config used in CPU
smoke tests."""
from __future__ import annotations

from typing import List

from repro_torch.models.config import LMConfig

from . import archs  # noqa: F401  (populates REGISTRY)
from .base import REGISTRY, SHAPES, ArchEntry, ShapeSpec  # noqa: F401

ARCH_NAMES: List[str] = list(REGISTRY)


def entry(name: str) -> ArchEntry:
    try:
        return REGISTRY[name]
    except KeyError as e:  # pragma: no cover
        raise ValueError(f"unknown arch {name!r}; known: {ARCH_NAMES}") from e


def get_config(name: str, **overrides) -> LMConfig:
    return entry(name).config(**overrides)


def get_smoke_config(name: str) -> LMConfig:
    return entry(name).smoke()


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; skipped cells annotated."""
    out = []
    for name, e in REGISTRY.items():
        allowed = set(e.shape_names())
        for sname, spec in SHAPES.items():
            if sname in allowed:
                out.append((name, sname, spec, "run"))
            elif include_skipped:
                out.append((name, sname, spec, "skip:full-attention-500k"))
    return out
