"""Precision islands and named calls: the scopes an op trace reads.

The reference marks its deliberate f32 regions with
``jax.named_scope("island:<name>")`` and reads them back from each
equation's name stack; jaxpr's ``pjit`` equations name the functions a
program called.  An eager PyTorch program has neither, so the port keeps
two module-level stacks here: :func:`precision_island` pushes an island
name, :func:`named_call` a function name, and
``analysis.op_trace.record`` reads both at every op it records.

Both cost one global check when no recorder is active (``RECORDING``,
set by ``op_trace.record``): they then hand back a shared no-op context
and push nothing.  This module is stdlib only, so the hot modules import
it at no cost (``models.common`` re-exports the four names).
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional

RECORDING = False       # set by analysis.op_trace.record while it records
ISLANDS: List[str] = []
CALLS: List[str] = []
CALL_HOOK: Optional[Callable[[str], None]] = None   # told of every named-call entry


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Push:
    __slots__ = ("stack", "name")

    def __init__(self, stack: List[str], name: str):
        self.stack, self.name = stack, name

    def __enter__(self):
        self.stack.append(self.name)

    def __exit__(self, *exc):
        self.stack.pop()
        return False


def precision_island(name: str):
    """Declare a deliberate precision island around a block of ops: every
    op recorded inside carries ``name`` among its islands, which exempts
    its widening casts from the precision lint when the contract's
    policy lists ``name``."""
    return _Push(ISLANDS, name) if RECORDING else _NULL


class _Call(_Push):
    __slots__ = ()

    def __enter__(self):
        self.stack.append(self.name)
        if CALL_HOOK is not None:
            CALL_HOOK(self.name)


def named_call(name: str):
    """Name the function a block of ops belongs to (jaxpr's ``pjit``
    names): the DCIM routing and constant recovery read these."""
    return _Call(CALLS, name) if RECORDING else _NULL


def in_island(name: str):
    """Decorator form of :func:`precision_island` for whole functions."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with precision_island(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def in_call(name: str):
    """Decorator form of :func:`named_call` for whole functions."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with named_call(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco
