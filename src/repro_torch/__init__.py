"""PyTorch + Hopper port of the SEGA-DCIM compiler.

Mirrors ``repro``'s sub-package layout (``repro_torch/core/pareto.py``
is the counterpart of ``repro/core/pareto.py``, and so on) and never
imports ``jax`` or ``repro``.  Public entry points take a ``device``
argument that defaults to ``"cuda"`` and raise when there is no card;
the hand-written kernels (``repro_torch/csrc``) run on CUDA tensors,
their plain PyTorch versions on CPU tensors.
"""
