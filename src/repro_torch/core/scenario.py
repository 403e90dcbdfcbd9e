"""Tensor-valued scenario parameters: the batched DSE evaluation pipeline.

A :class:`ScenarioTable` stacks the per-(precision, W_store) cost-model
parameters — bit-widths, the log2 storage budget, derived-gene bounds —
into tensors with a leading ``(S,)`` scenario axis, so one call
evaluates (and ``nsga2.run_batched`` evolves) every scenario at once.

Everything here broadcasts over the scenario prefix: table fields may be
``(S,)`` tensors (whole-table evaluation, genes ``(S, P, 3)``) or 0-d
tensors (a single row from :meth:`ScenarioTable.row`, genes ``(P, 3)``).
``DesignSpace.evaluate`` delegates to :func:`evaluate`, so the batched,
brute-force-oracle and archive paths share ONE evaluation pipeline.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import resolve
from .cells import CellLibrary, TSMC28
from .macros import MacroCosts, fp_macro, int_macro
from .precision import get as get_precision

N_GENES = 3  # (j, h, kk)

DATA_FIELDS = (
    "b_w", "b_x", "b_e", "is_fp", "s_log2", "l_max_log2", "gene_lo", "gene_hi",
)


@dataclasses.dataclass(frozen=True)
class ScenarioTable:
    """Stacked per-scenario cost-model parameters and genome bounds.

    Tensor fields carry a leading scenario prefix (``(S,)`` for a table,
    ``()`` for a row); the trailing fields are plain Python values shared
    by every scenario of the table (they select the cost model's code
    path, not its data)."""

    b_w: torch.Tensor          # int32 — weight bits held in the SRAM array
    b_x: torch.Tensor          # int32 — streamed input bits (B_M for FP)
    b_e: torch.Tensor          # int32 — exponent bits (0 for INT)
    is_fp: torch.Tensor        # bool  — FP (Table VI) vs INT (Table V)
    s_log2: torch.Tensor       # int32 — log2(W_store)
    l_max_log2: torch.Tensor   # int32 — box bound on the derived gene l
    gene_lo: torch.Tensor      # int32 (..., 3)
    gene_hi: torch.Tensor      # int32 (..., 3)
    lib: CellLibrary = TSMC28
    include_selection_mux: bool = False
    any_fp: bool = False
    all_fp: bool = False

    # --- construction ------------------------------------------------------
    @classmethod
    def from_specs(
        cls,
        scenarios: Sequence[tuple],
        lib: CellLibrary = TSMC28,
        include_selection_mux: bool = False,
        device="cuda",
        **space_kw,
    ) -> "ScenarioTable":
        """Build from ``[(precision, w_store), ...]`` pairs (the
        ``explore_multi`` scenario list)."""
        from .space import DesignSpace  # lazy: space.py imports this module

        spaces = [
            DesignSpace(
                prec=get_precision(p) if isinstance(p, str) else p,
                w_store=w,
                lib=lib,
                include_selection_mux=include_selection_mux,
                **space_kw,
            )
            for p, w in scenarios
        ]
        return cls.from_spaces(spaces, device=device)

    @classmethod
    def from_spaces(cls, spaces: Sequence, device="cuda") -> "ScenarioTable":
        """Stack ``DesignSpace`` instances into one table on ``device``.

        The cell library and selection-mux model must agree across
        scenarios: they pick the cost model's code path."""
        if not spaces:
            raise ValueError("at least one scenario required")
        lib = spaces[0].lib
        mux = spaces[0].include_selection_mux
        for sp in spaces:
            if sp.lib != lib or sp.include_selection_mux != mux:
                raise ValueError(
                    "all scenarios of one table must share lib and "
                    "include_selection_mux"
                )
        fps = [bool(sp.prec.is_fp) for sp in spaces]
        fields = dict(
            b_w=[sp.prec.B_w for sp in spaces],
            b_x=[sp.prec.B_x for sp in spaces],
            b_e=[sp.prec.B_E for sp in spaces],
            is_fp=np.asarray(fps, np.bool_),
            s_log2=[sp.s_log2 for sp in spaces],
            l_max_log2=[sp.l_max_log2 for sp in spaces],
            gene_lo=np.stack([sp.gene_lo for sp in spaces]),
            gene_hi=np.stack([sp.gene_hi for sp in spaces]),
        )
        return cls.from_numpy(
            fields, lib=lib, include_selection_mux=mux,
            any_fp=any(fps), all_fp=all(fps), device=device,
        )

    @classmethod
    def from_numpy(cls, fields: dict, device="cuda", **meta) -> "ScenarioTable":
        """Tensor fields from host arrays (``is_fp`` bool, the rest int32)."""
        dev = resolve(device)
        data = {
            f: torch.as_tensor(
                np.asarray(fields[f], np.bool_ if f == "is_fp" else np.int32),
                device=dev,
            )
            for f in DATA_FIELDS
        }
        return cls(**data, **meta)

    # --- shape helpers ------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.b_w.device

    def __len__(self) -> int:
        return int(self.b_w.shape[0]) if self.b_w.dim() else 1

    def row(self, i: int) -> "ScenarioTable":
        """0-d-field view of scenario ``i``."""
        return dataclasses.replace(
            self, **{f: getattr(self, f)[i] for f in DATA_FIELDS}
        )


def _pref(x: torch.Tensor, genes: torch.Tensor) -> torch.Tensor:
    """Right-pad a scenario-prefix field with singleton axes so it
    broadcasts against per-genome tensors derived from ``genes`` (shape
    ``prefix + pop_dims + (N_GENES,)``)."""
    return x.reshape(x.shape + (1,) * (genes.dim() - 1 - x.dim()))


# --- decoding ----------------------------------------------------------------
def derived_l(table: ScenarioTable, genes: torch.Tensor) -> torch.Tensor:
    """The storage-equality-derived gene: l = log2(W_store) - j - h."""
    return _pref(table.s_log2, genes) - genes[..., 0] - genes[..., 1]


def decode(table: ScenarioTable, genes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """genes ``(..., 3)`` int32 -> (N, H, L, k) float32 tensors.

    ``l`` is clamped into its box for cost evaluation; the true violation
    is reported separately by :func:`violation`.
    """
    one = torch.ones((), dtype=torch.int32, device=genes.device)
    j = genes[..., 0].to(torch.int32)
    h = genes[..., 1].to(torch.int32)
    lmax = _pref(table.l_max_log2, genes)
    l = torch.minimum(torch.clamp_min(derived_l(table, genes).to(torch.int32), 0), lmax)
    kk = genes[..., 2].to(torch.int32)
    # Integer bit-shifts, as the reference does (exp2 is inexact there).
    N = (_pref(table.b_w, genes).to(torch.int32) * (one << j)).to(torch.float32)
    return (
        N,
        (one << h).to(torch.float32),
        (one << l).to(torch.float32),
        (one << kk).to(torch.float32),
    )


def violation(table: ScenarioTable, genes: torch.Tensor) -> torch.Tensor:
    l = derived_l(table, genes).to(torch.float32)
    l_max = _pref(table.l_max_log2, genes).to(torch.float32)
    return torch.clamp_min(-l, 0.0) + torch.clamp_min(l - l_max, 0.0)


# --- evaluation --------------------------------------------------------------
def costs(table: ScenarioTable, genes: torch.Tensor) -> MacroCosts:
    """Whole-macro costs with scenario parameters as tensor data.

    INT-only / FP-only tables run exactly the corresponding Table V /
    Table VI model; mixed tables compute both and select per scenario
    (the models share the integer core, so the overhead is the small FP
    pre-align/convert term).
    """
    N, H, L, k = decode(table, genes)
    b_w = _pref(table.b_w, genes).to(torch.float32)
    b_x = _pref(table.b_x, genes).to(torch.float32)
    b_e = _pref(table.b_e, genes).to(torch.float32)
    kw = dict(lib=table.lib, include_selection_mux=table.include_selection_mux)
    if not table.any_fp:
        return int_macro(N, H, L, k, b_w, b_x, **kw)
    if table.all_fp:
        return fp_macro(N, H, L, k, b_w, b_e, b_x, **kw)
    ci = int_macro(N, H, L, k, b_w, b_x, **kw)
    cf = fp_macro(N, H, L, k, b_w, b_e, b_x, **kw)
    fp = _pref(table.is_fp, genes)
    return MacroCosts(
        **{
            f.name: torch.where(fp, getattr(cf, f.name), getattr(ci, f.name))
            for f in dataclasses.fields(MacroCosts)
        }
    )


def evaluate(
    table: ScenarioTable, genes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """genes ``(..., 3)`` -> (objectives ``(..., 4)`` [A, D, E, -T],
    violation ``(...,)``) — THE evaluation pipeline: every consumer
    (batched NSGA-II, archive fronts, brute-force oracle) routes through
    here."""
    return costs(table, genes).objectives(), violation(table, genes)


# --- host-side (out-of-loop) evaluation --------------------------------------
def _bucket(n: int) -> int:
    """Next power of two: pads host-side gene sets to a handful of shapes."""
    return 1 << max(int(math.ceil(math.log2(max(n, 1)))), 0)


def pad_to_bucket(
    genes: np.ndarray, bucket: int | None = None
) -> Tuple[np.ndarray, int]:
    """Pad ``genes`` to ``bucket`` rows (default: next power of two).

    Padding rows are copies of row 0: evaluation is elementwise per row,
    so they change no real entry's values or domination status.  The
    archive extraction uses one shared bucket to stack every scenario's
    archive into one ``(S, bucket, 3)`` batch."""
    genes = np.asarray(genes).reshape(-1, N_GENES)
    n = genes.shape[0]
    if bucket is None:
        bucket = _bucket(n)
    elif bucket < n:
        raise ValueError(f"bucket {bucket} < {n} rows")
    pad = bucket - n
    if pad:
        genes = np.concatenate([genes, np.repeat(genes[:1], pad, axis=0)])
    return genes, n


def evaluate_host(
    row: ScenarioTable, genes: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluation for host-side consumers: genes ``(n, 3)`` numpy ->
    numpy ``(F (n, 4), v (n,))``, computed on the row's device."""
    g = torch.as_tensor(np.asarray(genes, np.int32).reshape(-1, N_GENES),
                        device=row.device)
    F, v = evaluate(row, g)
    return F.cpu().numpy(), v.cpu().numpy()
