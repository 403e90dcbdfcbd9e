"""End-to-end template-based DCIM generator (paper Fig. 4, right side).

Pipeline for each *selected* Pareto point (generation only runs on
user-distilled designs, exactly as the paper stages it):

  explorer.ParetoPoint  ->  DcimDesign
    -> netlists (structural Verilog, per-component files + macro top)
    -> gate-census audit vs the analytic cost model
    -> floorplan (DEF-like placement + area report; Innovus stand-in)
    -> report.json

``generate(point, outdir)`` writes everything under ``outdir``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Union

from ..core.cells import CALIBRATED, CellLibrary, TechParams, TSMC28
from ..core.explorer import ParetoPoint
from ..core.precision import get as get_precision

from . import audit as audit_mod
from . import floorplan as fp_mod
from .templates import CELL_LIB_V
from .verilog import DcimDesign, generate_netlists


def design_from_point(
    p: Union[ParetoPoint, dict, DcimDesign], include_selection_mux: bool = True
) -> DcimDesign:
    """The design of one explored point; a :class:`DcimDesign` is already
    one and keeps its own ``include_selection_mux``."""
    if isinstance(p, DcimDesign):
        return p
    if isinstance(p, ParetoPoint):
        d = dict(
            precision=p.precision, w_store=p.w_store,
            N=p.N, H=p.H, L=p.L, k=p.k,
        )
    else:
        d = dict(p)
    prec = get_precision(d["precision"])
    return DcimDesign(
        precision=prec.name,
        is_fp=prec.is_fp,
        w_store=int(d["w_store"]),
        N=int(d["N"]),
        H=int(d["H"]),
        L=int(d["L"]),
        k=int(d["k"]),
        B_w=prec.B_w,
        B_x=prec.B_x,
        B_E=prec.B_E,
        include_selection_mux=include_selection_mux,
    )


def generate(
    point: Union[ParetoPoint, dict, DcimDesign],
    outdir: Union[str, pathlib.Path],
    tech: TechParams = CALIBRATED,
    lib: CellLibrary = TSMC28,
    utilization: float = 0.7,
    include_selection_mux: bool = True,
) -> dict:
    """Generate RTL + floorplan + reports for one design point."""
    d = design_from_point(point, include_selection_mux)
    out = pathlib.Path(outdir)
    (out / "rtl").mkdir(parents=True, exist_ok=True)

    net = generate_netlists(d)
    for fname, text in net["files"].items():
        (out / "rtl" / fname).write_text(text)
    (out / "rtl" / "cell_lib.v").write_text(CELL_LIB_V)

    audit = audit_mod.audit(d, net["census"], lib)
    plan = fp_mod.floorplan(d, tech, lib, utilization)
    (out / "floorplan.def").write_text(plan["def"])

    report = dict(
        design=dataclasses.asdict(d),
        census=net["census"],
        audit={k: v for k, v in audit.items() if k != "mismatches"}
        | {"mismatches": {k: list(v) for k, v in audit["mismatches"].items()}},
        floorplan=plan["summary"],
        files=sorted(net["files"]) + ["cell_lib.v"],
    )
    (out / "report.json").write_text(json.dumps(report, indent=2, default=str))
    return report
