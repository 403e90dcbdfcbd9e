"""Quickstart on the PyTorch port: explore a DCIM design space, distill
it, and generate RTL.

    PYTHONPATH=src python examples/torch_quickstart.py               # one card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port of ``examples/quickstart.py``, at its sizes: the paper's core
flow (Fig. 4) through ``repro_torch``:
  1. MOGA-based design space exploration for INT8 / 8K weights,
  2. the merged INT+FP candidate set for an edge-inference scenario,
  3. user-defined distillation (area + power budget),
  4. template-based generation of the selected macro (RTL + floorplan).
On the card the NSGA-II survivor selection runs the ``dominance``
kernel; ``--device cuda`` (the default) raises without a card.
"""
import argparse
import pathlib

from repro_torch.codegen import generate
from repro_torch.core import NSGA2Config, distill, explore, explore_multi

CFG = NSGA2Config(pop_size=128, generations=64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("=== 1. NSGA-II exploration: INT8, W_store=8K ===")
    pts = explore("int8", 8192, CFG, device=args.device)
    for p in pts[:8]:
        print("  " + p.summary())
    print(f"  ... Pareto front size: {len(pts)}")

    print("\n=== 2. Multi-precision union front (INT8 + BF16, 8K) ===")
    union = explore_multi([("int8", 8192), ("bf16", 8192)], CFG, device=args.device)
    n_fp = sum(p.precision == "bf16" for p in union)
    print(f"  union front: {len(union)} points ({n_fp} FP, {len(union) - n_fp} INT)")

    print("\n=== 3. User-defined distillation: area <= 0.15 mm^2, sort by EDP ===")
    sel = distill(union, max_area_mm2=0.15, sort_by="edp", top=3)
    for p in sel:
        print("  " + p.summary())

    print("\n=== 4. Template-based generation of the winner ===")
    out = pathlib.Path("results/quickstart_macro")
    rep = generate(sel[0], out)
    print(f"  RTL files : {rep['files']}")
    print(f"  gate census: {rep['census']}")
    print(f"  audit ok  : {rep['audit']['ok']} "
          f"(census area vs Table V/VI: rel err {rep['audit']['area_rel_err']:.2e})")
    print(f"  floorplan : {rep['floorplan']['die_area_mm2']:.4f} mm^2 die "
          f"-> {out}/floorplan.def")
    return {"front": len(pts), "union": len(union), "union_fp": n_fp,
            "selected": [p.summary() for p in sel], "audit_ok": bool(rep["audit"]["ok"]),
            "out": str(out)}


if __name__ == "__main__":
    main()
