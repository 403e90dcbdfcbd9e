"""The port's codegen against the reference, byte for byte.

Codegen is host text generation in both packages; its one numeric
contact with the cost model is ``audit.model_area`` (one float32 area),
which the port computes on the CPU.  So the bar is identity: the same
Verilog files, census, audit dict, floorplan summary, DEF text and
``report.json`` bytes, for

  * the reference's 8 test designs (``tests/test_codegen.py``), with the
    weight-selection mux on and off;
  * the best-EDP point of each of the 16 paper scenarios' oracle fronts,
    found by each package's own ``explore(method="brute")``.

The structural and floorplan tests of ``tests/test_codegen.py`` then run
against the port.
"""
import json

import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro import codegen as jcg
from repro.codegen import audit as jaudit
from repro.codegen import floorplan as jfloor
from repro.core import explorer as jexp
from repro_torch import smoke
from repro_torch.codegen import DcimDesign, design_from_point, generate, generate_netlists
from repro_torch.codegen import audit as audit_mod
from repro_torch.codegen.floorplan import floorplan
from repro_torch.codegen.templates import Netlist
from repro_torch.core import explorer as texp
from repro_torch.core.nsga2 import NSGA2Config

# tests/test_codegen.py:DESIGNS
DESIGNS = [
    dict(precision="int2", w_store=4096, N=16, H=64, L=8, k=1),
    dict(precision="int8", w_store=8192, N=64, H=128, L=8, k=4),
    dict(precision="int8", w_store=65536, N=128, H=512, L=8, k=8),
    dict(precision="int16", w_store=16384, N=128, H=256, L=8, k=4),
    dict(precision="fp8", w_store=8192, N=32, H=128, L=8, k=2),
    dict(precision="bf16", w_store=8192, N=64, H=128, L=16, k=4),
    dict(precision="fp16", w_store=16384, N=88, H=256, L=8, k=8),
    dict(precision="fp32", w_store=65536, N=192, H=1024, L=8, k=8),
]
DESIGN_IDS = [f"{s['precision']}-{s['w_store']}" for s in DESIGNS]
MUX = pytest.mark.parametrize("mux", [True, False], ids=["mux", "nomux"])


def _tree_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


# --- (a) the reference's test designs ------------------------------------------
@MUX
@pytest.mark.parametrize("spec", DESIGNS, ids=DESIGN_IDS)
def test_netlists_census_and_audit_identical(spec, mux):
    dj, dt = jcg.design_from_point(spec, mux), design_from_point(spec, mux)
    nj, nt = jcg.generate_netlists(dj), generate_netlists(dt)
    assert nt["design"] == nj["design"]
    assert nt["census"] == nj["census"]
    assert nt["files"].keys() == nj["files"].keys()
    for name in nj["files"]:
        assert nt["files"][name] == nj["files"][name], name
    # model_area and area_rel_err bitwise too: the dicts compare floats with ==.
    assert audit_mod.audit(dt, nt["census"]) == jaudit.audit(dj, nj["census"])


@MUX
@pytest.mark.parametrize("spec", DESIGNS, ids=DESIGN_IDS)
def test_floorplan_and_def_identical(spec, mux):
    dj, dt = jcg.design_from_point(spec, mux), design_from_point(spec, mux)
    pj, pt = jfloor.floorplan(dj), floorplan(dt)
    assert pt["def"] == pj["def"]
    assert pt["summary"] == pj["summary"]
    assert [vars(b) for b in pt["blocks"]] == [vars(b) for b in pj["blocks"]]
    assert audit_mod.model_area(dt) == jaudit.model_area(dj)


@pytest.mark.parametrize("spec", [DESIGNS[1], DESIGNS[5]], ids=["int8", "bf16"])
def test_model_area_ignores_the_default_device(spec):
    """The audit's one cost-model call runs on the CPU in float32 even
    where the caller made another device the default."""
    dj, dt = jcg.design_from_point(spec), design_from_point(spec)
    with torch.device("meta"):       # a tensor there has no value to read
        area = audit_mod.model_area(dt)
    assert area == jaudit.model_area(dj)


# --- (b) the 16 paper scenarios' best-EDP oracle points -------------------------
@pytest.mark.parametrize("prec,w", smoke.SCENARIOS, ids=[f"{p}-{w}" for p, w in smoke.SCENARIOS])
def test_paper_scenario_best_edp_design_identical(prec, w, tmp_path):
    pj = jexp.distill(jexp.explore(prec, w, method="brute"), sort_by="edp")[0]
    pt = texp.distill(texp.explore(prec, w, method="brute", device="cpu"), sort_by="edp")[0]
    assert (pt.N, pt.H, pt.L, pt.k) == (pj.N, pj.H, pj.L, pj.k)
    rj = jcg.generate(pj, tmp_path / "ref")
    rt = generate(pt, tmp_path / "port")
    assert rt == rj
    fj, ft = _tree_bytes(tmp_path / "ref"), _tree_bytes(tmp_path / "port")
    assert sorted(ft) == sorted(fj) == sorted(
        ["floorplan.def", "report.json"] + [f"rtl/{f}" for f in rj["files"]])
    for name in fj:
        assert ft[name] == fj[name], name
    assert rt["audit"]["ok"]


def test_design_from_point_takes_points_dicts_and_designs():
    pts = texp.explore("int8", 4096, method="brute", device="cpu")
    p = pts[0]
    d = design_from_point(p)
    assert d == design_from_point(dict(precision="int8", w_store=4096, N=p.N, H=p.H, L=p.L, k=p.k))
    assert isinstance(d, DcimDesign) and (d.B_w, d.B_x, d.B_E) == (8, 8, 0)
    nomux = design_from_point(p, include_selection_mux=False)
    assert design_from_point(nomux) is nomux      # a design keeps its own mux choice
    assert design_from_point(dict(vars(p))) == d


# --- (c) tests/test_codegen.py's structural and floorplan tests, on the port ----
class TestStructure:
    def test_sram_count_is_exact(self):
        d = design_from_point(DESIGNS[1])
        net = generate_netlists(d)
        assert net["census"]["SRAM"] == d.N * d.H * d.L
        assert d.N * d.H * d.L == d.w_store * d.B_w

    def test_fp_has_prealign_and_converter(self):
        d = design_from_point(DESIGNS[5])
        net = generate_netlists(d)
        assert "fp_prealign.v" in net["files"]
        assert "int2fp.v" in net["files"]

    def test_int_has_no_fp_blocks(self):
        d = design_from_point(DESIGNS[1])
        net = generate_netlists(d)
        assert "fp_prealign.v" not in net["files"]

    def test_verilog_is_balanced(self):
        d = design_from_point(DESIGNS[1])
        net = generate_netlists(d)
        for name, text in net["files"].items():
            opens = sum(
                1 for ln in text.splitlines() if ln.lstrip().startswith("module ")
            )
            closes = sum(
                1 for ln in text.splitlines() if ln.strip() == "endmodule"
            )
            assert opens == closes >= 1, (name, opens, closes)

    def test_mux_tree_count_matches_table2(self):
        """N:1 mux == N-1 MUX2 for power-of-two N."""
        for N in (2, 4, 8, 16, 64):
            n = Netlist("t")
            n.w("module t;")
            n.mux_n1(N, [f"i{j}" for j in range(N)], "s", "y")
            assert n.counts["MUX2"] == N - 1

    def test_barrel_shifter_count_matches_table2(self):
        for N in (2, 4, 8):
            n = Netlist("t")
            n.barrel_shifter(N, "a", "sh", "y")
            assert n.counts["MUX2"] == N * (N - 1)


class TestFloorplan:
    def test_blocks_cover_die(self):
        d = design_from_point(DESIGNS[1])
        plan = floorplan(d)
        s = plan["summary"]
        covered = sum(b.area_um2 for b in plan["blocks"])
        die = s["die_w_um"] * s["die_h_um"]
        assert covered == pytest.approx(die, rel=1e-6)

    def test_die_area_equals_cell_area_over_utilization(self):
        d = design_from_point(DESIGNS[5])
        plan = floorplan(d, utilization=0.7)
        s = plan["summary"]
        assert s["die_area_mm2"] == pytest.approx(s["cell_area_mm2"] / 0.7, rel=1e-6)

    def test_no_overlaps(self):
        d = design_from_point(dict(precision="bf16", w_store=4096, N=16, H=64, L=32, k=2))
        plan = floorplan(d)
        bs = plan["blocks"]
        for i in range(len(bs)):
            for j in range(i + 1, len(bs)):
                a, b = bs[i], bs[j]
                overlap_w = min(a.x_um + a.w_um, b.x_um + b.w_um) - max(a.x_um, b.x_um)
                overlap_h = min(a.y_um + a.h_um, b.y_um + b.h_um) - max(a.y_um, b.y_um)
                assert overlap_w <= 1e-6 or overlap_h <= 1e-6, (a.name, b.name)


class TestEndToEnd:
    def test_generate_writes_everything(self, tmp_path):
        generate(DESIGNS[1], tmp_path)
        assert (tmp_path / "rtl" / "dcim_macro.v").exists()
        assert (tmp_path / "rtl" / "cell_lib.v").exists()
        assert (tmp_path / "floorplan.def").exists()
        loaded = json.loads((tmp_path / "report.json").read_text())
        assert loaded["audit"]["ok"]

    def test_generate_from_explorer_point(self, tmp_path):
        pts = texp.explore("int8", 4096, NSGA2Config(pop_size=32, generations=12), device="cpu")
        rep = generate(pts[0], tmp_path)
        assert rep["audit"]["census_match"]
