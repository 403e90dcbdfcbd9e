"""Structural Verilog emitters for the template-based DCIM generator.

Every datapath block that the cost model counts (Table II/IV) is emitted
*structurally* — explicit FA/HA/MUX2/NOR/DFF/SRAM/OR instances — so the
generated netlist's gate census can be audited 1:1 against the analytic
model (tests/test_torch_codegen.py does exactly that).  Glue logic (wiring,
selects of non-counted controls) uses behavioral assigns.

Cell library ports follow a simple convention:
  NOR2  (a, b, y)        FA (a, b, cin, s, cout)    HA (a, b, s, cout)
  MUX2  (a, b, sel, y)   DFF (d, clk, q)            OR2 (a, b, y)
  SRAM6T(bl, blb, wl, q, qb)
"""
from __future__ import annotations

import math
from typing import List


class Netlist:
    """Accumulates module text + an exact instance census."""

    def __init__(self, name: str):
        self.name = name
        self.lines: List[str] = []
        self.counts = {k: 0 for k in ("NOR", "OR", "MUX2", "HA", "FA", "DFF", "SRAM")}
        self._uid = 0

    def uid(self, prefix: str) -> str:
        self._uid += 1
        return f"{prefix}_{self._uid}"

    def w(self, line: str = ""):
        self.lines.append(line)

    # --- structural cells ---------------------------------------------------
    def nor(self, a, b, y):
        self.counts["NOR"] += 1
        self.w(f"  NOR2 {self.uid('nor')} (.a({a}), .b({b}), .y({y}));")

    def or2(self, a, b, y):
        self.counts["OR"] += 1
        self.w(f"  OR2 {self.uid('or')} (.a({a}), .b({b}), .y({y}));")

    def mux2(self, a, b, sel, y):
        self.counts["MUX2"] += 1
        self.w(f"  MUX2 {self.uid('mux')} (.a({a}), .b({b}), .sel({sel}), .y({y}));")

    def ha(self, a, b, s, co):
        self.counts["HA"] += 1
        self.w(f"  HA {self.uid('ha')} (.a({a}), .b({b}), .s({s}), .cout({co}));")

    def fa(self, a, b, ci, s, co):
        self.counts["FA"] += 1
        self.w(
            f"  FA {self.uid('fa')} (.a({a}), .b({b}), .cin({ci}), .s({s}), .cout({co}));"
        )

    def dff(self, d, q):
        self.counts["DFF"] += 1
        self.w(f"  DFF {self.uid('dff')} (.d({d}), .clk(clk), .q({q}));")

    def sram(self, wl, q):
        self.counts["SRAM"] += 1
        self.w(
            f"  SRAM6T {self.uid('sram')} (.bl(bl), .blb(blb), .wl({wl}), .q({q}), .qb());"
        )

    # --- composite blocks (mirror Table II exactly) ---------------------------
    def ripple_adder(self, n: int, a: str, b: str, s: str):
        """N-bit ripple-carry: 1 HA + (N-1) FA (Table II)."""
        if n < 1:
            return
        carry = self.uid("c")
        self.w(f"  wire [{n}:0] {carry};")
        self.ha(f"{a}[0]", f"{b}[0]", f"{s}[0]", f"{carry}[1]")
        for i in range(1, n):
            self.fa(f"{a}[{i}]", f"{b}[{i}]", f"{carry}[{i}]", f"{s}[{i}]", f"{carry}[{i+1}]")

    def mux_n1(self, n: int, inputs: List[str], sel: str, y: str):
        """N:1 mux as a tree of (N-1) MUX2 (Table II)."""
        level = list(inputs)
        depth = 0
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level) - 1, 2):
                w = self.uid("m")
                self.w(f"  wire {w};")
                self.mux2(level[i], level[i + 1], f"{sel}[{depth}]", w)
                nxt.append(w)
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
            depth += 1
        if level[0] != y:
            self.w(f"  assign {y} = {level[0]};")

    def barrel_shifter(self, n: int, a: str, sh: str, y: str):
        """N-bit barrel shifter == N parallel N:1 muxes (Table II:
        A_shift = N * A_sel(N))."""
        for bit in range(n):
            ins = [f"{a}[{min(bit + s, n - 1)}]" for s in range(n)]
            self.mux_n1(n, ins, sh, f"{y}[{bit}]")

    def comparator(self, n: int, a: str, b: str, gt: str):
        """Exponent comparator, simplified to an N-bit adder (paper
        §III-B1): emitted as a subtractor-shaped ripple chain."""
        s = self.uid("cmps")
        self.w(f"  wire [{n - 1}:0] {s};")
        self.ripple_adder(n, a, b, s)
        self.w(f"  assign {gt} = {s}[{n - 1}];")

    def module_header(self, ports: str):
        self.w(f"module {self.name} ({ports});")

    def endmodule(self):
        self.w("endmodule")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


CELL_LIB_V = """\
// Customized cell library stubs (placement/LVS views come from the PDK).
module NOR2 (input a, input b, output y);   assign y = ~(a | b); endmodule
module OR2  (input a, input b, output y);   assign y = a | b;    endmodule
module MUX2 (input a, input b, input sel, output y); assign y = sel ? b : a; endmodule
module HA   (input a, input b, output s, output cout); assign s = a ^ b; assign cout = a & b; endmodule
module FA   (input a, input b, input cin, output s, output cout);
  assign s = a ^ b ^ cin; assign cout = (a & b) | (cin & (a ^ b)); endmodule
module DFF  (input d, input clk, output reg q); always @(posedge clk) q <= d; endmodule
module SRAM6T (inout bl, inout blb, input wl, output q, output qb);
  // 6T cell stub: storage modeled behaviorally for simulation.
  reg state; assign q = state; assign qb = ~state;
  always @(posedge wl) state <= bl;
endmodule
"""


def log2i(x: int) -> int:
    r = int(math.log2(x))
    assert 2**r == x, f"{x} not a power of two"
    return r
