"""Precision formats supported by SEGA-DCIM (paper §I, §IV).

The paper evaluates INT2/4/8/16 and FP8/FP16/BF16/FP32. For integer
formats the DCIM stores the full two's-complement weight (``B_w`` bits)
and streams ``B_x``-bit inputs ``k`` bits per cycle. For floating-point
formats the *pre-aligned* architecture stores the weight mantissa
(including the hidden bit) as an integer of width ``B_w = mantissa+1``
and streams the aligned input mantissa (``B_M = mantissa+1`` bits), while
exponents (``B_E`` bits) only traverse the pre-alignment comparison tree
and the INT->FP converter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Precision:
    """A numeric format as seen by the DCIM cost model."""

    name: str
    is_fp: bool
    # INT: B_w == B_x == bits.  FP: B_w = stored weight mantissa width
    # (mantissa bits + hidden bit), B_x == B_M = input mantissa width,
    # B_E = exponent width.
    bits: int          # total storage bits of the *external* format
    B_w: int           # weight bits held in the SRAM array
    B_x: int           # input bits streamed through the input buffer
    B_E: int = 0       # exponent bits (FP only)

    @property
    def B_M(self) -> int:
        """Input mantissa width (FP); alias of B_x for FP formats."""
        return self.B_x

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.name


def _int(name: str, bits: int) -> Precision:
    return Precision(name=name, is_fp=False, bits=bits, B_w=bits, B_x=bits)


def _fp(name: str, bits: int, exp: int, man: int) -> Precision:
    # man excludes the hidden bit; stored/streamed mantissas include it.
    return Precision(
        name=name, is_fp=True, bits=bits, B_w=man + 1, B_x=man + 1, B_E=exp
    )


INT2 = _int("int2", 2)
INT4 = _int("int4", 4)
INT8 = _int("int8", 8)
INT16 = _int("int16", 16)
FP8 = _fp("fp8", 8, exp=4, man=3)      # E4M3
FP16 = _fp("fp16", 16, exp=5, man=10)
BF16 = _fp("bf16", 16, exp=8, man=7)
FP32 = _fp("fp32", 32, exp=8, man=23)

REGISTRY: Dict[str, Precision] = {
    p.name: p for p in (INT2, INT4, INT8, INT16, FP8, FP16, BF16, FP32)
}

# The sweep order used by the paper's Fig. 7 (x axis INT2 -> FP32).
PAPER_SWEEP = (INT2, INT4, INT8, INT16, FP8, BF16, FP16, FP32)


def get(name: str) -> Precision:
    try:
        return REGISTRY[name.lower()]
    except KeyError as e:  # pragma: no cover - defensive
        raise ValueError(
            f"unknown precision {name!r}; known: {sorted(REGISTRY)}"
        ) from e
