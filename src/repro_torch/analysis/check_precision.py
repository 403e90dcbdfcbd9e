"""Precision-flow lint: dtype provenance over every recorded hot program.

Four rules, driven by the contract's :class:`~.registry.PrecisionPolicy`
and evaluated on a :mod:`.dtype_flow` walk of each recorded program
(``Built.programs``):

1. **forbidden dtypes** — no ``float64``/``complex128`` anywhere: one
   promotion to f64 doubles every downstream buffer and runs at a
   fraction of the card's rate.
2. **widening casts** — a conversion into a strictly wider float is only
   legal inside a declared precision island
   (``models.common.precision_island``): the deliberate f32 regions
   (norm, rope, attention softmax, logits, cross-entropy, optimizer
   moments, the dense accumulation, the DCIM pipeline).  Anything else
   is a silent promotion that belongs in the policy or out of the code.
3. **products** — the reference requires each accumulation-ambiguous
   ``dot_general`` to declare ``preferred_element_type``; a PyTorch
   product has no such argument, so the port reads what decides its
   accumulation: a bf16 or f16 product passes only if its output is at
   the policy's ``accum_dtype`` or its device's reduced-precision
   reduction was off when it ran (``op_trace.matmul_flags``; cuBLAS may
   otherwise reduce in bf16); an f32 product passes only with TF32 off;
   an integer product must have an integer output of at least 32 bits
   (``torch.mm`` on int8 returns int8).
4. **DCIM routing + exactness gates** — for programs the policy maps
   through ``sim.dcim_numerics`` (``dcim_programs``), the trace must
   contain **zero** raw floating-point products inside the ``dense``
   island — every dense MVM provably routes through the quantize →
   ``dcim_mvm`` / ``dcim_fp_matmul`` pipeline — and the quantizer's clip
   / pre-align constants must recover the ``core.precision`` bit widths
   (B_x/B_w, or B_M/B_w for FP) exactly.  Lossless-context gates
   (``ExactnessGate``) are re-derived from the recorded page-pool leaf
   dtypes instead of trusting config flags: a gate claimed enabled over
   a pool that is not at compute precision is an error, as is a pool
   leaf no op of the recorded program read.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from .dtype_flow import Flow, analyze, itemsize
from .findings import Finding, error, info, warning
from .registry import Built, PrecisionPolicy, register_check

CHECK = "precision"

_LOW_PRECISION_FLOATS = {
    "bfloat16", "float16", "float8_e4m3fn", "float8_e5m2",
}
_EXPONENT_BIAS_F32 = 127


def _is_float(dtype: str) -> bool:
    return dtype.startswith(("float", "bfloat"))


def _is_int(dtype: str) -> bool:
    return dtype.startswith(("int", "uint"))


def _audit_dtypes(
    contract: str, label: str, flow: Flow, policy: PrecisionPolicy
) -> List[Finding]:
    out = []
    for dtype in sorted(flow.dtypes):
        if dtype in policy.forbid_dtypes:
            out.append(error(
                CHECK, contract,
                f"{label}: forbidden dtype {dtype} appears in the recorded "
                f"program (first at {flow.dtypes[dtype]})",
                program=label, dtype=dtype, site=flow.dtypes[dtype],
            ))
    return out


def _audit_widening(
    contract: str, label: str, flow: Flow, policy: PrecisionPolicy
) -> List[Finding]:
    allowed = frozenset(policy.islands)
    out = []
    for cast in flow.casts:
        if not cast.widening:
            continue
        if cast.islands & allowed:
            continue
        out.append(error(
            CHECK, contract,
            f"{label}: widening cast {cast.src_dtype}->{cast.dst_dtype} at "
            f"{cast.path} outside any declared precision island "
            f"(islands seen: {sorted(cast.islands) or 'none'}); wrap the "
            f"deliberate f32 region in precision_island(...) or drop the "
            f"promotion",
            program=label, site=cast.path,
            src=cast.src_dtype, dst=cast.dst_dtype,
            islands=sorted(cast.islands),
        ))
    return out


def _audit_dots(
    contract: str, label: str, flow: Flow, policy: PrecisionPolicy
) -> List[Finding]:
    out = []
    for dot in flow.dots:
        lhs, rhs, res = dot.lhs_dtype, dot.rhs_dtype, dot.out_dtype
        tf32, bf16_rr, fp16_rr = dot.flags
        if _is_float(lhs) and _is_float(rhs):
            low = {lhs, rhs} & _LOW_PRECISION_FLOATS
            if low:
                reduced = ("bfloat16" in low and bf16_rr) or ("float16" in low and fp16_rr) \
                    or bool(low - {"bfloat16", "float16"})
                if res != policy.accum_dtype and reduced:
                    out.append(error(
                        CHECK, contract,
                        f"{label}: {lhs}x{rhs} product at {dot.path} on {dot.device} may "
                        f"accumulate below {policy.accum_dtype}: its output is {res} and "
                        f"reduced-precision reduction was allowed — turn it off "
                        f"(device.resolve) or accumulate in {policy.accum_dtype}",
                        program=label, site=dot.path, lhs=lhs, rhs=rhs, out=res,
                        device=dot.device, flags=list(dot.flags),
                        required=policy.accum_dtype,
                    ))
            elif tf32:
                out.append(error(
                    CHECK, contract,
                    f"{label}: {lhs}x{rhs} product at {dot.path} on {dot.device} ran with "
                    f"TF32 allowed — its operands were rounded to 10-bit mantissas",
                    program=label, site=dot.path, lhs=lhs, rhs=rhs, out=res,
                    device=dot.device, flags=list(dot.flags),
                ))
        elif _is_int(lhs) and _is_int(rhs):
            if not _is_int(res) or itemsize(res) < 4:
                out.append(error(
                    CHECK, contract,
                    f"{label}: integer {lhs}x{rhs} product at {dot.path} accumulates in "
                    f"{res} — it needs an integer output of at least 32 bits",
                    program=label, site=dot.path, lhs=lhs, rhs=rhs, out=res,
                ))
    return out


def _pow2_exp(value: float) -> Optional[int]:
    if value <= 0 or value != int(value):
        return None
    exp = int(math.log2(value))
    return exp if (1 << exp) == int(value) else None


def _audit_dcim(
    contract: str, label: str, flow: Flow, precision_name: str
) -> List[Finding]:
    from ..core import precision as core_precision

    fmt = core_precision.get(precision_name)
    out: List[Finding] = []

    # (a) structural routing: no raw fp dots may survive inside dense.
    fp_dense_dots = [
        d for d in flow.dots
        if "dense" in d.islands and _is_float(d.lhs_dtype)
    ]
    for d in fp_dense_dots:
        out.append(error(
            CHECK, contract,
            f"{label}: raw {d.lhs_dtype} product at {d.path} inside the "
            f"dense island — this MVM bypasses the installed DCIM numerics "
            f"(_MVM_IMPL) instead of routing through "
            f"quantize->dcim_mvm/dcim_fp_matmul",
            program=label, site=d.path, dtype=d.lhs_dtype,
        ))
    call_names = {c.name for c in flow.calls}
    required = {"dcim_mvm"} | ({"dcim_fp_matmul", "fp_prealign"}
                               if fmt.is_fp else set())
    missing = sorted(required - call_names)
    if missing:
        out.append(error(
            CHECK, contract,
            f"{label}: DCIM-routed program never calls {missing} — dense "
            f"MVMs are not reaching the {precision_name} pipeline",
            program=label, missing=missing, precision=precision_name,
        ))

    if fmt.is_fp:
        # (b-fp) recover B_M from fp_prealign's mantissa scale (a
        # multiply by 1<<B_M) and B_w from dcim_fp_matmul's exp2 bias
        # offset 2*bias + (B_M-1) + (B_w-1).
        prealign_pow2 = sorted({
            e for c in flow.consts
            if c.primitive == "mul" and "fp_prealign" in c.fns
            for e in [_pow2_exp(c.value)] if e is not None and e >= 2
        })
        if fmt.B_M not in prealign_pow2:
            out.append(error(
                CHECK, contract,
                f"{label}: fp_prealign mantissa scale does not recover "
                f"B_M={fmt.B_M} for {precision_name} (power-of-two mul "
                f"constants seen: {[1 << e for e in prealign_pow2]})",
                program=label, expected_B_M=fmt.B_M,
                seen_pow2=[1 << e for e in prealign_pow2],
            ))
        expected_offset = (2 * _EXPONENT_BIAS_F32 + (fmt.B_M - 1)
                           + (fmt.B_w - 1))
        offsets = sorted({
            c.value for c in flow.consts
            if "dcim_fp_matmul" in c.fns
            and 2 * _EXPONENT_BIAS_F32 <= c.value
            < 2 * _EXPONENT_BIAS_F32 + 64
        })
        if float(expected_offset) not in offsets:
            out.append(error(
                CHECK, contract,
                f"{label}: dcim_fp_matmul exponent-bias offset does not "
                f"recover B_w={fmt.B_w} for {precision_name} (expected "
                f"constant {expected_offset}, saw {offsets})",
                program=label, expected=expected_offset, seen=offsets,
            ))
        else:
            out.append(info(
                CHECK, contract,
                f"{label}: DCIM fp routing verified — B_M={fmt.B_M} from "
                f"prealign scale, B_w={fmt.B_w} from bias offset "
                f"{expected_offset}",
                program=label, B_M=fmt.B_M, B_w=fmt.B_w,
            ))
    else:
        # (b-int) recover B_x/B_w from the quantizer clip constants.
        clips = [c for c in flow.clips
                 if "dense" in c.islands or "dcim" in c.islands]
        if not clips:
            out.append(error(
                CHECK, contract,
                f"{label}: no quantizer clip found inside the dense/dcim "
                f"islands — cannot recover B_x/B_w for {precision_name}",
                program=label, precision=precision_name,
            ))
        expected_bits = sorted({fmt.B_x, fmt.B_w})
        recovered = []
        for c in clips:
            if c.lo != -c.hi:
                out.append(error(
                    CHECK, contract,
                    f"{label}: asymmetric quantizer clip [{c.lo}, {c.hi}] at "
                    f"{c.path} — clip range must match the symmetric scale "
                    f"qmax (the -qmax-1 code would dequantize outside the "
                    f"representable range)",
                    program=label, site=c.path, lo=c.lo, hi=c.hi,
                ))
                continue
            exp = _pow2_exp(c.hi + 1)
            if exp is None:
                out.append(error(
                    CHECK, contract,
                    f"{label}: quantizer clip bound {c.hi} at {c.path} is "
                    f"not 2^(B-1)-1 for any bit width B",
                    program=label, site=c.path, hi=c.hi,
                ))
                continue
            recovered.append(exp + 1)
        bad = sorted(set(recovered) - set(expected_bits))
        if bad:
            out.append(error(
                CHECK, contract,
                f"{label}: quantizer clip recovers bit widths {bad} not in "
                f"the {precision_name} format (B_x={fmt.B_x}, B_w={fmt.B_w})",
                program=label, recovered=sorted(set(recovered)),
                expected=expected_bits,
            ))
        elif recovered:
            out.append(info(
                CHECK, contract,
                f"{label}: DCIM int routing verified — clip constants "
                f"recover B={sorted(set(recovered))} matching "
                f"{precision_name} (B_x={fmt.B_x}, B_w={fmt.B_w})",
                program=label, recovered=sorted(set(recovered)),
            ))
    return out


def _audit_gates(
    contract: str, flows: Dict[str, Flow], policy: PrecisionPolicy
) -> List[Finding]:
    out: List[Finding] = []
    for gate in policy.gates:
        flow = flows.get(gate.program)
        if flow is None:
            out.append(error(
                CHECK, contract,
                f"exactness gate {gate.name!r} references program "
                f"{gate.program!r} which the contract did not trace",
                gate=gate.name, program=gate.program,
            ))
            continue
        if not gate.pool_leaves:
            out.append(error(
                CHECK, contract,
                f"exactness gate {gate.name!r} declares no pool leaves — "
                f"nothing to verify against the traced program",
                gate=gate.name, program=gate.program,
            ))
            continue
        lossy = [(p, d) for p, d, _, _ in gate.pool_leaves
                 if _is_float(d) and d != policy.compute_dtype]
        unmatched = [
            (p, d, s) for p, d, s, ptr in gate.pool_leaves
            if not ptr or ptr not in flow.reads
        ]
        for p, d, s in unmatched:
            out.append(error(
                CHECK, contract,
                f"exactness gate {gate.name!r}: pool leaf {p} "
                f"({d}{list(s)}) is not read by the recorded "
                f"{gate.program!r} program — the gate is not verifying the "
                f"pool the program actually reads",
                gate=gate.name, program=gate.program, leaf=p, dtype=d,
            ))
        if gate.enabled and lossy:
            out.append(error(
                CHECK, contract,
                f"exactness gate {gate.name!r} is claimed ENABLED but the "
                f"traced {gate.program!r} pool holds lossy leaves "
                f"{lossy[:4]} below compute precision "
                f"({policy.compute_dtype}) — reused context would not be "
                f"bit-exact",
                gate=gate.name, program=gate.program,
                lossy=[f"{p}:{d}" for p, d in lossy],
                compute_dtype=policy.compute_dtype,
            ))
        elif not gate.enabled and not lossy and not unmatched:
            out.append(warning(
                CHECK, contract,
                f"exactness gate {gate.name!r} is claimed DISABLED but every "
                f"traced pool leaf of {gate.program!r} is at compute "
                f"precision {policy.compute_dtype} — the gate condition "
                f"re-derives as losslessly satisfiable",
                gate=gate.name, program=gate.program,
                compute_dtype=policy.compute_dtype,
            ))
        elif gate.enabled and not unmatched:
            out.append(info(
                CHECK, contract,
                f"exactness gate {gate.name!r} verified: all "
                f"{len(gate.pool_leaves)} pool leaves of {gate.program!r} "
                f"are read by it at {policy.compute_dtype}",
                gate=gate.name, program=gate.program,
                n_leaves=len(gate.pool_leaves),
            ))
    return out


@register_check(CHECK)
def run(contract: str, built: Built) -> List[Finding]:
    policy = getattr(built, "precision", None)
    if policy is None:
        return [warning(
            CHECK, contract,
            "contract declares the precision check but provides no "
            "PrecisionPolicy; nothing verified",
        )]
    findings: List[Finding] = []
    flows: Dict[str, Flow] = {}
    for label, trace in built.programs:
        flow = analyze(trace)
        flows[label] = flow
        findings.extend(_audit_dtypes(contract, label, flow, policy))
        if policy.audit_widening:
            findings.extend(_audit_widening(contract, label, flow, policy))
        if policy.audit_dots:
            findings.extend(_audit_dots(contract, label, flow, policy))
        if label in policy.dcim_programs:
            findings.extend(_audit_dcim(
                contract, label, flow, policy.dcim_programs[label]))
    findings.extend(_audit_gates(contract, flows, policy))
    if not flows:
        findings.append(warning(
            CHECK, contract,
            "precision policy declared but the contract recorded no programs",
        ))
    return findings
