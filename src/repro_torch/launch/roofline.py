"""Roofline analysis for one NVIDIA H100 SXM.

Reads the dry-run's per-cell records (``launch.dryrun``) and derives,
per (arch x shape), the three roofline terms **per device per step**:

  compute    = counted FLOPs / peak FLOP/s       (989e12 dense bf16)
  memory     = counted bytes / HBM bytes/s       (3.35e12)
  collective = sum over collectives of
                 bytes * ring_factor * (n-1)/n / NVLink bytes/s

The counted FLOPs and bytes are the dry-run's (matmul FLOPs by
``torch.utils.flop_counter``, each aten op's input and output bytes): the
eager, unfused work of the step.  A cell on one card has no collective
term: its record holds no collectives and the term is 0.

MODEL_FLOPS is 6 N_active tokens (train) and 2 N_active tokens (prefill,
decode); MODEL / counted flags remat and other redundant work.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional

from .. import configs
from ..models.config import LMConfig, ssm_dims

# Published H100 SXM peaks (NVIDIA H100 Tensor Core GPU data sheet,
# dense, no sparsity).
BF16_OPS_PER_S = 989e12       # bf16 tensor cores
INT8_OPS_PER_S = 1979e12      # int8 tensor cores
TF32_OPS_PER_S = 495e12       # tf32 tensor cores
F32_OPS_PER_S = 67e12         # float32, CUDA cores
HBM_BYTES_PER_S = 3.35e12     # HBM3
NVLINK_BYTES_PER_S = 450e9    # NVLink 4, each direction (900e9 both ways)
DEVICE_BYTES = 80e9           # HBM3 capacity
# exp's per second on the special-function units: 16 per clock per SM
# (CUDA programming guide, compute capability 9.0) x 132 SMs x the
# 1.98 GHz boost clock (data sheet).
SFU_EXP_PER_S = 16 * 132 * 1.98e9

PEAK_FLOPS = BF16_OPS_PER_S
HBM_BW = HBM_BYTES_PER_S
LINK_BW = NVLINK_BYTES_PER_S


# ---------------------------- parameter counting ------------------------------
def param_counts(cfg: LMConfig) -> Dict[str, float]:
    """Total and per-token-active parameter counts (analytic)."""
    D = cfg.d_model
    hd = cfg.hd
    total = active = 0.0

    for i in range(cfg.n_layers):
        mk, fk = cfg.mixer_kind(i), cfg.ffn_of(i)
        if mk == "gqa":
            p = D * cfg.n_heads * hd + 2 * D * cfg.n_kv * hd + cfg.n_heads * hd * D
        elif mk == "mla":
            m = cfg.mla
            p = (D * m.q_lora_rank
                 + m.q_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                 + D * (m.kv_lora_rank + m.qk_rope_dim)
                 + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
                 + cfg.n_heads * m.v_head_dim * D)
        else:
            d_inner, dt_rank = ssm_dims(cfg)
            s = cfg.ssm
            p = (D * 2 * d_inner + d_inner * (dt_rank + 2 * s.d_state)
                 + dt_rank * d_inner + d_inner * D + d_inner * (s.d_conv + s.d_state + 2))
        total += p
        active += p

        if fk == "dense":
            f = (3 if cfg.act == "swiglu" else 2) * D * cfg.d_ff
            total += f
            active += f
        elif fk == "moe":
            m = cfg.moe
            per_expert = 3 * D * m.d_ff
            total += m.n_experts * per_expert + D * m.n_experts
            active += m.top_k * per_expert + D * m.n_experts
            if m.n_shared:
                sh = 3 * D * (m.d_ff * m.n_shared)
                total += sh
                active += sh

    if cfg.mtp:
        # depth-1 MTP: one extra block (same structure as layer 0) + proj
        one_layer = (total / cfg.n_layers) if cfg.n_layers else 0.0
        total += one_layer + 2 * D * D
        active += one_layer + 2 * D * D

    emb = cfg.vocab_size * D
    if not cfg.external_embed:
        total += emb
        active += emb
    if not cfg.tie_embeddings:
        total += emb       # head
        active += emb
    return {"total": total, "active": active}


def model_flops(cfg: LMConfig, kind: str, seq: int, batch: int) -> float:
    pc = param_counts(cfg)
    n_active = pc["active"]
    if kind == "train":
        tokens = seq * batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq * batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * batch


_RING_FACTOR = {
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-reduce": 2.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    hlo_flops: float = 0.0          # counted FLOPs, all devices (the reference's name)
    model_flops: float = 0.0
    flops_ratio: float = 0.0        # MODEL / counted (per step, global)
    roofline_fraction: float = 0.0  # max-term time vs compute-bound ideal
    coll_bytes: float = 0.0
    mem_bytes: float = 0.0
    device_bytes: float = 0.0       # args (+ temps where recorded) per device
    note: str = ""


def analyze_record(rec: dict) -> RooflineRow:
    row = RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        status=rec.get("status", "?"),
    )
    if rec.get("status") != "ok" or "analysis" not in rec:
        row.note = rec.get("error", rec.get("status", ""))
        return row
    a = rec["analysis"]
    n_dev = rec.get("n_devices", 1)
    cfg = configs.entry(rec["arch"]).config()
    kind = rec["kind"]

    flops_dev = a["dot_flops"] + a.get("elem_flops", 0.0)
    row.hlo_flops = flops_dev * n_dev
    row.model_flops = model_flops(cfg, kind, rec["seq_len"], rec["global_batch"])
    row.flops_ratio = row.model_flops / max(row.hlo_flops, 1.0)

    row.compute_s = flops_dev / PEAK_FLOPS
    row.mem_bytes = a.get("mem_bytes", 0.0)
    row.memory_s = row.mem_bytes / HBM_BW
    coll_s = 0.0
    coll_b = 0.0
    n = n_dev
    for k, v in a.get("collectives", {}).items():
        eff = v["bytes"] * _RING_FACTOR[k] * (n - 1) / n
        coll_s += eff / LINK_BW
        coll_b += v["bytes"]
    row.collective_s = coll_s
    row.coll_bytes = coll_b

    terms = {"compute": row.compute_s, "memory": row.memory_s,
             "collective": row.collective_s}
    row.bottleneck = max(terms, key=terms.get)
    ideal = row.model_flops / (n_dev * PEAK_FLOPS)
    worst = max(terms.values())
    row.roofline_fraction = ideal / worst if worst > 0 else 0.0

    mem = rec.get("memory", {})
    if isinstance(mem, dict) and "argument_size_in_bytes" in mem:
        row.device_bytes = (
            mem.get("argument_size_in_bytes", 0)
            + mem.get("temp_size_in_bytes", 0)
        )
    return row


def load_rows(dryrun_dir="build/dryrun", mesh: Optional[str] = "h100x1") -> List[RooflineRow]:
    rows = []
    for f in sorted(pathlib.Path(dryrun_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        if mesh and rec.get("mesh") != mesh:
            continue
        rows.append(analyze_record(rec))
    return rows


def format_table(rows: List[RooflineRow]) -> str:
    hdr = (f"{'arch':<22}{'shape':<13}{'status':<9}{'compute_s':>11}"
           f"{'memory_s':>11}{'coll_s':>11}{'bottleneck':>12}"
           f"{'MODEL/cnt':>10}{'roofline%':>10}")
    out = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.status != "ok":
            out.append(f"{r.arch:<22}{r.shape:<13}{r.status:<9}  {r.note[:60]}")
            continue
        out.append(
            f"{r.arch:<22}{r.shape:<13}{r.status:<9}"
            f"{r.compute_s:>11.4f}{r.memory_s:>11.4f}{r.collective_s:>11.4f}"
            f"{r.bottleneck:>12}{r.flops_ratio:>10.3f}"
            f"{100 * r.roofline_fraction:>9.1f}%"
        )
    return "\n".join(out)


def format_markdown(rows: List[RooflineRow]) -> str:
    out = [
        "| arch | shape | status | compute_s | memory_s | coll_s |"
        " bottleneck | MODEL/counted | roofline | HBM GB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.status != "ok":
            out.append(f"| {r.arch} | {r.shape} | {r.status} | | | | | | | |")
            continue
        gb = r.device_bytes / 1e9
        fits = "" if r.device_bytes <= DEVICE_BYTES else " ⚠"
        out.append(
            f"| {r.arch} | {r.shape} | {r.status} | {r.compute_s:.4f} |"
            f" {r.memory_s:.4f} | {r.collective_s:.4f} | {r.bottleneck} |"
            f" {r.flops_ratio:.3f} | {100 * r.roofline_fraction:.1f}% |"
            f" {gb:.1f}{fits} |"
        )
    return "\n".join(out)


def main():  # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--mesh", default="h100x1")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--summary", action="store_true", help="emit a markdown table")
    args = ap.parse_args()
    rows = load_rows(args.dir, args.mesh)
    print(format_markdown(rows) if args.summary else format_table(rows))
    if args.json_out:
        pathlib.Path(args.json_out).write_text(
            json.dumps([dataclasses.asdict(r) for r in rows], indent=2)
        )


if __name__ == "__main__":  # pragma: no cover
    main()
