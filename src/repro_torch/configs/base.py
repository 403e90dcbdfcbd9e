"""Config registry scaffolding + the assigned input-shape matrix."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.models.config import LMConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


# The assigned LM shape set (identical for all 10 archs).
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# Production defaults for the full-size configs (dry-run only — smoke
# tests use the reduced configs).
PROD = dict(
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    attn_chunk_q=512,
    attn_chunk_kv=1024,
    mamba_chunk=256,
    loss_chunk=512,
    cache_dtype="bfloat16",
)


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    config: Callable[..., LMConfig]
    smoke: Callable[[], LMConfig]
    sub_quadratic: bool = False      # may run long_500k

    def shape_names(self) -> List[str]:
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.sub_quadratic:
            out.append("long_500k")
        return out


REGISTRY: Dict[str, ArchEntry] = {}


def register(entry: ArchEntry):
    REGISTRY[entry.name] = entry
    return entry
