"""Deterministic, checkpointable data pipeline: the port of
``repro.data.pipeline``, plain numpy (batches go to the device in the
train step).

Two sources behind one iterator protocol (``next_batch() -> batch``,
``state() -> dict``, ``restore(state)``):

 * SyntheticLM — stateless-RNG token stream keyed by (seed, step): any
   step's batch is reproducible from the cursor alone, so resuming from
   a checkpoint replays the exact stream (fault-tolerance requirement).
 * TokenFileDataset — memory-mapped binary token file (uint16/uint32),
   sliced into (seq+1)-token windows, sharded round-robin across
   data-parallel readers.

Batches: {"tokens" (B, S) int32, "targets" (B, S) int32,
"loss_mask" (B, S) f32}.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    step: int = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self.step))
        toks = rng.integers(
            0, self.vocab_size, size=(self.batch_size, self.seq_len + 1)
        ).astype(np.int32)
        self.step += 1
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "loss_mask": np.ones((self.batch_size, self.seq_len), np.float32),
        }

    def state(self) -> dict:
        return {"kind": "synthetic", "seed": self.seed, "step": self.step}

    def restore(self, state: dict):
        assert state["kind"] == "synthetic"
        self.seed = state["seed"]
        self.step = state["step"]


@dataclasses.dataclass
class TokenFileDataset:
    """Binary token file -> (seq+1) windows, sharded across readers."""

    path: str
    seq_len: int
    batch_size: int
    dtype: str = "uint16"
    shard_index: int = 0
    num_shards: int = 1
    cursor: int = 0            # window index within this shard
    pad_id: int = 0

    def __post_init__(self):
        self._tokens = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n_windows = len(self._tokens) // (self.seq_len + 1)
        if self._n_windows < self.num_shards:
            raise ValueError("dataset smaller than shard count")

    def _window(self, i: int) -> np.ndarray:
        w = self.seq_len + 1
        return np.asarray(self._tokens[i * w : (i + 1) * w], np.int32)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rows = []
        per_shard = self._n_windows // self.num_shards
        for _ in range(self.batch_size):
            local = self.cursor % per_shard
            rows.append(self._window(local * self.num_shards + self.shard_index))
            self.cursor += 1
        toks = np.stack(rows)
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "loss_mask": (toks[:, 1:] != self.pad_id).astype(np.float32),
        }

    def state(self) -> dict:
        return {
            "kind": "file",
            "cursor": self.cursor,
            "shard_index": self.shard_index,
            "num_shards": self.num_shards,
        }

    def restore(self, state: dict):
        assert state["kind"] == "file"
        self.cursor = state["cursor"]
        self.shard_index = state["shard_index"]
        self.num_shards = state["num_shards"]


def write_token_file(path, tokens: np.ndarray, dtype="uint16"):
    np.asarray(tokens, dtype).tofile(path)
    return pathlib.Path(path)


def make_dataset(cfg: dict):
    kind = cfg.get("kind", "synthetic")
    if kind == "synthetic":
        return SyntheticLM(
            vocab_size=cfg["vocab_size"], seq_len=cfg["seq_len"],
            batch_size=cfg["batch_size"], seed=cfg.get("seed", 0),
        )
    return TokenFileDataset(
        path=cfg["path"], seq_len=cfg["seq_len"], batch_size=cfg["batch_size"],
        dtype=cfg.get("dtype", "uint16"),
        shard_index=cfg.get("shard_index", 0),
        num_shards=cfg.get("num_shards", 1),
    )
