"""Batched serving engine: prefill + decode over monolithic caches.

The Engine is the SIMPLE path: per-request ``generate`` defines the
reference tokens every scheduler feature is held to.  It runs the plain
attention (``flash_attention`` for the prompt, ``decode_attention`` per
step), never the paged kernels; an SSM layer prefills by the scan its
config names (``ssm_impl``: K7, or the associative scan that a check
independent of K7 asks for) and decodes by ``mamba_step``.

Sampling is per request: a request's sampled stream depends only on
(seed, request id, step) — never on batch, slot or arrival order.  The
reference gets that from ``fold_in`` of threefry keys; the port gets it
from a stateless counter hash on the device (``sample_tokens``:
Gumbel-max over per-(key, step, vocab index) noise).  The property is the
reference's, the bits are not.

``dcim_sim=`` routes every projection through a generated macro's
numerics (``sim.functional.dcim_numerics``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from .. import device as _device
from ..models import lm, moe
from ..models.common import in_island
from ..models.config import LMConfig

_M32 = 0xFFFFFFFF


def numerics_ctx(dcim_sim):
    """Context installing ``dcim_sim`` as the dense-matmul implementation
    (no-op when None).  Shared by Engine and Scheduler."""
    if dcim_sim is None:
        return contextlib.nullcontext()
    from ..sim.functional import dcim_numerics

    return dcim_numerics(dcim_sim)


def check_capacity(prompt_len: int, n_tokens: int, max_len: int) -> None:
    """Admission control shared by Engine and Scheduler: a real error."""
    if prompt_len + n_tokens > max_len:
        raise ValueError(
            f"request exceeds engine capacity: prompt length {prompt_len} + "
            f"n_tokens {n_tokens} = {prompt_len + n_tokens} > max_len "
            f"{max_len}; shorten the prompt, request fewer "
            f"tokens, or build the Engine with a larger max_len"
        )


def check_unique_rids(request_ids) -> None:
    """Results are keyed, and sampled streams derived, by rid: two
    requests sharing an id raise ``ValueError``."""
    rids = list(request_ids)
    if len(set(rids)) != len(rids):
        dup = sorted({r for r in rids if rids.count(r) > 1})
        raise ValueError(f"duplicate request ids {dup}")


def check_queue_capacity(queued: int, incoming: int, max_queue) -> None:
    """A bounded queue rejects arrivals it cannot absorb (``ValueError``);
    ``max_queue=None`` is unbounded.  The Scheduler's ``max_queue`` sheds
    through this check."""
    if max_queue is None:
        return
    if queued + incoming > max_queue:
        raise ValueError(
            f"queue overloaded: {queued} queued + {incoming} incoming > "
            f"max_queue {max_queue}; retry after the backlog drains or "
            f"build the Scheduler with a larger max_queue"
        )


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (lowbias32) on int64 tensors holding values
    in [0, 2^32); the same bits on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def derive_request_keys(seed: int, request_ids) -> np.ndarray:
    """Per-request stream keys, (B,) int64 on the host: a hash of
    (seed, rid) only."""
    rids = torch.as_tensor(np.asarray(request_ids, np.int64).reshape(-1) & _M32)
    base = _mix32(torch.tensor(int(seed) & _M32, dtype=torch.int64) ^ 0x9E3779B9)
    return _mix32(base ^ _mix32(rids)).numpy()


@in_island("logits")
def sample_tokens(logits: torch.Tensor, keys, steps, temperature) -> torch.Tensor:
    """One token per row: logits (B, V); keys (B,) from
    ``derive_request_keys``; steps (B,) tokens already sampled for that
    request; temperature a float or (B,), on the host.

    temperature <= 0 rows take the argmax (first index of the maximum);
    positive rows take ``argmax(logits / t + gumbel)``, the Gumbel noise
    a hash of (key, step, vocab index), so the sample depends on nothing
    but the request's key, its step and its logits."""
    greedy = torch.argmax(logits, dim=-1)
    B, V = logits.shape
    t = np.broadcast_to(np.asarray(temperature, np.float32), (B,))
    if not (t > 0).any():
        return greedy
    dev = logits.device
    keys = torch.as_tensor(np.asarray(keys, np.int64), device=dev)
    steps = torch.as_tensor(np.asarray(steps, np.int64) & _M32, device=dev)
    stream = _mix32(keys ^ _mix32(steps ^ 0x85EBCA6B))                     # (B,)
    idx = torch.arange(V, dtype=torch.int64, device=dev)
    bits = _mix32(stream[:, None] ^ _mix32(idx ^ 0xC2B2AE35)[None, :])      # (B, V)
    u = (bits.double() + 0.5) / 2.0 ** 32                                   # in (0, 1)
    gumbel = -torch.log(-torch.log(u))
    tt = torch.as_tensor(np.maximum(t, 1e-6), device=dev)
    sampled = torch.argmax(logits.double() / tt[:, None].double() + gumbel, dim=-1)
    return torch.where(torch.as_tensor(t > 0, device=dev), sampled, greedy)


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray           # (B, prompt + generated)
    prompt_len: int
    steps: int


class Engine:
    """Equal-length batches: prefill then decode over a monolithic cache
    of ``max_len`` rows, on the device of ``params``."""

    def __init__(self, cfg: LMConfig, params, max_len: int = 512, dcim_sim=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.dcim_sim = dcim_sim
        # Params moved to the card by hand still get f32 accumulation.
        self.device = _device.resolve(params["ln_f"]["scale"].device)

    def _numerics(self):
        return numerics_ctx(self.dcim_sim)

    def generate(self, prompts: np.ndarray, n_tokens: int = 32, temperature: float = 0.0,
                 seed: int = 0, request_ids=None) -> GenerationResult:
        """prompts (B, P) int32 of equal lengths -> (B, P + n_tokens)."""
        prompts = np.asarray(prompts, np.int32)
        B, P = prompts.shape
        check_capacity(P, n_tokens, self.max_len)
        rids = np.arange(B) if request_ids is None else np.asarray(request_ids)
        keys = derive_request_keys(seed, rids)
        tok = torch.as_tensor(prompts, device=self.device)
        out = [prompts]
        with torch.no_grad(), self._numerics():
            caches, logits = lm.prefill(self.params, {"tokens": tok}, self.cfg,
                                        max_len=self.max_len)
            cur = sample_tokens(logits[:, -1], keys, np.zeros(B, np.int64), temperature)
            if n_tokens > 0:
                out.append(cur.cpu().numpy().astype(np.int32)[:, None])
            # Token t is sampled from the decode at position P + t - 1;
            # the last requested token needs no further decode.
            for t in range(n_tokens - 1):
                logits, caches = lm.decode_step(self.params, {"tokens": cur[:, None]}, P + t,
                                                caches, self.cfg)
                cur = sample_tokens(logits[:, -1], keys, np.full(B, t + 1, np.int64),
                                    temperature)
                out.append(cur.cpu().numpy().astype(np.int32)[:, None])
        return GenerationResult(tokens=np.concatenate(out, axis=1), prompt_len=P,
                                steps=n_tokens)

    def teacher_force(self, prompts: Sequence[np.ndarray],
                      continuations: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """The logits the Engine gives each continuation token, the
        continuation fed back as if it had sampled it: prompts of equal
        length prefill together (``bucket_requests``) into their rows of
        one monolithic cache, then all rows decode together at their own
        positions.  (Batch composition matters under a ``dcim_sim``,
        whose activation scale is per tensor: a scheduler's burst of
        equal-length prompts is then reproduced exactly.)  Returns, per
        request, (n_i, V) float32 logits: row j is the distribution over
        continuation token j.  Every continuation needs n_i >= 1.  Each
        row is labelled with its request's index in ``prompts`` for a
        routing hook (``moe.label_rows``)."""
        B = len(prompts)
        n = [len(c) for c in continuations]
        for p, k in zip(prompts, n):
            if k < 1:
                raise ValueError("teacher_force: empty continuation")
            check_capacity(len(p), k, self.max_len)
        out: List[List[torch.Tensor]] = [[] for _ in range(B)]
        with torch.no_grad(), self._numerics():
            caches = lm.init_cache(self.cfg, B, self.max_len, self.device)
            for idx, arr in bucket_requests([list(p) for p in prompts]):
                tok = torch.as_tensor(arr, device=self.device)
                with moe.label_rows(idx, np.broadcast_to(np.arange(arr.shape[1]), arr.shape)):
                    rows, logits = lm.prefill(self.params, {"tokens": tok}, self.cfg,
                                              max_len=self.max_len)
                for j, i in enumerate(idx):
                    lm.insert_cache_slot(caches, _row(rows, j), i)
                    out[i].append(logits[j, -1].float())
                del rows
            plen = np.asarray([len(p) for p in prompts], np.int64)
            for t in range(max(n) - 1):
                cur = np.asarray([c[min(t, k - 1)] for c, k in zip(continuations, n)], np.int64)
                # Rows whose continuation ended keep decoding junk in
                # their own row, at a position kept inside the cache.
                pos = np.minimum(plen + t, self.max_len - 1)
                live = t + 1 < np.asarray(n)
                with moe.label_rows(np.where(live, np.arange(B), -1), pos[:, None]):
                    logits, caches = lm.decode_step(
                        self.params, {"tokens": torch.as_tensor(cur, device=self.device)[:, None]},
                        torch.as_tensor(pos, device=self.device), caches, self.cfg)
                for i in range(B):
                    if t + 1 < n[i]:
                        out[i].append(logits[i, -1].float())
        return [torch.stack(o) for o in out]


def _row(caches, j: int):
    """Row ``j`` of a monolithic cache, as a batch-of-1 cache (views)."""
    return tuple({k: v[:, j:j + 1] for k, v in c.items()} for c in caches)


def bucket_requests(prompt_lists: List[List[int]]):
    """Group variable-length prompts into equal-length batches."""
    buckets = {}
    for i, p in enumerate(prompt_lists):
        buckets.setdefault(len(p), []).append((i, p))
    out = []
    for plen, items in sorted(buckets.items()):
        idx = [i for i, _ in items]
        arr = np.asarray([p for _, p in items], np.int32)
        out.append((idx, arr))
    return out
