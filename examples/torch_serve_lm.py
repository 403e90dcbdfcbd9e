"""Serving example on the PyTorch port: the bucketed Engine vs the
continuous-batching Scheduler on the same mixed-length request set,
shared-prefix reuse over the paged KV-cache pool, a warm persistent
session (two traces, one device pool — cross-trace prefix hits), and
streaming delivery.

    PYTHONPATH=src python examples/torch_serve_lm.py               # one card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

The port of ``examples/serve_lm.py``, on the same smoke-size
mistral-nemo-12b.  On the card the Scheduler's paged decode and prefill
run the ``paged_decode_gqa`` and ``prefix_prefill`` kernels (this model
computes in float32, so their CUDA-core variants); ``--device cuda``
(the default) raises without a card.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve
from repro_torch.models import lm
from repro_torch.serve import Engine, Request, Scheduler, bucket_requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = configs.get_smoke_config("mistral-nemo-12b")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    rng = np.random.default_rng(0)
    requests = [
        list(rng.integers(0, cfg.vocab_size, rng.integers(5, 20)))
        for _ in range(6)
    ]
    print(f"{len(requests)} requests, lengths {[len(r) for r in requests]}")

    print("\n-- bucketed Engine: equal-length batches, run to the longest --")
    engine = Engine(cfg, params, max_len=96)
    for idx, batch in bucket_requests(requests):
        out = engine.generate(batch, n_tokens=16, temperature=0.8, seed=1,
                              request_ids=idx)
        print(f"  bucket len={out.prompt_len}: served {len(idx)} requests "
              f"-> {out.tokens.shape[1]} tokens each")

    print("\n-- continuous Scheduler: slot pool, per-request n_tokens --")
    sched = Scheduler(cfg, params, max_slots=3, max_len=96, seed=1)
    reqs = [
        Request(prompt=np.asarray(p, np.int32),
                n_tokens=int(rng.integers(4, 24)),
                temperature=0.8,
                arrival=i // 2)           # staggered arrivals
        for i, p in enumerate(requests)
    ]
    for res in sched.serve(reqs):
        print(f"  rid={res.rid} prompt={res.prompt_len:2d} "
              f"gen={res.generated.size:2d} admitted@{res.admitted_step} "
              f"finished@{res.finished_step}")
    s = sched.last_stats
    print(f"  {s.decode_steps} decode steps, {s.prefills} prefills, "
          f"occupancy {s.occupancy:.0%}, "
          f"{sched.compile_counts()['total']} compiled programs")

    print("\n-- shared-prefix reuse: one system prompt, many requests --")
    # Reuse requires a lossless cache dtype (token-exactness gate).
    cfg_px = dataclasses.replace(cfg, cache_dtype="float32")
    params_px = lm.init(cfg_px, torch.Generator(device=dev).manual_seed(0), dev)
    sched = Scheduler(cfg_px, params_px, max_slots=3, max_len=96, page_size=8)
    system = rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
    reqs = [
        Request(prompt=np.concatenate(
            [system, rng.integers(0, cfg.vocab_size, t).astype(np.int32)]
        ), n_tokens=6)
        for t in (2, 3, 5, 2, 4, 3)
    ]
    for res in sched.serve(reqs):
        print(f"  rid={res.rid} prompt={res.prompt_len:2d} "
              f"prefix_hit_tokens={res.prefix_hit_tokens:2d}")
    pg = sched.last_stats.paging
    hits = pg["prefix_hit_tokens"]
    print(f"  page hits={pg['prefix_hits']} misses={pg['prefix_misses']} "
          f"hit_tokens={pg['prefix_hit_tokens']} "
          f"peak_pages={pg['peak_pages_in_use']}/{pg['n_pages']}")

    print("\n-- warm session: a second trace over the same system prompt --")
    # The scheduler's persistent ServeSession keeps the device pool and
    # the prefix index alive between serve() calls, so trace 2's very
    # first request hits the pages trace 1 filled (cross-trace hits).
    reqs2 = [
        Request(prompt=np.concatenate(
            [system, rng.integers(0, cfg.vocab_size, t).astype(np.int32)]
        ), n_tokens=6, rid=100 + i)
        for i, t in enumerate((3, 2, 4))
    ]
    before = sched.compile_counts()["total"]
    results = sched.serve(reqs2)
    after = sched.compile_counts()["total"]
    s = sched.last_stats
    pg = s.paging
    print(f"  trace {s.trace_index}: first request hit "
          f"{results[0].prefix_hit_tokens} prompt tokens warm; "
          f"cross_trace_hit_tokens={pg['cross_trace_hit_tokens']} "
          f"misses={pg['prefix_misses']}")
    print(f"  compiled programs: {before} -> {after} (warm trace compiles nothing)")
    print(f"  persistent pool: {s.pool_bytes / 1024:.0f} KiB")

    print("\n-- streaming: tokens observable as they are produced --")
    handle = sched.submit(
        Request(prompt=system[:12], n_tokens=8, rid=200),
        on_token=lambda h, t: print(f"  step token: rid={h.rid} tok={t}"),
    )
    streamed = list(handle.stream())     # drains while the session steps
    same = list(handle.result.generated) == streamed
    print(f"  stream() got {streamed}; done={handle.done} (== result: {same})")
    return {"prefix_hit_tokens": hits, "cross_trace_hit_tokens": pg["cross_trace_hit_tokens"],
            "compiled_before": before, "compiled_after": after, "streamed": streamed,
            "stream_equals_result": same}


if __name__ == "__main__":
    main()
