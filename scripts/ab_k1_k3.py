#!/usr/bin/env python3
"""Time K1 (``dominance_matrix``) and K3 (``fp_prealign``) of one checkout
on one card, through their public wrappers.

    python3 scripts/ab_k1_k3.py                  # this checkout's kernels
    python3 scripts/ab_k1_k3.py --root DIR       # DIR's (an unpacked checkout)

DIR's ``repro_torch`` is imported and its kernels are built as its own
``cuda_lib`` builds them, into ``DIR/build/torch_kernels/``; only the
wrappers' Python signatures are used, so any checkout of the port can be
timed.  To compare two commits, unpack the other with ``git archive``
into a directory git ignores and run this script with ``--root`` on each,
in turns (B C C B) on one card.

The shapes are the compile path's.  K1 is first driven through the DSE
steps of ``smoke.run`` (the 16-scenario ``explore_multi``, the oracle
fronts, and ``plan``'s own DSE), with every call recorded by its F
shape; it is then timed by CUDA graph replay (``chip_smoke.graph_ms``)
at each recorded shape on that shape's first inputs, and the launches
times those times are summed: the main path's K1 device time.  At F
(16, 256, 4) and (16, 128, 4), the DSE's survivor selection over parents
and children and its pool, it is also timed by CUDA events around
back-to-back calls (``chip_smoke.time_ms``).  A few smaller and larger
(S, P) at M = 4 (random objectives, seed 3) are timed by graph replay
too: one CTA's work and up.  K3 at the lm_head's
w^T (151936, 64, 32) by events and at the online operand x (128, 64, 32)
by graph replay and events, B_M = 8 (seed 2).  An empty kernel by graph
replay, the launch floor, where the checkout has ``csrc/empty.cu``.
Every result is held bitwise to its plain version first.  The last line
is one JSON object of every time, in ms.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SWEEP = [(1, 16), (16, 16), (16, 64), (16, 512), (64, 256)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE, help="the checkout whose kernels to time")
    args = ap.parse_args()
    root = args.root.resolve()
    # The checkout's package first; chip_smoke (this checkout's) then finds
    # it already imported.
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    import torch

    sys.path.insert(0, str(HERE))
    from chip_smoke import card_line, graph_ms, time_ms

    if not torch.cuda.is_available():
        print("ab_k1_k3: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 1

    from repro_torch.core import precision
    from repro_torch.core.explorer import brute_force_front, explore_multi
    from repro_torch.core.nsga2 import NSGA2Config
    from repro_torch.core.space import DesignSpace
    from repro_torch.dcimmap import plan
    from repro_torch.kernels import cuda_lib, ops, ref
    from repro_torch.kernels.fp_prealign import fp_prealign
    from repro_torch.kernels.pareto_rank import dominance_matrix
    from repro_torch.smoke import ARCH, SCENARIOS, W_STORES

    card = card_line()
    print(card)
    print(f"repro_torch from {Path(repro_torch.__file__).parent}; kernels built in "
          f"{cuda_lib.build(force=True):.2f} s")
    dev = torch.device("cuda", 0)

    seen = {}                                   # F shape -> [launches, (F, v) of the first]
    wrapped = ops.dominance_matrix

    def record(F, v=None):
        entry = seen.setdefault(tuple(F.shape), [0, (F.clone(), None if v is None else v.clone())])
        entry[0] += 1
        return wrapped(F, v)

    ops.dominance_matrix = record
    try:
        explore_multi(SCENARIOS, NSGA2Config(), device=dev)
        for prec, w in SCENARIOS:
            brute_force_front(DesignSpace(precision.get(prec), w), dev)
        plan(ARCH, precision=["int8", "bf16"], w_store=list(W_STORES), device=dev)
    finally:
        ops.dominance_matrix = wrapped
    print("K1 on the main path (F shape: launches): "
          + ", ".join(f"{k}: {n}" for k, (n, _) in sorted(seen.items())))

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    wt = torch.randn((151936, 64, 32), generator=gen, device=dev) * 0.02
    xg = torch.randn((128, 64, 32), generator=gen, device=dev)
    gen.manual_seed(3)
    sweep = {(S, P): (torch.randn((S, P, 4), generator=gen, device=dev),
                      torch.rand((S, P), generator=gen, device=dev) - 0.7)
             for S, P in SWEEP}

    for F, v in [first for _, first in seen.values()] + list(sweep.values()):
        if not torch.equal(dominance_matrix(F, v), ref.dominance_matrix_ref(F, v)):
            raise AssertionError(f"K1 differs from its plain version at {tuple(F.shape)}")
    for x in (wt, xg):
        if not all(torch.equal(a, b) for a, b in zip(fp_prealign(x, 8), ref.fp_prealign_ref(x, 8))):
            raise AssertionError(f"K3 differs from its plain version at {tuple(x.shape)}")
    print("K1 and K3 bitwise equal to their plain versions")

    (F256, v256), (F128, v128) = seen[(16, 256, 4)][1], seen[(16, 128, 4)][1]
    t = dict(root=str(root))
    if hasattr(cuda_lib.lib(), "empty_launch"):
        t["empty_graph"] = graph_ms(lambda: cuda_lib.check(cuda_lib.lib().empty_launch(
            dev.index, torch.cuda.current_stream(dev).cuda_stream), "empty"), 200)
    t.update(
        k1_main_graph={"x".join(map(str, k)): [n, graph_ms(lambda: dominance_matrix(*a), 200)]
                       for k, (n, a) in sorted(seen.items())},
        k1_256_events=time_ms(lambda: dominance_matrix(F256, v256), 200),
        k1_128_events=time_ms(lambda: dominance_matrix(F128, v128), 200),
        k3_w_events=time_ms(lambda: fp_prealign(wt, 8), 10),
        k3_x_graph=graph_ms(lambda: fp_prealign(xg, 8), 200),
        k3_x_events=time_ms(lambda: fp_prealign(xg, 8), 200),
        k1_sweep_graph={f"{S}x{P}": graph_ms(lambda: dominance_matrix(F, v), 200)
                        for (S, P), (F, v) in sweep.items()},
    )
    t["k1_main_total"] = sum(n * ms for n, ms in t["k1_main_graph"].values())
    print(f"empty kernel {t.get('empty_graph', float('nan')):.5f} ms (graph replay); K1 on the "
          f"main path by graph replay (F shape: launches x ms) "
          + ", ".join(f"{k}: {n} x {ms:.5f}" for k, (n, ms) in t["k1_main_graph"].items())
          + f", {t['k1_main_total']:.4f} ms in all; K1 by events (16, 256, 4) "
          f"{t['k1_256_events']:.5f} / (16, 128, 4) {t['k1_128_events']:.5f}; K3 w^T "
          f"{t['k3_w_events']:.4f} ms by events, x {t['k3_x_graph']:.5f} by graph replay "
          f"({t['k3_x_events']:.5f} by events); K1 (S x P, M = 4) by graph replay "
          + ", ".join(f"{k} {ms:.5f}" for k, ms in t["k1_sweep_graph"].items()))
    print(card)
    print(json.dumps({"card": card, "times": t}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
