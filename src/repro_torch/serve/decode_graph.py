"""One captured CUDA graph per serving session for the paged decode step.

On the card a paged decode step is thousands of small operators (every
layer's projections, norms, rotations and page writes, K4 or K6, the
head), and the host issuing them, not the card, sets its time.  A
:class:`DecodeGraph` captures the step once, ``lm.decode_step_paged``
through the logits, into a ``torch.cuda.CUDAGraph``, and replays it at
every later step: the host copies the step's four inputs into fixed
device buffers and launches one graph.  The kernels are the eager step's,
in its order, so the logits are its bits.  Sampling stays outside the
graph, on the replayed logits: it branches on host temperatures.

A graph holds the addresses it was captured with: its input buffers, the
session's pool and the parameters (K4's and K6's host launch parameters
follow from the fixed shapes).  :func:`storage_key` names the pool's and
the parameters' storage; the session captures again when it changes.

:func:`eligible` decides which sessions capture, from what the scheduler
holds: a paged session whose parameters live on the card, with no DCIM
macro simulator (its numerics re-quantize on the host path), no serving
mesh (tensor-parallel serving runs gloo collectives between operators),
no MoE layer and no routing hook (MoE routing labels rows on the host).
Every other session runs the eager step.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import tree
from ..kernels import cuda_lib
from ..models import lm, moe

# Mixer kinds whose paged decode step is captured.
GRAPH_MIXERS = ("gqa", "mla", "mamba")


def eligible(sched) -> bool:
    """Whether ``sched``'s sessions run their paged decode step as a
    captured graph (read at every step: a routing hook may come and go)."""
    if not (sched.paged and sched.device.type == "cuda" and sched.dcim_sim is None
            and sched.mesh_ctx is None and moe._ROUTING is None):
        return False
    cfg = sched.cfg
    return all(cfg.mixer_kind(i) in GRAPH_MIXERS and cfg.ffn_of(i) != "moe"
               for i in range(cfg.scan_period()))


def storage_key(params, pool) -> Tuple[int, ...]:
    """The addresses a captured step reads and writes in place."""
    return tuple(t.data_ptr() for t in tree.flatten((params, pool))[0])


class DecodeGraph:
    """The paged decode step of one session, captured once and replayed.

    ``cur``, ``pos``, ``active`` ((S,)) and ``block_tables`` ((S,
    pages_per_slot)) are the step's device inputs, filled by :meth:`load`
    from pinned staging on the current stream; :meth:`replay` returns the
    ``(S, 1, V)`` logits buffer the graph writes."""

    def __init__(self, sched):
        S, dev = sched.max_slots, sched.device
        shapes = {"cur": ((S,), torch.int32), "pos": ((S,), torch.int32),
                  "active": ((S,), torch.bool),
                  "block_tables": ((S, sched.pages_per_slot), torch.int32)}
        self.bufs = {n: torch.zeros(s, dtype=dt, device=dev) for n, (s, dt) in shapes.items()}
        self.staging = {n: torch.zeros(s, dtype=dt, pin_memory=True)
                        for n, (s, dt) in shapes.items()}
        self.graph = None
        self.key: Tuple[int, ...] = ()
        self.logits = None
        # Kernel launches of one step, by cuda_lib.launches' names.
        self.launches: Dict[str, int] = {}

    def load(self, **host) -> None:
        """Copy the step's host arrays into the device buffers."""
        for name, arr in host.items():
            stage = self.staging[name]
            stage.numpy()[...] = arr
            self.bufs[name].copy_(stage, non_blocking=True)

    def capture(self, sched, pool) -> None:
        """Capture the step over ``pool`` (nothing runs until a replay).
        The wrappers' launch counts made while capturing are taken back
        and kept as one step's, which every replay adds."""
        b = self.bufs
        before = dict(cuda_lib.launches)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            pos_eff = torch.where(b["active"], b["pos"], 0)
            logits, _ = lm.decode_step_paged(sched.params, {"tokens": b["cur"][:, None]},
                                             pos_eff, pool, b["block_tables"], sched.cfg)
        self.launches = {k: n - before[k] for k, n in cuda_lib.launches.items()
                         if n != before[k]}
        cuda_lib.launches.update(before)
        self.graph, self.logits = graph, logits
        self.key = storage_key(sched.params, pool)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        for k, n in self.launches.items():
            cuda_lib.launches[k] += n
        return self.logits
