"""Profiler ranges of the port: :func:`span`.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
``torch.profiler`` records, and one shared no-op context otherwise, so an
untraced run pays one global read a site.  The flag read is the profiler
module's own, set for the whole process by the thread that starts the
profiler: a range opened on another thread (the serving pump) is
recorded too when the profiler records every thread
(``profile_all_threads``).  It is the only way the port opens a range.

The ranges the port opens:

  * ``train_optimizer``: a train step's clipping and optimizer update
    (``train.train_step``);
  * ``moe_experts``: a MoE layer's expert products (``models.moe``);
  * ``serve.*``: the serving scheduler's layers (``serve.scheduler``):
    ``serve.tick`` (one non-idle tick under the session lock),
    ``serve.admit`` (admission: fairness, page matching, seating),
    ``serve.prefill.launch`` / ``serve.decode.launch`` (the host issuing
    one program's operators), ``serve.decode.replay`` (inside a decode
    launch: the replay of the session's captured decode step,
    ``serve.decode_graph``), ``serve.prefill.sync`` /
    ``serve.decode.sync`` (the wait for its sampled tokens),
    ``serve.emit`` (the ``on_token`` callbacks) and ``serve.submit``
    (a submission's work while it holds the lock).
"""
from __future__ import annotations

import torch.autograd.profiler as _profiler


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str):
    """A profiler range ``name`` while a profiler records, else a no-op."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL
