"""Optimizers, schedules and int8 gradient compression: the port of
``repro.optim``.

A ``Transform`` is the reference's optax-style pair over parameter trees
(``init(params) -> state``, ``update(grads, state, params) -> (updates,
state)``), plus ``apply``, the same update written into the parameters
and moments in place, one leaf at a time, so no tree of updates is ever
held whole.  Moments and updates are float32 whatever the parameters'
dtype."""
from .adafactor import adafactor  # noqa: F401
from .adamw import Transform, adamw, apply_updates  # noqa: F401
from .grad_compress import (  # noqa: F401
    compress_decompress,
    init_error_state,
    mean_grads_int8,
    ring_allreduce_int8,
)
from .schedule import cosine_warmup  # noqa: F401


def get_optimizer(name: str, lr, **kw) -> Transform:
    """``"adamw"``, ``"adamw8bit"`` (int8 block-quantized moments) or
    ``"adafactor"``; ``lr`` a float or a schedule of the step."""
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adamw8bit":
        return adamw(lr, quantize_moments=True, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
