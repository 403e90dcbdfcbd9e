"""Distribution layer: logical-axis sharding over meshes of ranks.

Model code names *logical* axes ("heads", "ff", "vocab", ...) and a
per-mesh rule table resolves them to mesh axes, with divisibility
fallbacks so the same model code runs unsharded in one process and
sharded over a ``torch.distributed`` process group, one process a rank.

Public API (see :mod:`repro_torch.dist.sharding`):

* ``MeshContext``          — logical-axis -> mesh-axis resolution.
* ``use_mesh``             — context manager installing the active context.
* ``current``              — the active ``MeshContext`` (or ``None``).
* ``repl_act``             — gather an activation to full width before a
                             contraction (identity when nothing is sharded).
* ``logical_for_path``     — parameter path -> logical axes rules.
* ``param_sharding_tree``  — parameter tree -> per-leaf specs and placements.
* ``serving_context`` / ``serve_param_sharding_tree`` /
  ``serve_pool_sharding_tree`` / ``shard_tree`` — exact serving.
* ``state_sharding_tree`` / ``batch_sharding_tree`` — training's state
  and batch layouts, which :mod:`repro_torch.dist.fsdp` executes.
"""
from .sharding import (  # noqa: F401
    LeafSharding,
    MeshContext,
    batch_sharding_tree,
    current,
    logical_for_path,
    param_sharding_tree,
    repl_act,
    serve_param_sharding_tree,
    serve_pool_sharding_tree,
    serving_context,
    shard_tree,
    state_sharding_tree,
    use_mesh,
)

__all__ = [
    "LeafSharding",
    "MeshContext",
    "batch_sharding_tree",
    "current",
    "logical_for_path",
    "param_sharding_tree",
    "repl_act",
    "serve_param_sharding_tree",
    "serve_pool_sharding_tree",
    "serving_context",
    "shard_tree",
    "state_sharding_tree",
    "use_mesh",
]
