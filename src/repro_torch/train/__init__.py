"""Training: the train step (loss -> grads -> optimizer), checkpoints and
the fault-tolerant Trainer; the port of ``repro.train``."""
from . import checkpoint  # noqa: F401
from .train_step import build, init_state, make_train_step, shard_state, state_shapes  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
