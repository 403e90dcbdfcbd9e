"""train_tokens_per_s: the training tokens of every step the window ran,
over all of the window's time (host clock, each step synchronised)."""
from harness import stats


def read(run):
    return stats.rate(run.steps * run.tokens_per_step, run.window_s)
