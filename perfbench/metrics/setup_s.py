"""setup_s: process start to the window's start, host clock: imports, the
CUDA context, the weights drawn on the card, the cell's shapes warmed
(and in a fresh checkout the kernel library's build)."""


def read(run):
    return run.setup_s
