"""The benchmark's own CPU tests: ``python -m pytest -q perfbench/tests``
from the root of the checkout (the repository's ``tests/`` are not
collected with them).  Tests marked ``gpu`` need the card and skip here.

``small_cell`` builds a cell of ``BENCHMARK.json`` (or one parked in its
``cells/<cell>.json`` until the program runs its configuration as
stated) over the small
configurations and mixes in ``tests/data`` (the port's smoke widths), so a
whole run (set-up, window, reference, comparison) runs on the CPU in
seconds; ``run_small`` runs one and returns its result line and run.
"""
import json
import pathlib
import sys
import time

import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (str(ROOT / "src"), str(ROOT / "perfbench")):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = HERE / "data"
SMALL = {
    # cell: (small config, small mix, cell data)
    "qwen2.5-3b.longdoc": ("qwen-small.json", "longdoc-small.json", "rate_per_s", 4.0),
    "qwen2.5-3b.train": ("qwen-small.json", "train-small.json", None, None),
}


def small_cell(name: str):
    """The cell ``name`` at the small sizes, with the
    committed limits of ``cells/<name>.json``."""
    from harness import spec

    real = spec.Cell.load(ROOT, name, spec.load_bench(ROOT, parked=True))
    cfg, mix, key, value = SMALL[name]
    data = dict(real.data)
    if key:
        data[key] = value
    if "judged_tokens" in data["limits"]:     # a small window finishes a few requests
        data["limits"] = {**data["limits"], "judged_tokens": 1}
    return spec.Cell(real.root, real.bench, real.workload,
                     json.loads((DATA / cfg).read_text()),
                     json.loads((DATA / mix).read_text()), data, real.end_to_end,
                     real.per_layer)


def run_small(name: str, seed: int = 20240611, seconds: float = 3.0, trace: bool = False):
    import torch
    from harness import cli

    out = cli.result(small_cell(name), seed, seconds, trace, torch.device("cpu"),
                     time.perf_counter())
    return out, out.pop("_run")


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided inside the test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
