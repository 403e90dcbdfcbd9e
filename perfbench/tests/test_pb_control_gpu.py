"""The controls at the cells' own sizes, on the card: the plain reference
in fp8 in the program's place must come out not correct by the committed
limits (``-m gpu``; skips without a card).  Its readings over seeds are in
PERF.md (``tools/calibrate.py``)."""
import time

import pytest

from conftest import ROOT
from harness import cli, control, spec


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2.5-3b.longdoc"])
def test_serve_control_fails_at_cell_size(name, cuda_device):
    cell = spec.Cell.load(ROOT, name)
    # A whole window: above the knee a shorter one finishes too few requests
    # to judge as many tokens as a run does.
    out = cli.result(cell, 8801, cell.bench["run_seconds"], False, cuda_device,
                     time.perf_counter())
    run = out.pop("_run")
    assert out["correct"], out["checks"]
    gap = control.serve_gap(cell, run, 8801, cuda_device)
    assert gap > cell.data["limits"]["worst_gap"], gap


@pytest.mark.gpu
def test_train_control_fails_at_cell_size(cuda_device):
    cell = spec.Cell.load(ROOT, "qwen2.5-3b.train", spec.load_bench(ROOT, parked=True))
    checks = control.train_checks(cell, 8802, cuda_device)
    assert not all(cli.passed(c) for c in checks.values()), checks
