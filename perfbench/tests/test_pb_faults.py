"""Each fault a cell can have, planted under a whole run on the CPU at the
small sizes, turns ``correct`` false, and the sound run stays true.  The
controls run at the cells' own sizes in ``test_pb_control_gpu.py``; the
training control also here, where its loss gap already reads past the
committed limit.  The card's readings are in PERF.md
(``tools/calibrate.py``)."""
import pytest
import torch

from conftest import run_small, small_cell
from harness import cli, control, train_closed_loop


def test_serve_sound_run_is_correct():
    out, run = run_small("qwen2.5-3b.longdoc")
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["qwen2.5-3b.longdoc"])
def test_serve_altered_tokens_fail(name, monkeypatch):
    from repro_torch.serve import scheduler

    real = scheduler.sample_tokens
    calls = [0]

    def altered(logits, keys, steps, temps):
        calls[0] += 1
        tok = real(logits, keys, steps, temps)
        return (tok + 1) % logits.shape[-1] if calls[0] % 5 == 0 else tok

    monkeypatch.setattr(scheduler, "sample_tokens", altered)
    out, run = run_small(name)
    assert not out["correct"], out["checks"]


def _faulty(fault):
    def make(cfg, mix):
        opt, step = train_closed_loop.program_step(cfg, mix)
        if fault == "unchanged":
            from repro_torch.models import lm

            def step_fn(state, batch):
                with torch.no_grad():
                    loss, m = lm.loss_fn(state["params"], batch, cfg)
                return state, m
        else:                                   # half the rows, the mean over the rest
            def step_fn(state, batch):
                half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
                return step(state, half)
        return opt, step_fn
    return make


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_faults_fail(fault):
    cell = small_cell("qwen2.5-3b.train")
    run = train_closed_loop.run(cell, 31337, 1.0, False, torch.device("cpu"), 0.0,
                                make_step=_faulty(fault))
    assert not all(cli.passed(c) for c in run.checks.values()), run.checks


def test_train_sound_run_and_control():
    out, run = run_small("qwen2.5-3b.train", seed=31337)
    assert out["correct"], out["checks"]
    cell = small_cell("qwen2.5-3b.train")
    checks = control.train_checks(cell, 31337, torch.device("cpu"))
    assert not all(cli.passed(c) for c in checks.values()), checks
