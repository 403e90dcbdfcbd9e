"""Every entry that takes its device from tensors resolves it.

``device.resolve`` turns cuBLAS's bf16/f16 reduced-precision reduction
off on the card, so bf16 products accumulate in f32 as the reference
declares.  Params put on the card by hand (``.to("cuda")``, a
``torch.load``) reach the ``Scheduler``, the ``Engine`` and the train
steps without any ``lm.init`` having resolved the card: each of them
resolves the params' device itself, the train steps once a device on
their first call.  Held here on the CPU with a spy in place of
``repro_torch.device.resolve``; the flags themselves are held on the
card by ``tests/test_torch_kernels_gpu.py::test_moved_params_resolve``
and, at full width, by ``chip_smoke.py`` (``smoke.serve_moved``).
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch
import torch.distributed as dist

from repro_torch import configs, device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm
from repro_torch.optim import get_optimizer
from repro_torch.serve import Engine, Scheduler
from repro_torch.train import init_state, make_train_step

CPU = torch.device("cpu")


@pytest.fixture
def calls(monkeypatch):
    """The devices ``repro_torch.device.resolve`` is called with."""
    seen = []
    real = device.resolve

    def spy(dev="cuda"):
        seen.append(torch.device(dev))
        return real(dev)

    monkeypatch.setattr(device, "resolve", spy)
    return seen


def _cfg():
    return dataclasses.replace(configs.get_smoke_config("qwen2.5-3b"), n_layers=1)


def _batch(cfg, rows=2, seq=8):
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "loss_mask": np.ones((rows, seq), np.float32)}


def test_scheduler_and_engine_resolve_the_params_device(calls):
    cfg = _cfg()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    calls.clear()
    sched = Scheduler(cfg, params, max_slots=1, max_len=16, page_size=8)
    assert calls == [CPU] and sched.device == CPU
    eng = Engine(cfg, params, max_len=16)
    assert calls == [CPU, CPU] and eng.device == CPU


def test_train_step_resolves_once_on_its_first_call(calls):
    cfg, opt = _cfg(), get_optimizer("adamw", 1e-3)
    state = init_state(torch.Generator().manual_seed(0), cfg, opt, device="cpu")
    step = make_train_step(cfg, opt)
    calls.clear()
    for _ in range(2):
        state, _ = step(state, _batch(cfg))
    assert calls == [CPU]


def test_sharded_train_step_resolves_once_on_its_first_call(calls):
    cfg, opt = _cfg(), get_optimizer("adamw", 1e-3)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(d, "s"),
                                rank=0, world_size=1)
        try:
            mesh = make_local_mesh(1)
            state = init_state(torch.Generator().manual_seed(0), cfg, opt, device="cpu",
                               mesh=mesh)
            step = make_train_step(cfg, opt, mesh=mesh)
            calls.clear()
            for _ in range(2):
                state, _ = step(state, _batch(cfg))
        finally:
            dist.destroy_process_group()
    assert calls == [CPU]


def test_smoke_serve_moved_on_cpu(calls):
    """``smoke.serve_moved``'s CPU rehearsal: params drawn on the CPU and
    "moved" there, the Scheduler resolving their device, the flags left
    as they were (they are the card's), the serve held to the Engine."""
    from repro_torch import smoke

    before = smoke.reduction_flags()
    res = smoke.serve_moved("cpu", full=False)
    assert CPU in calls
    assert set(res.flags) == {"start", "moved", "scheduler"}
    assert set(res.flags.values()) == {before}
    assert len(res.serve.results) == smoke.MOVED_REQUESTS
    assert res.serve.worst_gap <= res.serve.delta
