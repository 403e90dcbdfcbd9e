"""The traffic generator: a seed fixes the requests; another seed gives
the same sizes at the same times with other token ids."""
import json

import numpy as np
import torch

from conftest import ROOT
from harness import traffic

MIX = json.loads((ROOT / "perfbench/traffic/longdoc.json").read_text())


def _plan(seed, rate=3.0, seconds=20.0):
    return traffic.serve_plan(MIX, rate, seconds, seed, 151936)


def test_same_seed_same_requests():
    a, b = _plan(2 ** 31 + 77), _plan(2 ** 31 + 77)
    assert [(p.due_s, p.n_tokens) for p in a] == [(p.due_s, p.n_tokens) for p in b]
    assert all(np.array_equal(p.prompt, q.prompt) for p, q in zip(a, b))


def test_other_seed_same_work_other_tokens():
    a, b = _plan(1), _plan(2 ** 31 + 5)
    assert [(p.due_s, p.prompt.size, p.n_tokens) for p in a] == [
        (p.due_s, p.prompt.size, p.n_tokens) for p in b]
    assert all(not np.array_equal(p.prompt, q.prompt) for p, q in zip(a, b))


def test_order_is_mixed_and_set_by_the_mix():
    a = _plan(1)
    sizes = [p.prompt.size for p in a]
    assert sizes != sorted(sizes) and sizes != sorted(sizes, reverse=True)
    other = traffic.serve_plan({**MIX, "order_seed": MIX["order_seed"] + 1}, 3.0, 20.0, 1,
                               151936)
    assert [p.prompt.size for p in other] != sizes
    assert sorted(p.prompt.size for p in other) == sorted(sizes)


def test_plan_fits_the_window_and_the_laws():
    plan = _plan(5, rate=3.0, seconds=20.0)
    assert len(plan) == 60
    assert 0 < plan[0].due_s and plan[-1].due_s < 20.0
    assert all(2048 <= p.prompt.size <= 8192 for p in plan)
    assert all(16 <= p.n_tokens <= 64 for p in plan)
    assert all(p.prompt.dtype == np.int32 and p.prompt.max() < 151936 for p in plan)


def test_train_batches_by_seed_and_step():
    mix = json.loads((ROOT / "perfbench/traffic/train.json").read_text())
    a = traffic.train_batch(mix, 9, 1, 151936, "cpu")
    b = traffic.train_batch(mix, 9, 1, 151936, "cpu")
    c = traffic.train_batch(mix, 9, 2, 151936, "cpu")
    d = traffic.train_batch(mix, 10, 1, 151936, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"]) and not torch.equal(a["tokens"], d["tokens"])
    assert a["tokens"].shape == (8, 2048)
    assert len({tuple(r[:4].tolist()) for r in a["tokens"]}) == 8       # rows all differ
    assert torch.equal(a["targets"][:, :-1], a["tokens"][:, 1:])
