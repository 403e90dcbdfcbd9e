"""The port's train step, data pipeline, checkpoints and Trainer against
the JAX reference, on the CPU.

* **Bridge.** A reference TrainState (AdamW, 8-bit AdamW, Adafactor;
  with the int8 compression's error state) carried over as numpy by
  ``bridge.train_state_from_numpy``: every leaf bit for bit, with its
  dtype and shape.
* **Train step.** ``make_train_step`` from the carried state against the
  reference's jitted step, two steps (qwen2.5-3b and deepseek-v3 smoke,
  f32, AdamW at lr 1e-3), with and without ``grad_compression="int8"``:
  metrics within 1e-5 relative; parameters within 1e-4 of their leaf's
  largest magnitude plus 0.05 lr a step, moments within 1e-4 of theirs,
  the int8 error state within ERR_TOL = 0.03 of its own (1e-4 of the
  gradient's scale: |err| <= max |g| / 254).  Two kinds of element may
  miss those bounds, at most MISS_SHARE = 1e-3 of all the state's
  elements (seen: 1 of 419,522 in qwen without compression, 58 of
  1,784,386 in deepseek with it):
  where a gradient lies within its f32 summation noise of 0, Adam's
  step m / (sqrt(v) + 1e-8) takes either sign, and where the two sides'
  corrected gradients straddle a rounding boundary of the int8 codes,
  one code differs by one (its gradient, moments and error move by one
  quantum).  No parameter may move more than 3 lr a step apart (Adam's
  normalized step is below 1.5 in magnitude over two steps).
* **Data.** ``SyntheticLM`` and ``TokenFileDataset`` batches, cursors and
  states bitwise equal to the reference's.
* **Checkpoints.** A reference checkpoint of an f32 TrainState restores
  into the port bit for bit, and the port's into the reference; both
  write the same files under the same names; a reference-written
  bfloat16 leaf is read by the port bit for bit (the reference itself
  cannot read it back: ROADMAP §3); the port's bfloat16 round trip is
  bitwise.
* **Trainer.** The reference's Trainer tests on the port's Trainer: the
  loss falls, resume after a crash, a preemption signal, stragglers.
"""
import dataclasses
import json
import pathlib
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

pytest.importorskip("torch", reason="the PyTorch port's tests need torch")
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.optim import get_optimizer as jget_optimizer
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch import bridge, configs
from repro_torch.data import SyntheticLM, TokenFileDataset, make_dataset, write_token_file
from repro_torch.optim import get_optimizer
from repro_torch.train import Trainer, TrainerConfig, build, checkpoint, make_train_step
from repro_torch.tree import flatten, paths

METRIC_RTOL = 1e-5
LEAF_TOL = 1e-4
STEP_LR_TOL = 0.05
ERR_TOL = 0.03
MISS_SHARE = 1e-3
STEP_LR_CAP = 3.0
LR = 1e-3
ARCH = "qwen2.5-3b"


def _cfgs(arch=ARCH):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), attn_backend="xla"),
            configs.get_smoke_config(arch))


def _np_state(state):
    return jax.tree.map(np.asarray, state)


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_bitwise(port_tree, ref_tree):
    want = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = paths(port_tree)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (p, t), (_, a) in zip(got, want):
        a = np.asarray(a)
        assert str(t.dtype).split(".")[1] == a.dtype.name and tuple(t.shape) == a.shape, p
        np.testing.assert_array_equal(_bits(t), _ref_bits(a), err_msg=p)


# --- bridge ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt,gc", [("adamw", None), ("adamw8bit", "int8"), ("adafactor", None)])
def test_bridge_carries_a_train_state(opt, gc):
    jcfg, _ = _cfgs()
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    js = _np_state(jts.init_state(jax.random.PRNGKey(1), jcfg, jget_optimizer(opt, LR), gc))
    ts = bridge.train_state_from_numpy(js, "cpu")
    assert ("err" in ts) == (gc == "int8")
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    _assert_bitwise(ts, js)
    with pytest.raises(ValueError, match="not a TrainState"):
        bridge.train_state_from_numpy({"params": js["params"]}, "cpu")


# --- the train step ---------------------------------------------------------------------
def _batch(rng, vocab, B=2, S=16):
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[0, :2] = 0.0
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "loss_mask": mask}


def _misses(path: str, got: np.ndarray, want: np.ndarray, steps: int) -> int:
    """The elements of a leaf past its bound (see the module docstring);
    raises if a parameter moved more than ``STEP_LR_CAP`` lr a step apart."""
    diff = np.abs(got.astype(np.float64) - want)
    top = float(np.abs(want).max())
    if path.startswith("['params']"):
        assert diff.max() <= LEAF_TOL * top + STEP_LR_CAP * LR * steps, path
        bound = LEAF_TOL * top + STEP_LR_TOL * LR * steps
    else:
        bound = (ERR_TOL if path.startswith("['err']") else LEAF_TOL) * top
    return int(np.count_nonzero(diff > bound))


@pytest.mark.parametrize("gc", [None, "int8"])
@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b"])
def test_train_step_matches_reference(arch, gc):
    jcfg, tcfg = _cfgs(arch)
    js = jts.init_state(jax.random.PRNGKey(0), jcfg, jget_optimizer("adamw", LR), gc)
    ts = bridge.train_state_from_numpy(_np_state(js), "cpu")
    jstep = jax.jit(jts.make_train_step(jcfg, jget_optimizer("adamw", LR), gc))
    tstep = make_train_step(tcfg, get_optimizer("adamw", LR), gc)
    rng = np.random.default_rng(4)
    steps = 2
    for _ in range(steps):
        b = _batch(rng, jcfg.vocab_size)
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, b)
        assert set(tm) == set(jm) and tm["grad_norm"].dtype == torch.float32
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=METRIC_RTOL, atol=0,
                                       err_msg=k)
    js = _np_state(js)
    assert int(ts["step"]) == int(ts["opt"]["step"]) == int(js["step"]) == steps
    want = jax.tree_util.tree_flatten_with_path(js)[0]
    got = paths(ts)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    missed = sum(_misses(p, t.numpy(), a, steps) for (p, t), (_, a) in zip(got, want))
    total = sum(a.size for _, a in want)
    assert missed <= MISS_SHARE * total, (missed, total)


# --- data -------------------------------------------------------------------------------
def test_synthetic_batches_and_cursor_match_reference():
    j, t = jpipe.SyntheticLM(100, 8, 3, seed=5), SyntheticLM(100, 8, 3, seed=5)
    for _ in range(4):
        jb, tb = j.next_batch(), t.next_batch()
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
    assert t.state() == j.state()
    r = SyntheticLM(100, 8, 3, seed=0)
    r.restore(j.state())
    np.testing.assert_array_equal(r.next_batch()["tokens"], j.next_batch()["tokens"])


@pytest.mark.parametrize("shards", [1, 2])
def test_token_file_batches_match_reference(tmp_path, shards):
    toks = (np.arange(9 * 13) * 7 % 50).astype(np.uint16)
    toks[20] = 0                                              # a pad id: masked out
    path = write_token_file(tmp_path / "t.bin", toks)
    assert path.read_bytes() == jpipe.write_token_file(tmp_path / "j.bin", toks).read_bytes()
    for idx in range(shards):
        j = jpipe.TokenFileDataset(str(path), 8, 2, shard_index=idx, num_shards=shards)
        t = TokenFileDataset(str(path), 8, 2, shard_index=idx, num_shards=shards)
        for _ in range(5):
            jb, tb = j.next_batch(), t.next_batch()
            for k in jb:
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
            assert t.state() == j.state()


def test_make_dataset_matches_reference(tmp_path):
    write_token_file(tmp_path / "t.bin", np.arange(200), dtype="uint32")
    for cfg in ({"vocab_size": 50, "seq_len": 4, "batch_size": 2, "seed": 3},
                {"kind": "file", "path": str(tmp_path / "t.bin"), "seq_len": 4,
                 "batch_size": 2, "dtype": "uint32"}):
        j, t = jpipe.make_dataset(cfg), make_dataset(cfg)
        assert type(t).__name__ == type(j).__name__
        np.testing.assert_array_equal(t.next_batch()["targets"], j.next_batch()["targets"])


# The reference's own data tests, on the port.
def test_token_file_dataset(tmp_path):
    path = write_token_file(tmp_path / "toks.bin", np.arange(9 * 10, dtype=np.uint16))
    b = TokenFileDataset(str(path), seq_len=8, batch_size=2).next_batch()
    np.testing.assert_array_equal(b["tokens"][0], np.arange(8))
    np.testing.assert_array_equal(b["targets"][0], np.arange(1, 9))


def test_token_file_sharding_disjoint(tmp_path):
    path = write_token_file(tmp_path / "t.bin", np.arange(9 * 8, dtype=np.uint16))
    d0 = TokenFileDataset(str(path), 8, 2, shard_index=0, num_shards=2)
    d1 = TokenFileDataset(str(path), 8, 2, shard_index=1, num_shards=2)
    assert not (set(map(tuple, d0.next_batch()["tokens"]))
                & set(map(tuple, d1.next_batch()["tokens"])))


# --- checkpoints ------------------------------------------------------------------------
@pytest.fixture(scope="module")
def f32_states():
    """(a reference TrainState as jax arrays, the port's build of the same
    config: same structure, other values)."""
    jcfg, tcfg = _cfgs()
    js = jts.init_state(jax.random.PRNGKey(2), jcfg, jget_optimizer("adamw", LR), "int8")
    ts, _ = build(tcfg, "adamw", LR, grad_compression="int8", seed=9, device="cpu")
    return js, ts


def test_reference_checkpoint_restores_into_port(f32_states, tmp_path):
    js, ts = f32_states
    jckpt.save(tmp_path, 12, js, extras={"data_state": {"kind": "synthetic", "step": 4}})
    got, extras, step = checkpoint.restore(tmp_path, checkpoint.latest_step(tmp_path), ts)
    assert step == 12 and extras == {"data_state": {"kind": "synthetic", "step": 4}}
    _assert_bitwise(got, _np_state(js))


def test_port_checkpoint_restores_into_reference(f32_states, tmp_path):
    js, ts = f32_states
    checkpoint.save(tmp_path / "t", 5, ts, extras={"x": 1})
    jckpt.save(tmp_path / "j", 5, _np_state(jax.tree.map(np.asarray, js)))
    tdir, jdir = tmp_path / "t" / "step_00000005", tmp_path / "j" / "step_00000005"
    assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    tindex = json.loads((tdir / "index.json").read_text())
    jindex = json.loads((jdir / "index.json").read_text())
    strip = lambda ix: [{k: e[k] for k in ("path", "file", "shape", "dtype")}   # noqa: E731
                        for e in ix["leaves"]]
    assert strip(tindex) == strip(jindex)
    got, extras, step = jckpt.restore(tmp_path / "t", 5, js)
    assert step == 5 and extras == {"x": 1}
    _assert_bitwise(ts, _np_state(got))


def test_reference_bf16_leaf_read_bit_for_bit(tmp_path):
    bits = np.random.default_rng(0).integers(0, 2**16, (3, 70)).astype(np.uint16)
    bits[0, :4] = [0x7F80, 0xFF80, 0x7FC1, 0x0001]           # inf, -inf, a NaN, a subnormal
    tree = {"p": {"w": jnp.asarray(bits.view(ml_dtypes.bfloat16))}, "step": jnp.int32(3)}
    jckpt.save(tmp_path, 1, tree)
    target = {"p": {"w": torch.zeros(3, 70, dtype=torch.bfloat16)},
              "step": torch.zeros((), dtype=torch.int32)}
    got, _, _ = checkpoint.restore(tmp_path, 1, target)
    assert got["p"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["p"]["w"]), bits)
    assert int(got["step"]) == 3


def test_port_bf16_round_trip_bitwise(tmp_path):
    _, tcfg = _cfgs()
    ts, _ = build(dataclasses.replace(tcfg, param_dtype="bfloat16"), "adamw8bit", LR, seed=1,
                  device="cpu")
    checkpoint.save(tmp_path, 2, ts)
    index = json.loads((tmp_path / "step_00000002" / "index.json").read_text())
    assert {e["dtype"] for e in index["leaves"]} == {"bfloat16", "float32", "int8", "int32"}
    target = jax.tree.map(torch.zeros_like, ts, is_leaf=torch.is_tensor)
    got, _, _ = checkpoint.restore(tmp_path, 2, target)
    for (p, a), (_, b) in zip(paths(ts), paths(got)):
        assert a.dtype == b.dtype and torch.equal(_bits_t(a), _bits_t(b)), p


def _bits_t(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_gc_keeps_last_and_async_save(tmp_path):
    for s in (1, 2, 3, 4):
        checkpoint.save(tmp_path, s, {"a": torch.ones(3)}, keep_last=2)
    assert checkpoint.latest_step(tmp_path) == 4
    assert len(list(pathlib.Path(tmp_path).glob("step_*"))) == 2
    th = checkpoint.save(tmp_path, 9, {"a": torch.ones(3)}, async_write=True)
    th.join()
    assert checkpoint.latest_step(tmp_path) == 9
    assert checkpoint.latest_step(tmp_path / "none") is None
    with pytest.raises(KeyError, match="missing leaf"):
        checkpoint.restore(tmp_path, 9, {"b": torch.ones(3)})


# --- the Trainer (the reference's tests, on the port) -----------------------------------------
@pytest.fixture(scope="module")
def tiny():
    _, cfg = _cfgs()
    state, step_fn = build(cfg, optimizer="adamw", lr=1e-3, device="cpu")
    return cfg, state, step_fn


def _copy(state):
    return jax.tree.map(torch.clone, state, is_leaf=torch.is_tensor)


def test_loss_decreases(tiny):
    cfg, state, step_fn = tiny

    class Learnable:
        """Fully predictable stream: next token = (token + 1) % V."""

        def next_batch(self):
            base = np.arange(17)[None, :] % cfg.vocab_size
            toks = np.repeat(base, 2, axis=0).astype(np.int32)
            return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                    "loss_mask": np.ones((2, 16), np.float32)}

    res = Trainer(_copy(state), step_fn, Learnable(),
                  TrainerConfig(total_steps=30, log_every=1)).run()
    first = np.mean([h["loss"] for h in res["history"][:5]])
    last = np.mean([h["loss"] for h in res["history"][-5:]])
    assert last < 0.7 * first, (first, last)


def test_resume_after_crash(tiny, tmp_path):
    cfg, state, step_fn = tiny
    ds = SyntheticLM(cfg.vocab_size, 16, 2, seed=2)
    Trainer(_copy(state), step_fn, ds,
            TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path), ckpt_every=3)).run()
    # "crash": a brand-new trainer, fresh state, the same checkpoint directory
    state2, step_fn2 = build(cfg, optimizer="adamw", lr=1e-3, seed=123, device="cpu")
    ds2 = SyntheticLM(cfg.vocab_size, 16, 2, seed=2)
    tr2 = Trainer(state2, step_fn2, ds2,
                  TrainerConfig(total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=3))
    res = tr2.run()
    assert res["final_step"] == 10
    assert ds2.step == 10                      # data cursor restored + advanced
    assert int(tr2.state["step"]) == 10


def test_resume_matches_an_uninterrupted_run(tiny, tmp_path):
    """Checkpoint at step 3, resume in a fresh Trainer to step 6: the
    losses and the final state are those of one 6-step run, bit for
    bit (same CPU, same ops)."""
    cfg, state, step_fn = tiny
    full = Trainer(_copy(state), step_fn, SyntheticLM(cfg.vocab_size, 16, 2, seed=2),
                   TrainerConfig(total_steps=6, log_every=1))
    want = full.run()
    Trainer(_copy(state), step_fn, SyntheticLM(cfg.vocab_size, 16, 2, seed=2),
            TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path), ckpt_every=3)).run()
    fresh, _ = build(cfg, optimizer="adamw", lr=1e-3, seed=5, device="cpu")
    tr = Trainer(fresh, step_fn, SyntheticLM(cfg.vocab_size, 16, 2, seed=7),
                 TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path), ckpt_every=3,
                               log_every=1))
    got = tr.run()
    assert [h["loss"] for h in got["history"]] == [h["loss"] for h in want["history"][3:]]
    for (p, a), (_, b) in zip(paths(full.state), paths(tr.state)):
        assert torch.equal(a, b), p


def test_preemption_signal_saves_and_exits(tiny, tmp_path):
    cfg, state, step_fn = tiny
    ds = SyntheticLM(cfg.vocab_size, 16, 2, seed=2)
    tr = Trainer(_copy(state), step_fn, ds,
                 TrainerConfig(total_steps=1000, ckpt_dir=str(tmp_path), ckpt_every=1000,
                               async_ckpt=True))

    def preempt():
        time.sleep(1.5)
        tr._stop = True   # equivalent to the SIGTERM handler body

    th = threading.Thread(target=preempt)
    th.start()
    res = tr.run()
    th.join()
    assert res["interrupted"]
    assert res["final_step"] < 1000
    assert checkpoint.latest_step(tmp_path) == res["final_step"]


def test_straggler_detection():
    """The watchdog flags steps slower than factor x the rolling median."""
    ds = SyntheticLM(16, 4, 1, seed=0)
    calls = {"n": 0}

    def fake_step(state, batch):
        calls["n"] += 1
        time.sleep(0.25 if calls["n"] == 12 else 0.01)
        return state, {"loss": torch.tensor(1.0)}

    res = Trainer({}, fake_step, ds, TrainerConfig(total_steps=15, straggler_factor=3.0)).run()
    assert res["stragglers"] >= 1
