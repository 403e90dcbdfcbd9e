"""Fault-tolerant training loop: the port of ``repro.train.trainer``, run
eagerly (the reference's ``jit`` switch has no counterpart).

Production behaviors, all exercised by tests:
  * periodic (optionally async) checkpoints incl. the data cursor,
  * auto-resume from the latest checkpoint (crash/preemption restart),
  * preemption signal (SIGTERM/SIGINT) -> final checkpoint + clean exit,
  * straggler watchdog: per-step wall time tracked against a rolling
    median; outliers are logged and counted (on real fleets this signal
    feeds the reschedule policy; here it is surfaced in metrics).
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

from . import checkpoint as ckpt


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_last: int = 3
    async_ckpt: bool = False
    log_every: int = 10
    straggler_factor: float = 3.0     # step > factor * median -> straggler
    straggler_window: int = 20


class Trainer:
    def __init__(
        self,
        state: Any,
        step_fn: Callable,
        dataset,
        tcfg: TrainerConfig,
        batch_transform: Optional[Callable] = None,
    ):
        self.state = state
        self.step_fn = step_fn
        self.dataset = dataset
        self.tcfg = tcfg
        self.batch_transform = batch_transform or (lambda b: b)
        self.history: List[Dict[str, float]] = []
        self.step_times: List[float] = []
        self.stragglers = 0
        self._stop = False
        self._ckpt_thread = None

    # --- fault tolerance -----------------------------------------------------
    def _install_signals(self):
        def handler(signum, frame):
            self._stop = True

        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:      # non-main thread (tests)
            pass

    def maybe_resume(self) -> int:
        if not self.tcfg.ckpt_dir:
            return 0
        last = ckpt.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return 0
        self.state, extras, step = ckpt.restore(
            self.tcfg.ckpt_dir, last, self.state
        )
        if "data_state" in extras and hasattr(self.dataset, "restore"):
            self.dataset.restore(extras["data_state"])
        return step

    def _checkpoint(self, step: int):
        if not self.tcfg.ckpt_dir:
            return
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        extras = {"data_state": self.dataset.state()} if hasattr(
            self.dataset, "state") else {}
        self._ckpt_thread = ckpt.save(
            self.tcfg.ckpt_dir, step, self.state, extras,
            keep_last=self.tcfg.keep_last, async_write=self.tcfg.async_ckpt,
        )

    # --- straggler watchdog ----------------------------------------------------
    def _watch(self, dt: float) -> bool:
        self.step_times.append(dt)
        win = self.step_times[-self.tcfg.straggler_window:]
        if len(win) >= 5:
            med = statistics.median(win)
            if dt > self.tcfg.straggler_factor * med:
                self.stragglers += 1
                return True
        return False

    # --- loop --------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        self._install_signals()
        start = self.maybe_resume()
        step = start
        while step < self.tcfg.total_steps and not self._stop:
            batch = self.batch_transform(self.dataset.next_batch())
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            straggle = self._watch(dt)
            step += 1
            if step % self.tcfg.log_every == 0 or step == self.tcfg.total_steps:
                self.history.append(
                    {"step": step, "loss": loss, "sec": dt,
                     "straggler": bool(straggle)}
                )
            if self.tcfg.ckpt_dir and step % self.tcfg.ckpt_every == 0:
                self._checkpoint(step)
        # Final (or preemption) checkpoint.
        self._checkpoint(step)
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        return {
            "final_step": step,
            "interrupted": self._stop,
            "history": self.history,
            "stragglers": self.stragglers,
        }
