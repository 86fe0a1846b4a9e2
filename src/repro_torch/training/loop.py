"""Fault-tolerant training loop (the port of ``repro.training.loop``).

Behaviours, as in ``repro``:
  * checkpoint/restart — async checkpoints every ``ckpt_every`` steps and
    a synchronous one at the end; on start the loop restores the newest
    valid checkpoint and, because the data pipeline is a pure function of
    the step, resumes the exact token stream.  The files are ``repro``'s
    format (``repro_torch.checkpoint``), with ``repro``'s leaf names, so
    either package's trainer resumes the other's run;
  * preemption tolerance — SIGTERM/SIGINT end the loop after the current
    step with a final synchronous checkpoint;
  * straggler watchdog — a step slower than ``straggler_factor`` x the
    running median is counted and logged;
  * gradient compression — optional int8 + error feedback on the
    gradients (``repro_torch.optim.compression``).

The step runs on ``device``: the card unless the caller asks for the CPU;
without CUDA it raises, and it never moves to the CPU by itself.  The
step time is taken on the host after the step's metrics are read back,
which waits for the card.
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.engine import resolve_device
from repro_torch.data import SyntheticCorpus
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    peak_lr: float = 3e-4
    warmup: int = 20
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 2
    log_every: int = 10
    compress_grads: bool = False
    straggler_factor: float = 3.0
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 log: Callable[[str], None] = print, device="cuda"):
        self.cfg = cfg
        self.tc = tc
        self.log = log
        self.device = resolve_device(device)
        lr_fn = lambda s: optim.cosine_schedule(  # noqa: E731
            s, peak_lr=tc.peak_lr, warmup=tc.warmup, total=tc.steps)
        self._step_fn = M.make_train_step(cfg, lr_fn=lr_fn,
                                          compress=tc.compress_grads)
        self.data = SyntheticCorpus(
            vocab=cfg.vocab, seq_len=tc.seq_len, global_batch=tc.global_batch,
            seed=tc.seed, n_codebooks=cfg.n_codebooks)
        self.ckpt = (CheckpointManager(tc.ckpt_dir, keep=tc.ckpt_keep)
                     if tc.ckpt_dir else None)
        self.metrics_history: List[Dict] = []
        self.straggler_steps = 0
        self._stop = False

    # ---------------------------------------------------------------- state
    def init_state(self) -> Dict:
        """Parameters drawn from a ``torch.Generator`` on the device seeded
        with ``tc.seed`` (the port's own draws, not ``repro``'s bits),
        zero AdamW moments, the compression residual when compressing,
        and step 0."""
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = init_params(M.param_specs(self.cfg), gen, self.device)
        opt = optim.adamw_init(params)
        comp = optim.compress_init(params) if self.tc.compress_grads else None
        return {"params": params, "opt": opt, "comp": comp,
                "step": np.zeros((), np.int32)}

    def _restore(self, state):
        if self.ckpt is None:
            return state, 0
        step, restored = self.ckpt.restore_latest(state, device=self.device)
        if step is None:
            return state, 0
        self.log(f"[trainer] restored checkpoint at step {step}")
        return restored, int(step)

    # ----------------------------------------------------------------- run
    def run(self, state=None) -> Dict:
        tc = self.tc
        state = state or self.init_state()
        state, start = self._restore(state)

        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(
                    sig, lambda *_: setattr(self, "_stop", True))
            except ValueError:                 # non-main thread
                pass

        times: List[float] = []
        step = start
        try:
            while step < tc.steps and not self._stop:
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in self.data.batch(step).items()}
                t0 = time.perf_counter()
                step_t = torch.tensor(step, dtype=torch.int32,
                                      device=self.device)
                if tc.compress_grads:
                    (state["params"], state["opt"], state["comp"], metrics
                     ) = self._step_fn(state["params"], state["opt"],
                                       state["comp"], batch, step_t)
                else:
                    (state["params"], state["opt"], metrics
                     ) = self._step_fn(state["params"], state["opt"], batch,
                                       step_t)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                times.append(dt)
                if len(times) >= 5:
                    med = statistics.median(times)
                    if dt > tc.straggler_factor * med and step > start + 1:
                        self.straggler_steps += 1
                        self.log(f"[watchdog] step {step} took {dt:.2f}s "
                                 f"(median {med:.2f}s) — straggler event")
                metrics["step_time_s"] = dt
                metrics["step"] = step
                self.metrics_history.append(metrics)
                if step % tc.log_every == 0:
                    self.log(f"[trainer] step {step:5d} "
                             f"loss={metrics['loss']:.4f} "
                             f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms")
                step += 1
                state["step"] = np.asarray(step, np.int32)
                if self.ckpt and step % tc.ckpt_every == 0:
                    self.ckpt.save_async(step, state)
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
            if self.ckpt:
                if self._stop:
                    self.log("[trainer] preemption signal — final checkpoint")
                self.ckpt.save_sync(step, state)
        return {"state": state, "final_step": step,
                "history": self.metrics_history,
                "straggler_steps": self.straggler_steps,
                "preempted": self._stop}
