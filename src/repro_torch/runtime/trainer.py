"""Fault-tolerant training loop (port of ``repro.runtime.trainer``).

  * checkpoint/restart: ``CheckpointManager`` (atomic, async, LOPC
    codecs: with no error bound every float leaf is ``lopc-lossless``,
    kernels 8 and 9 on save and 8's inverse on restore); resume is
    exact: the data pipeline is a pure function of the step.  The
    checkpoint holds ``{"params", "opt"}`` in the reference's layout
    (``models.convert``), so a checkpoint written by either package's
    trainer resumes in the other's.
  * preemption: a SIGTERM/SIGINT handler checkpoints before exit.
  * step retry: a step that raises (injected through ``fault_hook`` in
    tests; a non-finite loss raises before the update writes anything)
    retries from the in-memory state up to ``max_retries`` times, then
    restores the last checkpoint.
  * straggler mitigation: per-step wall times are tracked; a step slower
    than ``straggler_factor`` x the rolling median raises a counter and
    calls ``on_straggler``.
"""
from __future__ import annotations

import json
import signal
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import SyntheticLMStream
from ..engine.engine import resolve_device
from ..models.config import ModelConfig
from ..models.convert import (
    opt_from_reference,
    opt_to_reference,
    params_from_reference,
    params_to_reference,
)
from .steps import init_train_state, make_train_step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 3
    global_batch: int = 8
    seq_len: int = 64
    base_lr: float = 3e-4
    max_retries: int = 2
    straggler_factor: float = 3.0
    grad_compression: bool = False
    metrics_path: str | None = None
    stop_after: int | None = None  # simulate preemption at this step


@dataclass
class TrainerState:
    step: int = 0
    straggler_events: int = 0
    retries: int = 0
    losses: list = field(default_factory=list)


class Trainer:
    """Trains ``cfg`` on ``device`` (``"cuda"`` unless the caller passes
    ``"cpu"``); the checkpoint codecs run there too."""

    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 step_fn=None, shardings=None,
                 on_straggler: Callable | None = None,
                 fault_hook: Callable | None = None, device="cuda"):
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.state = TrainerState()
        self.stream = SyntheticLMStream(cfg, tc.global_batch, tc.seq_len)
        self.ckpt = CheckpointManager(tc.ckpt_dir, keep=tc.keep,
                                      device=self.device)
        self.on_straggler = on_straggler or (lambda step, dt: None)
        self.fault_hook = fault_hook  # tests inject failures/delays here
        self.shardings = shardings
        self._stop = False

        grad_transform = None
        if tc.grad_compression:
            from ..distributed.compression import make_error_feedback_compressor

            grad_transform = make_error_feedback_compressor()
        self._step_fn = step_fn or make_train_step(
            cfg, grad_transform=grad_transform, base_lr=tc.base_lr,
            total_steps=tc.total_steps)
        self._grad_compression = tc.grad_compression

    # ------------------------------------------------------------ state

    def init_state(self, seed: int = 0):
        """A model made from ``seed`` and its AdamW state (with the
        error-feedback buffer under gradient compression)."""
        model, opt = init_train_state(self.cfg, seed, self.device)
        if self._grad_compression:
            from ..distributed.compression import init_error_feedback

            opt["ef"] = init_error_feedback(dict(model.named_parameters()))
        return model, opt

    def checkpoint_tree(self, model, opt) -> dict:
        """``{"params", "opt"}`` in the reference's layout."""
        return {"params": params_to_reference(model.state_dict(), self.cfg),
                "opt": opt_to_reference(opt, self.cfg)}

    def try_restore(self, model, opt):
        restored, step = self.ckpt.restore_latest(
            self.checkpoint_tree(model, opt), shardings=self.shardings)
        if restored is None:
            return model, opt, 0
        model.load_state_dict(params_from_reference(restored["params"],
                                                    self.cfg))
        opt = opt_from_reference(restored["opt"], self.cfg, self.device)
        return model, opt, step + 1

    def _save(self, step: int, model, opt) -> None:
        self.ckpt.save(step, self.checkpoint_tree(model, opt))

    # ------------------------------------------------------------- loop

    def run(self, seed: int | None = None, params=None, opt=None,
            resume: bool = True):
        """Train to ``total_steps`` from ``params`` (a ``Model``) and
        ``opt``, or from a model made from ``seed`` (default 0); returns
        the final ``(model, opt)``."""
        if params is None:
            params, opt = self.init_state(0 if seed is None else seed)
        start = 0
        if resume:
            params, opt, start = self.try_restore(params, opt)
        self.state.step = start

        def _sig(_signum, _frame):
            self._stop = True

        old_term = signal.signal(signal.SIGTERM, _sig)
        old_int = signal.signal(signal.SIGINT, _sig)
        step_times: list[float] = []
        try:
            step = start
            while step < self.tc.total_steps and not self._stop:
                if self.tc.stop_after is not None and step >= self.tc.stop_after:
                    self._stop = True  # simulated preemption (tests)
                    break
                batch = self.stream.batch_at(step)
                t0 = time.monotonic()
                attempt = 0
                restored = False
                while True:
                    try:
                        if self.fault_hook is not None:
                            self.fault_hook(step, attempt)
                        params, opt, metrics = self._step_fn(params, opt, batch)
                        loss = float(metrics["loss"])
                        if not np.isfinite(loss):
                            raise FloatingPointError(f"non-finite loss at {step}")
                        break
                    except Exception:  # noqa: BLE001
                        attempt += 1
                        self.state.retries += 1
                        if self.state.retries > 3 * (self.tc.max_retries + 1):
                            raise  # persistent failure: surface it
                        if attempt > self.tc.max_retries:
                            # fall back to the last durable state and
                            # refetch the (possibly different) step's batch
                            self.ckpt.wait()
                            params, opt, step = self.try_restore(params, opt)
                            restored = True
                            break
                if restored:
                    self.state.step = step
                    continue
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.monotonic() - t0
                if len(step_times) >= 5:
                    med = statistics.median(step_times[-20:])
                    if dt > self.tc.straggler_factor * med:
                        self.state.straggler_events += 1
                        self.on_straggler(step, dt)
                step_times.append(dt)
                self.state.losses.append(loss)
                self._log(step, loss, dt)
                step += 1
                self.state.step = step
                if step % self.tc.ckpt_every == 0 or step == self.tc.total_steps:
                    self._save(step - 1, params, opt)
            if self._stop:  # preemption: durable exit
                self._save(self.state.step - 1, params, opt)
        finally:
            self.ckpt.wait()
            signal.signal(signal.SIGTERM, old_term)
            signal.signal(signal.SIGINT, old_int)
        return params, opt

    def _log(self, step, loss, dt):
        if self.tc.metrics_path:
            with open(self.tc.metrics_path, "a") as f:
                f.write(json.dumps({"step": step, "loss": round(loss, 5),
                                    "seconds": round(dt, 4)}) + "\n")
