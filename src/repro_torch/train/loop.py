"""Training loop with fault tolerance (checkpoint/auto-resume) and
failure injection for tests — the reference's ``repro.train.loop``.

The model holds its parameters; the loop carries the optimizer state
and checkpoints ``{"params": the reference's parameter tree, "opt": the
optimizer state}``, so it resumes from a checkpoint of either package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.device import to_device
from repro_torch.models import params as P
from repro_torch.models.model import Model
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainResult:
    steps_run: int
    final_loss: float
    losses: list
    resumed_from: Optional[int]
    wall_s: float


class Trainer:
    """Fault-tolerant trainer: init-or-resume, checkpoint every N steps,
    survives injected crashes by restarting from the latest step.  Runs
    on the model's device."""

    def __init__(self, model: Model, tc: TrainConfig, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "the port trains on one device: no mesh placement yet")
        self.model = model
        self.tc = tc
        self.step_fn, self.opt = make_train_step(model, tc)
        self.ckpt = Checkpointer(tc.checkpoint_dir)

    def init_state(self, seed: int = 0):
        """Re-draw the model's parameters from ``seed`` (a CPU generator,
        whatever the device) and return a zero optimizer state on the
        model's device (every slot's spec is "zeros": nothing is drawn
        from the generator ``init`` takes)."""
        self.model.init_params(seed)
        ospec = self.opt.state_spec(self.model.param_spec())
        return P.init(ospec, torch.Generator(), "float32", self.model.device)

    def _restore(self, opt_state):
        like = {"params": P.shapes(self.model.param_spec(),
                                   self.model.cfg.param_dtype),
                "opt": opt_state}
        step, state = self.ckpt.restore(like)
        self.model.load_state_dict(P.params_from_numpy(
            state["params"], self.model.param_spec(), self.model.device,
            self.model.cfg.param_dtype))
        return step, state["opt"]

    def _save(self, step: int, opt_state):
        self.ckpt.save(step, {"params": P.params_to_numpy(self.model),
                              "opt": opt_state})

    def run(self, batches: Iterator[Dict[str, np.ndarray]],
            steps: Optional[int] = None,
            crash_at: Optional[int] = None) -> TrainResult:
        """Train; if a checkpoint exists in tc.checkpoint_dir, resume.
        ``crash_at``: raise at that step (failure-injection for tests)."""
        t0 = time.time()
        steps = steps or self.tc.steps
        resumed_from = None
        opt_state = self.init_state(self.tc.seed)
        start = 0
        if self.ckpt.latest_step() is not None:
            start, opt_state = self._restore(opt_state)
            resumed_from = start
        losses = []
        dev = self.model.device
        try:
            for i, batch in enumerate(batches):
                step = start + i
                if step >= steps:
                    break
                if crash_at is not None and step == crash_at:
                    raise RuntimeError(f"injected failure at step {step}")
                batch = {k: to_device(v, dev) for k, v in batch.items()}
                opt_state, metrics = self.step_fn(opt_state, batch, step)
                loss = float(metrics["loss"])
                losses.append(loss)
                if step % self.tc.log_every == 0:
                    print(f"[train] step {step} loss {loss:.4f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"gnorm {float(metrics['grad_norm']):.3f}",
                          flush=True)
                if (step + 1) % self.tc.checkpoint_every == 0:
                    self._save(step + 1, opt_state)
        finally:
            # crash consistency: an async save started before a crash
            # must be durable before the failure propagates, or the
            # resume path would silently restart from an older step
            self.ckpt.wait()
        return TrainResult(len(losses), losses[-1] if losses else float("nan"),
                           losses, resumed_from, time.time() - t0)


def lm_batch_iterator(cfg: ModelConfig, batch: int, seq: int,
                      n: int = 10**9, seed: int = 0):
    from repro_torch.data.synthetic import lm_shard
    i = 0
    while i < n:
        yield lm_shard(i, batch, seq, cfg.vocab, seed=seed)
        i += 1
