"""Training loop with fault tolerance (checkpoint/auto-resume) and
failure injection for tests — the reference's ``repro.train.loop``.

The model holds its parameters; the loop carries the optimizer state
and checkpoints ``{"params": the reference's parameter tree, "opt": the
optimizer state}``, so it resumes from a checkpoint of either package.

On a mesh (``make_host_mesh``: one process a rank), every rank holds the
whole model (parameters replicated), takes its "batch" block of every
batch by the train rules, and averages its gradients over "data" by one
all-reduce before the clip, so the clip and the update see the global
batch's gradient, as the reference's single program does.  Rank 0
writes the checkpoints.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.common.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.device import to_device
from repro_torch.models import params as P
from repro_torch.models.model import Model, input_specs
from repro_torch.parallel import sharding as sh
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

    def __init__(self, model: Model, tc: TrainConfig, mesh=None,
                 rules=None):
        self.model = model
        self.tc = tc
        self.mesh = mesh
        self.rules = rules or sh.make_rules("train")
        if (mesh is not None and model.cfg.expert_sharding == "ep_sm"
                and dict(zip(mesh.mesh_dim_names, mesh.shape))["data"] > 1):
            raise NotImplementedError(
                "the ep_sm MoE takes the global batch on every rank; the "
                "trainer gives each data rank its block")
        self.step_fn, self.opt = make_train_step(model, tc)
        self.ckpt = Checkpointer(tc.checkpoint_dir)
        self._writes = mesh is None or dist.get_rank() == 0

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
        if self._writes:
            self.ckpt.save(step, {"params": P.params_to_numpy(self.model),
                                  "opt": opt_state})

    def _local(self, batch: Dict[str, torch.Tensor]):
        """This rank's block of each input, by the train rules."""
        b, s = batch["tokens"].shape
        _, axes = input_specs(self.model.cfg, ShapeConfig(
            "host", seq_len=s, global_batch=b, kind="train"))
        return {k: sh.NamedSharding(self.mesh, sh.resolve_spec(
            v.shape, axes[k], self.mesh, self.rules)).local_block(v)
            for k, v in batch.items()}

    def _step(self, opt_state, batch, step: int):
        """One step; on a mesh, the gradients and the metrics averaged
        over "data" (one all-reduce, in float32) between the backward and
        the update."""
        if self.mesh is None:
            return self.step_fn(opt_state, batch, step)
        with sh.activate(self.mesh, self.rules):
            metrics = self.step_fn.forward_backward(self._local(batch))
        group = self.mesh.get_group("data")
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        keys = sorted(metrics)
        parts = [g.float() for g in grads] + [metrics[k].float() for k in keys]
        flat = funcol.wait_tensor(funcol.all_reduce(
            _flatten_dense_tensors(parts), "sum", group))
        flat.div_(dist.get_world_size(group))
        avg = _unflatten_dense_tensors(flat, parts)
        for g, a in zip(grads, avg):
            g.copy_(a)
        metrics = dict(zip(keys, avg[len(grads):]))
        return self.step_fn.apply_update(opt_state, metrics, step)

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
                opt_state, metrics = self._step(opt_state, batch, step)
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
