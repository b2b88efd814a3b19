"""Step builders of the port — the reference's ``repro.train.step``: the
train step (gradient accumulation over microbatches, bf16 gradient
compression, global-norm clipping, the scheduled learning rate, the
optimizer update, DeepSeek-V3's aux-loss-free gate-bias update) and the
serving steps (prefill, greedy decode).

The model holds its parameters, so a step takes no parameter tree (the
reference's take it first): the train step updates the model's
parameters in place and takes ``(opt_state, batch, step)``."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.common.config import TrainConfig
from repro_torch.models import params as P
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import (clip_by_global_norm,
                                          compress_grads_bf16,
                                          cosine_schedule, make_optimizer)

GATE_BIAS_LR = 0.001      # DeepSeek-V3 aux-loss-free bias update rate


@torch.no_grad()
def _update_gate_bias(model: torch.nn.Module, expert_load: torch.Tensor):
    """Aux-loss-free load balancing (V3): nudge every router gate bias
    against the measured violation sign (in place)."""
    mean = torch.mean(expert_load)
    delta = GATE_BIAS_LR * torch.sign(mean - expert_load)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] == "gate_bias":
            p.add_(delta.to(p.dtype))


def _slice_batch(batch: Dict[str, torch.Tensor], i: int, size: int,
                 full_b: int) -> Dict[str, torch.Tensor]:
    """Microbatch ``i``: the batch dim is dim 0 where it has the batch's
    size, else dim 1 (``mrope_pos`` is (3, B, S))."""
    def sl(x):
        if x.ndim >= 1 and x.shape[0] == full_b:
            return x.narrow(0, i * size, size)
        if x.ndim >= 2 and x.shape[1] == full_b:
            return x.narrow(1, i * size, size)
        return x
    return {k: sl(v) for k, v in batch.items()}


def make_train_step(model: Model, tc: TrainConfig,
                    total_steps: Optional[int] = None):
    """Returns ``(train_step, optimizer)``.  ``train_step(opt_state,
    batch, step)`` -> ``(opt_state, metrics)``, the metrics (``loss``,
    ``xent``, ``aux``, ``grad_norm``, ``lr``) as scalar tensors; it is
    ``train_step.apply_update(opt_state, train_step.forward_backward(
    batch), step)``."""
    cfg = model.cfg
    opt = make_optimizer(cfg.optimizer, tc.weight_decay)
    schedule = cosine_schedule(tc.learning_rate, tc.warmup_steps,
                               total_steps or tc.steps)
    params = P.leaf_groups(model)

    def grad_of(batch) -> Dict[str, torch.Tensor]:
        """One backward pass, its gradients added into ``.grad``."""
        loss, metrics = model.loss(batch)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def forward_backward(batch) -> Dict[str, torch.Tensor]:
        """The gradients into ``.grad``; returns the loss's metrics."""
        model.zero_grad(set_to_none=True)
        if tc.microbatches == 1:
            return grad_of(batch)
        # gradient accumulation: the microbatches' gradients summed in
        # order into .grad, then scaled, as are the metrics
        full_b = batch["tokens"].shape[0]
        size = full_b // tc.microbatches
        metrics = grad_of(_slice_batch(batch, 0, size, full_b))
        for i in range(1, tc.microbatches):
            m = grad_of(_slice_batch(batch, i, size, full_b))
            metrics = {k: metrics[k] + m[k] for k in metrics}
        inv = 1.0 / tc.microbatches
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(inv)
        return {k: v * inv for k, v in metrics.items()}

    @torch.no_grad()
    def apply_update(opt_state, metrics, step: int):
        """From the gradients in ``.grad`` (cleared): compression,
        clipping, the scheduled update, the gate biases."""
        # a parameter that took no part in the loss has gradient 0
        grads = {path: [_grad(t) for t in v] if isinstance(v, list)
                 else _grad(v) for path, v in params.items()}
        model.zero_grad(set_to_none=True)
        if tc.pod_grad_compression == "bf16":
            grads = compress_grads_bf16(grads)
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
        lr = schedule(step)
        _, opt_state = opt.update(grads, opt_state, params, lr)
        del grads
        if cfg.aux_free_bias:
            _update_gate_bias(model, metrics["expert_load"])
        return opt_state, {
            "loss": metrics["loss"], "xent": metrics["xent"],
            "aux": metrics["aux"], "grad_norm": gnorm, "lr": lr,
        }

    def train_step(opt_state, batch, step: int):
        return apply_update(opt_state, forward_backward(batch), step)

    # the two halves, for a caller that times or traces them apart
    train_step.forward_backward = forward_backward
    train_step.apply_update = apply_update
    return train_step, opt


def _grad(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(batch, cache):
        logits, new_cache = model.prefill(batch, cache)
        return logits, new_cache
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(cache, tokens: torch.Tensor, index: int):
        logits, new_cache = model.decode_step(cache, tokens, index)
        # greedy next token (serving returns tokens, not logits, to keep
        # the host <-> device traffic at O(batch))
        # taken along dim 0 of the transpose: on vocab-sharded DTensor
        # logits, DTensor gathers each rank's max and its index, and its
        # gather of a (B, 1) block along dim 1 fails; the first maximal
        # index either way
        next_tok = torch.argmax(logits[:, -1, :].t(), dim=0).to(torch.int32)
        return next_tok[:, None], new_cache
    return decode_step
