"""Optimizers: AdamW and Adafactor (factored second moments), plus
global-norm clipping, the LR schedule and cross-pod gradient compression
— the reference's ``repro.optim.optimizers``, update for update.

A tree here is a dict keyed by the reference's leaf paths, in its leaf
order (``models.params.leaf_groups``); each value is a tensor, or, for a
leaf of a stacked subtree, the list of its layers' tensors (the
reference's ``(layers, ...)`` leaf, one tensor a layer in the port's
``ModuleList``).  Every mean, RMS and norm is taken over the reference's
leaf, so a stacked leaf's statistics span its layers.

Optimizer state is ``{"slots": {path: {slot: tensor}}, "count"}``, the
slots float32 and shaped as the reference's leaf (stacked), the count
int32 — one mapping for the carry and the checkpoint.  ``update`` writes
the new parameters and slots in place and returns the new state.
Arithmetic is float32 throughout, in the reference's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.params import Spec, tree_items
from repro_torch.parallel.sharding import is_distributed

Tree = Dict[str, Any]


def _whole(x) -> torch.Tensor:
    """A tree value as the reference's leaf (a stacked leaf: a copy)."""
    return torch.stack(x) if isinstance(x, list) else x


def _parts(x):
    """A tree value as its tensors: the layers of a stacked leaf."""
    return x if isinstance(x, list) else [x]


def _as(whole: torch.Tensor, like):
    """A reference leaf as a tree value shaped like ``like``."""
    return list(whole.unbind(0)) if isinstance(like, list) else whole


def _map(fn, tree: Tree) -> Tree:
    return {k: [fn(t) for t in v] if isinstance(v, list) else fn(v)
            for k, v in tree.items()}


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a float32 scalar tensor beside ``like``."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_schedule(lr: float, warmup: int, total: int) -> Callable:
    """Linear warmup from 0, then a cosine to 0 at ``total``: the step's
    learning rate as a float32 scalar on the host."""
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = _f32(lr, step) * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = (0.5 * lr) * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return fn


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [sum(torch.sum(torch.square(t.float())) for t in _parts(v))
              for v in tree.values()]
    if is_distributed(leaves[0]):
        return torch.sqrt(_sum_over_mesh(leaves))
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _sum_over_mesh(scalars) -> torch.Tensor:
    """The sum of scalar DTensors (each replicated or partial over each
    mesh axis) in one all-reduce, the reference's combined one: each
    rank adds its parts (a replicated value divided by its copies) and
    the total is left partial over the whole mesh."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = scalars[0].device_mesh
    local = 0.0
    for x in scalars:
        copies = 1
        for m, q in enumerate(x.placements):
            if q.is_replicate():
                copies *= mesh.size(m)
        local = local + x.to_local() / copies
    return DTensor.from_local(local, mesh, [Partial()] * mesh.ndim,
                              run_check=False)


def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale the tree to a global norm of at most ``max_norm``: float32
    leaves in place (the same rounding), others into new tensors."""
    norm = global_norm(tree)
    # max_norm / norm as a division: Python's float / Tensor is a
    # reciprocal and a product in torch, two roundings
    scale = torch.clamp_max(
        torch.div(_f32(max_norm, norm), torch.clamp_min(norm, 1e-9)), 1.0)
    return _map(lambda x: x.mul_(scale) if x.dtype == torch.float32
                else (x.float() * scale).to(x.dtype), tree), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _slots_spec(param_spec, one) -> Dict[str, Any]:
    return {"slots": {path: one(s) for path, s in tree_items(param_spec)},
            "count": Spec((), (), "zeros", "int32")}


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01

    def state_spec(self, param_spec):
        """Spec tree (same logical axes as the params, fp32)."""
        return _slots_spec(param_spec, lambda s: {
            "m": Spec(s.shape, s.axes, "zeros", "float32"),
            "v": Spec(s.shape, s.axes, "zeros", "float32")})

    def update(self, grads: Tree, state, params: Tree, lr: torch.Tensor):
        count = state["count"] + 1
        c = count.float()
        bc1 = 1 - torch.pow(self.b1, c)
        bc2 = 1 - torch.pow(self.b2, c)
        for path, p in params.items():
            slot = state["slots"][path]
            # elementwise: a stacked leaf goes layer by layer, on views
            for i, (g, pi) in enumerate(zip(_parts(grads[path]), _parts(p))):
                m, v = ((slot["m"][i], slot["v"][i]) if isinstance(p, list)
                        else (slot["m"], slot["v"]))
                self._one(g, m, v, pi, bc1, bc2, lr)
        return params, {"slots": state["slots"], "count": count}

    def _one(self, g, m, v, p, bc1, bc2, lr):
        """The reference's ops, one rounding each, in place where the
        value is not needed again."""
        g32 = g.float()
        m.mul_(self.b1).add_(g32 * (1 - self.b1))
        v.mul_(self.b2).add_(torch.square(g32).mul_(1 - self.b2))
        upd = (m / bc1).div_(torch.sqrt(v / bc2).add_(self.eps))
        upd.add_(p.float() * self.weight_decay)
        p.copy_(p.float() - upd.mul_(lr))


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018) — memory-lean for the 200B+ archs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Adafactor:
    decay: float = 0.8            # t^-decay second-moment decay exponent
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def state_spec(self, param_spec):
        def one(s: Spec):
            if len(s.shape) >= 2:
                return {
                    "v_row": Spec(s.shape[:-1], s.axes[:-1], "zeros",
                                  "float32"),
                    "v_col": Spec(s.shape[:-2] + s.shape[-1:],
                                  s.axes[:-2] + s.axes[-1:], "zeros",
                                  "float32"),
                }
            return {"v": Spec(s.shape, s.axes, "zeros", "float32")}
        return _slots_spec(param_spec, one)

    def update(self, grads: Tree, state, params: Tree, lr: torch.Tensor):
        count = state["count"] + 1
        c = count.float()
        beta2 = 1.0 - torch.pow(c, -self.decay)
        for path, p in params.items():
            # the statistics span the whole leaf: a stacked leaf's layers
            # are stacked (a stacked norm scale (L, d) is factored, its
            # v_col averaged across the layers)
            new_p = self._one(_whole(grads[path]), state["slots"][path],
                              _whole(p), beta2, lr)
            for pi, ni in zip(_parts(p), _parts(_as(new_p, p))):
                pi.copy_(ni)
        return params, {"slots": state["slots"], "count": count}

    def _one(self, g, slot, p, beta2, lr):
        g32 = g.float()
        g2 = torch.square(g32) + self.eps
        if "v_row" in slot:
            v_row = beta2 * slot["v_row"] + (1 - beta2) * torch.mean(g2, -1)
            v_col = beta2 * slot["v_col"] + (1 - beta2) * torch.mean(g2, -2)
            row_mean = torch.mean(v_row, -1, keepdim=True)
            r = v_row / torch.clamp_min(row_mean, self.eps)
            upd = g32 / (torch.sqrt(r)[..., None]
                         * torch.sqrt(v_col)[..., None, :] + self.eps)
            slot["v_row"].copy_(v_row)
            slot["v_col"].copy_(v_col)
        else:
            v = beta2 * slot["v"] + (1 - beta2) * g2
            upd = g32 / (torch.sqrt(v) + self.eps)
            slot["v"].copy_(v)
        # update clipping by RMS (Adafactor's d=1 rule)
        rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
        upd = upd / torch.clamp_min(rms / self.clip_threshold, 1.0)
        if self.weight_decay:
            upd = upd + self.weight_decay * p.float()
        return (p.float() - lr * upd).to(p.dtype)


def make_optimizer(name: str, weight_decay: float = 0.01):
    if name == "adamw":
        return AdamW(weight_decay=weight_decay)
    if name == "adafactor":
        return Adafactor()
    raise ValueError(name)


# ---------------------------------------------------------------------------
# Cross-pod gradient compression (paper-adjacent: the pod axis is the
# RDMA/DCI domain BALBOA serves; compressing what crosses it is the
# distributed-optimization analogue of on-NIC stream processing).
# ---------------------------------------------------------------------------

def compress_grads_bf16(grads: Tree) -> Tree:
    """Quantize gradients to bf16 before the cross-pod all-reduce: 2
    bytes/element across the pod axis instead of 4."""
    return _map(lambda g: g.to(torch.bfloat16), grads)


def topk_error_feedback(grads: Tree, residual: Tree, fraction: float
                        ) -> Tuple[Tree, Tree]:
    """Error-feedback top-k sparsification (per leaf).  Returns
    (sparse_grads, new_residual); magnitude top-k keeps ``fraction`` of
    each leaf's entries (ties at the threshold kept)."""
    sparse_out, resid_out = {}, {}
    for path, g in grads.items():
        g32 = _whole(g).float() + _whole(residual[path])
        flat = g32.reshape(-1)
        k = max(1, int(flat.numel() * fraction))
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        sparse = torch.where(torch.abs(g32) >= thresh, g32, 0.0)
        dtype = _parts(g)[0].dtype
        sparse_out[path] = _as(sparse.to(dtype), g)
        resid_out[path] = _as(g32 - sparse, g)
    return sparse_out, resid_out


