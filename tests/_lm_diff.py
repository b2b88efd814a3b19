"""One smoke arch through the reference (jitted, on the CPU) and through
the port from the same weights and inputs: the comparisons of
``tests/test_torch_lm_archs_*.py``.

Tolerances (each test prints the worst error it saw):

* float32 compute: logits (forward, prefill, decode) within
  ``F32_ATOL`` absolute, the loss and its parts within ``F32_LOSS_ATOL``,
  each parameter's gradient within ``GRAD_RTOL`` of that gradient's
  largest magnitude (autograd against ``jax.grad``; float32 sums in
  another order);
* bfloat16 compute (the configs' own): logits within ``BF16_ATOL``, the
  loss within ``BF16_LOSS_ATOL`` — one bf16 rounding (2^-8 relative) per
  product and per residual add, compounded over the layers, and for the
  MoE archs a token now and then routed to another expert when two
  router scores round apart (on another batch, seed 0, deepseek-v3's
  decode logits differed by 0.054 and its loss by 6.5e-3 that way; on
  this one the worst arch differs by 0.023 and 6.8e-4; the smoke
  logits reach about 0.7).
"""
from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _lm_batches import ENC_LEN, lm_batch, prompt_of
from repro.configs import get_smoke_config as jget
from repro.models.model import Model as JModel
from repro_torch.configs import get_smoke_config as tget
from repro_torch.models.model import Model, lm_params_from_numpy

F32_ATOL = 2e-5
F32_LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
BF16_ATOL = 0.1
BF16_LOSS_ATOL = 1e-2

B, S, PREFILL = 2, 24, 20          # decode steps: positions 20..23


def reference(arch: str, compute_dtype: str, grads: bool) -> Dict:
    """The reference's weights (numpy), inputs, and outputs: forward
    logits, loss and metrics (and the gradient tree), the prefill's
    last-token logits and each decode step's logits."""
    cfg = jget(arch).replace(compute_dtype=compute_dtype)
    m = JModel(cfg)
    params = m.init_params(jax.random.key(0))
    batch = lm_batch(cfg, B, S, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def fwd_loss(p):
        loss, metrics = m.loss(p, jb)
        return loss, (metrics, m.forward(p, jb, train=False)[0])

    if grads:
        (loss, (metrics, logits)), g = jax.jit(jax.value_and_grad(
            fwd_loss, has_aux=True))(params)
        g = jax.tree.map(np.asarray, g)
    else:
        loss, (metrics, logits) = jax.jit(fwd_loss)(params)
        g = None
    pre = prompt_of(batch, PREFILL)
    cache = m.init_cache(jax.random.key(1), B, S + 4,
                         enc_len=ENC_LEN if cfg.is_encdec else 0)
    p_logits, cache = jax.jit(m.prefill)(params, {k: jnp.asarray(v) for k, v
                                                  in pre.items()}, cache)
    step = jax.jit(m.decode_step)
    dec = []
    for t in range(PREFILL, S):
        lg, cache = step(params, cache, jnp.asarray(batch["tokens"][:, t:t + 1]),
                         jnp.asarray(t, jnp.int32))
        dec.append(np.asarray(lg, np.float32))
    return {"params": jax.tree.map(np.asarray, params), "batch": batch,
            "logits": np.asarray(logits, np.float32), "loss": float(loss),
            "metrics": {k: np.asarray(v, np.float32)
                        for k, v in metrics.items()},
            "grads": g, "prefill": np.asarray(p_logits, np.float32),
            "decode": dec}


def port(arch: str, compute_dtype: str, ref: Dict, grads: bool) -> Dict:
    """The port's outputs from the reference's weights and inputs."""
    cfg = tget(arch).replace(compute_dtype=compute_dtype)
    m = Model(cfg, device="cpu")
    m.load_state_dict(lm_params_from_numpy(ref["params"], cfg, "cpu"))
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    loss, metrics = m.loss(batch)
    out = {"loss": loss.item(),
           "metrics": {k: v.detach().float().numpy()
                       for k, v in metrics.items()}}
    if grads:
        loss.backward()
        out["grads"] = {n: (p.grad if p.grad is not None
                            else torch.zeros_like(p))
                        for n, p in m.named_parameters()}
    with torch.no_grad():
        out["logits"] = m.forward(batch, train=False)[0].float().numpy()
    pre = {k: torch.from_numpy(v.copy())
           for k, v in prompt_of(ref["batch"], PREFILL).items()}
    cache = m.init_cache(B, S + 4, enc_len=ENC_LEN if cfg.is_encdec else 0)
    p_logits, cache = m.prefill(pre, cache)
    out["prefill"] = p_logits.float().numpy()
    out["decode"] = []
    for t in range(PREFILL, S):
        lg, cache = m.decode_step(cache, batch["tokens"][:, t:t + 1], t)
        out["decode"].append(lg.float().numpy())
    return out


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def grad_errors(arch: str, ref: Dict, mine: Dict) -> Dict[str, float]:
    """Each parameter's gradient error over that gradient's largest
    magnitude (a zero reference gradient: the absolute error)."""
    cfg = tget(arch).replace(compute_dtype="float32")
    want = lm_params_from_numpy(ref["grads"], cfg, "cpu")
    assert sorted(want) == sorted(mine["grads"])
    out = {}
    for name, g in mine["grads"].items():
        w = want[name].float()
        scale = float(w.abs().max())
        err = float((g.float() - w).abs().max())
        out[name] = err / scale if scale > 0 else err
    return out
