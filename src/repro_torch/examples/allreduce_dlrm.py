"""Data-parallel DLRM gradient exchange over BALBOA collectives — the
ML-fabric story end to end: W workers each train on their own shard of
the paper's §8 recommendation workload, and every optimizer step
exchanges gradients with an **allreduce that actually rides the RDMA
transport** (batched RX engine, retransmission, flow control), with the
in-fabric reduction offload folding the gradient chunks at the switch
(the segmented-reduce kernel on the card).

Each worker's gradient is torch autograd on ``DLRM.loss``, raveled in
the order of the reference's ``ravel_pytree`` (``ravel_params``) and
copied to the host, where the simulated fabric's buffers live.  Checked
against single-process training with the oracle fold: every rank's sum
is bit-identical to ``allreduce_oracle`` and the parameters stay
bit-identical to a model updated with the oracle's sum.

  python -m repro_torch.examples.allreduce_dlrm [--cpu]
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.dlrm import smoke_config
from repro_torch.core.collectives import allreduce_oracle, make_ring_group
from repro_torch.data import synthetic as syn
from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.models.dlrm import (DLRM, dlrm_params_from_numpy,
                                     ravel_params, unravel_params)

WORLD = 4
RECORDS_PER_WORKER = 64
STEPS = 8
LR = 0.05


def worker_batch(cfg, shard_idx: int, device: DeviceLike = None
                 ) -> Dict[str, torch.Tensor]:
    """Preprocessed features + labels for one worker's shard, on
    ``device`` (the on-datapath preprocessing is exercised by
    ``dlrm_ingest``; here the collective is the star)."""
    dev = resolve_device(device)
    raw = syn.dlrm_shard(shard_idx, RECORDS_PER_WORKER,
                         cfg.n_dense, cfg.n_sparse)
    dense = np.log1p(np.maximum(raw[:, :cfg.n_dense], 0)).astype(np.float32)
    sparse = (raw[:, cfg.n_dense:] % cfg.modulus).astype(np.int32)
    labels = syn.dlrm_labels(raw, cfg.n_dense, cfg.modulus)
    return {"dense": to_device(dense, dev), "sparse": to_device(sparse, dev),
            "label": to_device(labels, dev)}


def worker_grad(model: DLRM, batch: Dict[str, torch.Tensor]) -> np.ndarray:
    """One worker's gradient of the mean loss on its batch, raveled in
    ``ravel_pytree``'s order and copied to the host."""
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch)
    loss.backward()
    return ravel_params(model, grad=True).cpu().numpy()


def sgd_apply(model: DLRM, summed: np.ndarray, world: int = WORLD,
              lr: float = LR) -> None:
    """``p - lr * g`` with ``g`` the fabric's sum over ``world`` workers
    averaged on the model's device — the reference's update, op for op."""
    avg = to_device(summed, model.tables.device) / world
    with torch.no_grad():
        for name, g in unravel_params(model, avg).items():
            p = model.get_parameter(name)
            p.copy_(p - lr * g)


def main(device: DeviceLike = None, steps: int = STEPS,
         params: Optional[Dict] = None) -> Dict:
    """Train ``steps`` data-parallel steps at ``smoke_config()`` on
    ``device`` (default the card).  ``params``, the reference's
    parameter tree as numpy arrays, sets the initial weights (else the
    port's own seeded init).  Returns the losses, the final parameters
    raveled (``flat``) and the fabric's counts."""
    dev = resolve_device(device)
    cfg = smoke_config()
    model = DLRM(cfg, seed=0, device=dev)
    if params is not None:
        model.load_state_dict(dlrm_params_from_numpy(params, device=dev))
    oracle = DLRM(cfg, seed=0, device=dev)
    oracle.load_state_dict(model.state_dict())
    n_grad = ravel_params(model).numel()
    print(f"[allreduce-dlrm] {WORLD} workers, {n_grad} gradient elements "
          f"({n_grad * 4 / 1024:.0f} KB) per exchange")

    group = make_ring_group(WORLD, max_bytes=n_grad * 4 + WORLD * 4,
                            offload=True, device=dev)
    batches = [worker_batch(cfg, r, dev) for r in range(WORLD)]

    t0 = time.perf_counter()
    losses: List[float] = []
    for step in range(steps):
        # every worker computes gradients on its own shard...
        flats = [worker_grad(model, b) for b in batches]
        # ...and exchanges them through the fabric (offloaded allreduce)
        summed = group.allreduce(flats)
        want = allreduce_oracle(flats)
        for r in range(WORLD):
            assert (summed[r].view(np.uint8) == want.view(np.uint8)).all(), \
                f"step {step}: rank {r} gradient exchange not bit-identical"
        sgd_apply(model, summed[0])
        # the single-process oracle trains on the same per-worker
        # gradients, averaged with the canonical fold the fabric computes
        sgd_apply(oracle, want)
        with torch.no_grad():
            losses.append(float(np.mean([model.loss(b)[0].item()
                                         for b in batches])))
        print(f"[allreduce-dlrm] step {step}: loss {losses[-1]:.4f} "
              f"(exchange: {group.stats.ticks} fabric ticks total)")

    # distributed == oracle-fold training, bit-for-bit parameter match
    flat_a = ravel_params(model).cpu().numpy()
    flat_b = ravel_params(oracle).cpu().numpy()
    np.testing.assert_array_equal(flat_a.view(np.uint32),
                                  flat_b.view(np.uint32))
    assert steps < 2 or losses[-1] < losses[0], "loss did not decrease"

    red = group.service.reducer
    dt = time.perf_counter() - t0
    print(f"[allreduce-dlrm] {steps} steps in {dt:.1f}s; loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}; switch folded "
          f"{red.bytes_reduced / 1024:.0f} KB across {red.reduced_forwarded} "
          f"fragments ({red.absorbed} contributions absorbed in-fabric); "
          f"params bit-identical to the oracle fold")
    print("allreduce_dlrm OK")
    return {"losses": losses, "flat": flat_a, "ticks": group.stats.ticks,
            "absorbed": red.absorbed, "wall_s": dt, "n_grad": n_grad}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
