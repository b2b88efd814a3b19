"""The paper's §8 use case, end to end: DLRM online training where every
batch STREAMS from disaggregated storage over BALBOA RDMA — striped
across all replicas on concurrent QPs, preprocessed tile-by-tile ON THE
DATAPATH (the preprocessing kernel) the moment bytes are acknowledged
(Neg2Zero -> Log, Modulus), and landed directly in pre-sharded device
buffers.  The CPU never touches a feature byte: ``decode_fn`` is
poisoned to prove it.  Training is torch autograd and SGD at lr 0.05,
5 steps a shard.

  python -m repro_torch.examples.dlrm_ingest [--cpu]
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.dlrm import smoke_config
from repro_torch.core.ingest import (BalboaIngest, IngestConfig,
                                     make_dlrm_tile_decoder)
from repro_torch.data import synthetic as syn
from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.models.dlrm import (DLRM, dlrm_params_from_numpy,
                                     ravel_params)

N_SHARDS = 30
STEPS_PER_SHARD = 5
LR = 0.05


def main(device: DeviceLike = None, n_shards: int = N_SHARDS,
         params: Optional[Dict] = None) -> Dict:
    """Stream ``n_shards`` shards into training on ``device`` (default
    the card).  ``params``, the reference's parameter tree as numpy
    arrays, sets the initial weights (else the port's own seeded init).
    Returns the losses, goodputs and overlaps a shard and the trained
    parameters raveled (``flat``)."""
    dev = resolve_device(device)
    cfg = smoke_config()
    rec_w = cfg.n_dense + cfg.n_sparse
    recs_per_pkt = (4096 // 4) // rec_w
    n_pkts = 8                        # packets per shard
    n_rec = recs_per_pkt * n_pkts

    # --- storage shards: RAW records (negative dense, unbounded sparse)
    # in the record-aligned packet layout the stripes preserve
    def shard_fn(i):
        return syn.encode_dlrm_packets(
            syn.dlrm_shard(i, n_rec, cfg.n_dense, cfg.n_sparse))

    def poisoned_decode(raw):
        raise AssertionError("host decode touched payload bytes")

    # Streaming ingest: 2 replicas x 2 QPs, 2-packet fragment tiles.
    # Preprocessing runs per tile (the kernel) as each tile's bytes are
    # acknowledged — process-as-it-arrives.
    ing = BalboaIngest(
        IngestConfig(batch_bytes=n_pkts * 4096, n_storage_nodes=2,
                     qps_per_node=2, tile_pkts=2,
                     link_bw_pkts_per_tick=1),
        None, shard_fn, decode_fn=poisoned_decode,
        tile_to_batch=make_dlrm_tile_decoder(cfg.n_dense, cfg.n_sparse,
                                             cfg.modulus),
        device=dev)

    model = DLRM(cfg, seed=0, device=dev)
    if params is not None:
        model.load_state_dict(dlrm_params_from_numpy(params, device=dev))
    opt = torch.optim.SGD(model.parameters(), lr=LR)

    t0 = time.perf_counter()
    losses, goodputs, overlaps = [], [], []
    for i, (dev_batch, rep) in enumerate(ing.stream_batches(n_shards)):
        goodputs.append(rep.goodput_bytes_per_tick)
        overlaps.append(rep.overlap_efficiency)
        # labels are control-plane metadata (derived from the synthetic
        # rule), not payload bytes
        raw = syn.dlrm_shard(i, n_rec, cfg.n_dense, cfg.n_sparse)
        labels = syn.dlrm_labels(raw, cfg.n_dense, cfg.modulus)
        batch = {"dense": dev_batch["dense"],
                 "sparse": dev_batch["sparse"],
                 "label": to_device(labels, dev)}
        # sanity: tile-granular on-arrival preprocessing == reference
        want = np.log1p(np.maximum(raw[:, :cfg.n_dense], 0))
        np.testing.assert_allclose(batch["dense"].cpu().numpy(), want,
                                   rtol=1e-5)
        for _ in range(STEPS_PER_SHARD):   # a few optimizer steps a shard
            opt.zero_grad(set_to_none=True)
            loss, m = model.loss(batch)
            loss.backward()
            opt.step()
        losses.append(loss.item())
        if i % 10 == 0:
            print(f"[dlrm] shard {i}: loss {losses[-1]:.4f} "
                  f"acc {m['acc'].item():.3f} "
                  f"goodput {rep.goodput_bytes_per_tick:.0f} B/tick "
                  f"overlap {rep.overlap_efficiency:.2f}")
    dt = time.perf_counter() - t0
    print(f"[dlrm] {n_shards} shards ({n_shards * n_rec} records) in "
          f"{dt:.1f}s; loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"mean goodput {np.mean(goodputs):.0f} B/tick, "
          f"mean overlap {np.mean(overlaps):.2f}; "
          f"host payload bytes copied: {ing.host_payload_bytes}")
    assert losses[-1] < losses[0]
    assert ing.host_payload_bytes == 0
    print("dlrm_ingest OK")
    return {"losses": losses, "goodputs": goodputs, "overlaps": overlaps,
            "host_payload_bytes": ing.host_payload_bytes,
            "flat": ravel_params(model).cpu().numpy()}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
