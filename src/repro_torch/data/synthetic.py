"""Synthetic data: LM token shards and DLRM records, with byte-level
shard encodings so the same data can travel the BALBOA RDMA path
(disaggregated storage -> service chain -> device).

Pure numpy, kept as a copy of the reference's ``repro.data.synthetic``
(the port imports nothing of ``repro``): the same seeds must give the
same records in both packages, which tests/test_torch_ingest.py pins."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# LM token streams (Zipfian, with enough structure that loss decreases)
# ---------------------------------------------------------------------------

def lm_shard(index: int, batch: int, seq: int, vocab: int,
             seed: int = 1234) -> Dict[str, np.ndarray]:
    """Deterministic (index, seed) -> {tokens, targets}.  A simple
    k-gram Markov stream: next token = (a * prev + c) % vocab with
    Zipf-ish noise — learnable structure for the e2e examples."""
    rng = np.random.default_rng(seed + index)
    a = 31 * (seed % 7 + 1)        # one consistent rule per stream
    toks = np.zeros((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, batch)
    noise = (rng.random((batch, seq)) < 0.15)
    rand = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    for t in range(seq):
        nxt = (a * toks[:, t] + 7) % vocab
        toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def encode_lm_shard(batch: Dict[str, np.ndarray]) -> np.ndarray:
    """Pack an LM batch into bytes for RDMA transport."""
    b, s = batch["tokens"].shape
    header = np.array([0x4C4D, b, s], np.int32)     # 'LM'
    body = np.concatenate([batch["tokens"].reshape(-1),
                           batch["targets"].reshape(-1)]).astype(np.int32)
    return np.concatenate([header, body]).view(np.uint8)


def decode_lm_shard(raw: np.ndarray) -> Dict[str, np.ndarray]:
    words = np.frombuffer(raw.tobytes(), np.int32)
    assert words[0] == 0x4C4D, "bad LM shard magic"
    b, s = int(words[1]), int(words[2])
    body = words[3:3 + 2 * b * s]
    return {"tokens": body[:b * s].reshape(b, s).copy(),
            "targets": body[b * s:].reshape(b, s).copy()}


# ---------------------------------------------------------------------------
# DLRM records (paper §8: dense + sparse features per record)
# ---------------------------------------------------------------------------

def dlrm_shard(index: int, n_records: int, n_dense: int = 13,
               n_sparse: int = 26, seed: int = 99) -> np.ndarray:
    """Raw (UNpreprocessed) records as int32: dense features may be
    negative / large (need Neg2Zero + Log), sparse ids exceed the table
    range (need Modulus).  Label = f(features) baked into record 0's low
    bit via a synthetic rule (decoded after preprocessing)."""
    rng = np.random.default_rng(seed + index)
    dense = rng.integers(-100, 100_000, (n_records, n_dense)).astype(np.int32)
    sparse = rng.integers(0, 1 << 30, (n_records, n_sparse)).astype(np.int32)
    return np.concatenate([dense, sparse], axis=1)


def dlrm_labels(recs: np.ndarray, n_dense: int, modulus: int) -> np.ndarray:
    """Synthetic ground truth: click iff a hash of the true (post-
    preprocessing) features crosses a threshold — learnable."""
    dense = np.log1p(np.maximum(recs[:, :n_dense].astype(np.float64), 0))
    sparse = recs[:, n_dense:] % modulus
    score = dense.sum(1) / n_dense + (sparse % 7).mean(1)
    return (score > np.median(score)).astype(np.float32)


def encode_dlrm_shard(recs: np.ndarray) -> np.ndarray:
    n, w = recs.shape
    header = np.array([0x444C, n, w], np.int32)     # 'DL'
    return np.concatenate([header, recs.reshape(-1)]).view(np.uint8)


def decode_dlrm_shard(raw: np.ndarray) -> Dict[str, np.ndarray]:
    words = np.frombuffer(raw.tobytes(), np.int32)
    assert words[0] == 0x444C, "bad DLRM shard magic"
    n, w = int(words[1]), int(words[2])
    recs = words[3:3 + n * w].reshape(n, w).copy()
    return {"records": recs}


def encode_dlrm_packets(recs: np.ndarray, mtu: int = 4096) -> np.ndarray:
    """Pack records into an MTU-ALIGNED packet stream: each packet
    carries as many whole records as fit (``(mtu//4) // record_words``),
    zero-padded to the packet boundary.  This is the record-aligned
    layout the streaming ingest stripes across QPs — no record ever
    straddles a packet (or stripe) boundary, so per-packet services and
    per-tile kernels rewrite whole records only.  The inverse transform
    is device-side: ``repro_torch.core.ingest.make_dlrm_tile_decoder``."""
    n, w = recs.shape
    words = mtu // 4
    rpp = words // w                  # records per packet
    n_pkts = -(-n // rpp)
    buf = np.zeros((n_pkts, words), np.int32)
    for p in range(n_pkts):
        chunk = recs[p * rpp:(p + 1) * rpp]
        buf[p, :chunk.size] = chunk.reshape(-1)
    return buf.reshape(-1).view(np.uint8)


def decode_preprocessed_dlrm(raw: np.ndarray, n_dense: int
                             ) -> Dict[str, np.ndarray]:
    """Decode a shard whose record payload already passed the on-path
    preprocessing service (dense words are float32 bit patterns)."""
    d = decode_dlrm_shard(raw)
    recs = d["records"]
    dense = recs[:, :n_dense].view(np.float32)
    sparse = recs[:, n_dense:]
    return {"dense": dense.copy(), "sparse": sparse.copy()}
