"""Deterministic keyed-hash randomness ("chaos mode") shared by the
Python netsim and the fused epoch core.

The per-tick simulators draw loss / ECN-mark / reorder decisions from a
``numpy`` Generator whose consumption order is inherently sequential —
impossible to reproduce inside a jitted, vectorized epoch.  Chaos mode
replaces the stream with a *counter-keyed* hash: every decision is a
pure function of ``(stream seed, purpose tag, tick, event index)``,
where the event index is the decision's rank within its tick (send
order on a wire, pop order at an egress queue).  Ranks are computable
both by the sequential Python fabric (a per-tick counter) and by the
vectorized fused core (a segment rank), so the two produce identical
decision streams — which is what lets the property suite assert
bit-identical epochs under loss/ECN/reorder schedules.

Probabilities are compared in *integers*: a threshold is precomputed
once on the host as ``floor(p * 2**32)`` and the uniform 32-bit hash is
compared with ``h < threshold``.  No float ever enters the decision, so
host-f64 vs device-f32 rounding can never diverge the two sides.

Purpose tags (per stream):
  1 = wire loss        2 = jitter delay      3 = reorder hit
  4 = reorder extra delay                    (fabric RED uses tag 2)
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF

TAG_LOSS = 1
TAG_RED = 2
TAG_JITTER = 2
TAG_REORDER = 3
TAG_RDELAY = 4


def hash32(seed: int, tag: int, tick: int, idx: int) -> int:
    """SplitMix-style 32-bit finalizer over the decision key.  Pure
    integer arithmetic."""
    x = (seed ^ (tag * 0x9E3779B1) ^ (tick * 0x85EBCA77)
         ^ (idx * 0xC2B2AE3D)) & M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    x ^= x >> 16
    return x


def u32_prob(p: float) -> int:
    """Probability -> integer threshold (decision: ``hash < thresh``).
    The one place a float is touched, on the host, once per config."""
    return min(max(int(float(p) * 4294967296.0), 0), M32)


def link_stream(base_seed: int, a: int, b: int) -> int:
    """Per-directed-link stream seed (mirrors the rng seed derivation
    of ``netsim.Network``)."""
    return (base_seed * 1000 + a * 37 + b) & M32


def red_thresholds(kmin: int, kmax: int, pmax: float,
                   max_depth: int) -> np.ndarray:
    """Integer RED ramp: ``thresh[d]`` is the mark threshold for a
    dequeue leaving depth ``d``.  Saturated (>= kmax) depths get the
    always-mark threshold; at/below kmin the never-mark 0."""
    d = np.arange(max_depth + 1, dtype=np.int64)
    ramp = pmax * (d - kmin) / max(kmax - kmin, 1)
    t = np.array([u32_prob(p) for p in ramp], np.int64)
    t = np.where(d >= kmax, M32 + 1, np.where(d <= kmin, 0, t))
    return t.astype(np.int64)


def red_mark(seed: int, tick: int, idx: int, depth: int,
             kmin: int, kmax: int, pmax: float) -> bool:
    """Chaos-mode RED decision (Python fabric side).  ``idx`` is the
    pop's rank within its tick — every pop consumes one rank whether or
    not the depth lands in the ramp, so the vectorized side can rank
    pops without tracking which ones actually drew."""
    if kmax <= 0:
        return False
    if depth >= kmax:
        return True
    if depth <= kmin:
        return False
    thresh = u32_prob(pmax * (depth - kmin) / max(kmax - kmin, 1))
    return hash32(seed, TAG_RED, tick, idx) < thresh
