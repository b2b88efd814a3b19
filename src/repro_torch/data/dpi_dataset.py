"""Synthetic DPI training data (paper §5.1.2 trains on 'common big data
payloads such as CSVs, PNGs, and TXTs versus compiled malware
executables').  We synthesize both classes with the byte-level statistics
that distinguish them: text/CSV (printable ASCII, delimiters), PNG-ish
(magic + filtered-scanline bytes), vs. ELF executables (magic, section
structure, instruction-like byte patterns, high entropy blocks)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

_ELF_MAGIC = np.frombuffer(b"\x7fELF\x02\x01\x01\x00", np.uint8)
_PNG_MAGIC = np.frombuffer(b"\x89PNG\r\n\x1a\n", np.uint8)


def benign_beats(n: int, rng) -> np.ndarray:
    """64-byte beats of text / CSV / PNG-like payloads."""
    kinds = rng.integers(0, 3, n)
    out = np.zeros((n, 64), np.uint8)
    # text: printable ascii, spaces, newlines
    text = rng.choice(np.frombuffer(
        b"etaoinshrdlucmfwypvbgkjqxz ETAOIN,.;:\n 0123456789", np.uint8),
        size=(n, 64))
    # csv: digits + commas
    csv = rng.choice(np.frombuffer(b"0123456789,.-\n", np.uint8),
                     size=(n, 64))
    # png-ish: magic + low-entropy filtered bytes
    png = (rng.integers(0, 64, (n, 64))).astype(np.uint8)
    png[:, :8] = _PNG_MAGIC
    out[kinds == 0] = text[kinds == 0]
    out[kinds == 1] = csv[kinds == 1]
    out[kinds == 2] = png[kinds == 2]
    return out


def malicious_beats(n: int, rng) -> np.ndarray:
    """64-byte beats of executable-like payloads: x86-ish opcode mix,
    high-entropy packed sections, ELF header fragments."""
    out = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    # sprinkle common x86-64 opcodes / prologue patterns
    ops = np.frombuffer(b"\x55\x48\x89\xe5\x48\x83\xec\x00\xc3\x90\xe8\x0f"
                        b"\x44\x24\x8b\x45", np.uint8)
    idx = rng.integers(0, 64, (n, 24))
    out[np.arange(n)[:, None], idx] = rng.choice(ops, (n, 24))
    hdr = rng.random(n) < 0.2
    out[hdr, :8] = _ELF_MAGIC
    return out


def make_dataset(n_per_class: int = 4096, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    x = np.concatenate([benign_beats(n_per_class, rng),
                        malicious_beats(n_per_class, rng)])
    y = np.concatenate([np.zeros(n_per_class), np.ones(n_per_class)])
    perm = rng.permutation(len(x))
    return x[perm], y[perm].astype(np.float32)


def payload_with_embedded_malware(mtu: int, frac: float, rng) -> np.ndarray:
    """One packet payload, ``frac`` of its beats malicious (for the
    partial-embedding detection-rate experiment, paper: 89.35%)."""
    beats = mtu // 64
    n_mal = int(round(frac * beats))
    b = benign_beats(beats, rng)
    if n_mal:
        m = malicious_beats(n_mal, rng)
        pos = rng.choice(beats, n_mal, replace=False)
        b[pos] = m
    return b.reshape(mtu)
