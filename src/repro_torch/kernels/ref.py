"""Plain PyTorch versions of the port's kernels (the ``ref.py`` layer).

Each CUDA kernel under ``repro_torch/csrc`` has its plain version here.
The CPU tests hold these against ``repro.kernels.ref`` and the Pallas
wrappers; ``chip_smoke.py`` holds every kernel against them on the card.
The wrappers in ``ops.py`` take them only for a tensor on the CPU (or
when ``impl="ref"`` is asked for by name).

The tables (S-boxes, ShiftRows permutations, CRC tables) and the key
schedule are numpy, as in the reference, so the two packages share no
code but must agree bit for bit (pinned by tests/test_torch_kernels.py).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# ===========================================================================
# AES-128 (FIPS-197)
# ===========================================================================

SBOX = np.array([
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16], np.int32)

INV_SBOX = np.zeros(256, np.int32)
INV_SBOX[SBOX] = np.arange(256)

# flat index i = r + 4c (column-major state); ShiftRows: row r rotates
# left by r columns.
_SHIFT_IDX = np.array([(i % 4) + 4 * (((i // 4) + (i % 4)) % 4)
                       for i in range(16)], np.int32)
_INV_SHIFT_IDX = np.array([(i % 4) + 4 * (((i // 4) - (i % 4)) % 4)
                           for i in range(16)], np.int32)

_RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10,
                  0x20, 0x40, 0x80, 0x1B, 0x36], np.int32)


def expand_key(key: np.ndarray) -> np.ndarray:
    """FIPS-197 key schedule: (16,) uint8 -> (11, 16) uint8 round keys."""
    key = np.asarray(key, np.uint8)
    if key.shape != (16,):
        raise ValueError(f"AES-128 key must have shape (16,), got {key.shape}")
    w = [key[4 * i:4 * i + 4].astype(np.int32) for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1].copy()
        if i % 4 == 0:
            t = np.roll(t, -1)
            t = SBOX[t]
            t[0] ^= _RCON[i // 4 - 1]
        w.append(w[i - 4] ^ t)
    rk = np.stack([np.concatenate(w[4 * r:4 * r + 4]) for r in range(11)])
    return rk.astype(np.uint8)


def _xt(x: torch.Tensor) -> torch.Tensor:
    """GF(2^8) xtime on integer lanes holding one byte each."""
    return ((x << 1) ^ ((x >> 7) & 1) * 0x1B) & 0xFF


def _mix_columns(s: torch.Tensor) -> torch.Tensor:
    """s: (..., 16) column-major; per column [a0..a3]:
    b0 = 2a0^3a1^a2^a3 etc."""
    a = s.reshape(s.shape[:-1] + (4, 4))      # (..., c, r)
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    b0 = _xt(a0) ^ (_xt(a1) ^ a1) ^ a2 ^ a3
    b1 = a0 ^ _xt(a1) ^ (_xt(a2) ^ a2) ^ a3
    b2 = a0 ^ a1 ^ _xt(a2) ^ (_xt(a3) ^ a3)
    b3 = (_xt(a0) ^ a0) ^ a1 ^ a2 ^ _xt(a3)
    return torch.stack([b0, b1, b2, b3], dim=-1).reshape(s.shape)


def _inv_mix_columns(s: torch.Tensor) -> torch.Tensor:
    a = s.reshape(s.shape[:-1] + (4, 4))
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]

    def m(x, c):
        x2 = _xt(x)
        x4 = _xt(x2)
        x8 = _xt(x4)
        out = torch.zeros_like(x)
        if c & 8:
            out = out ^ x8
        if c & 4:
            out = out ^ x4
        if c & 2:
            out = out ^ x2
        if c & 1:
            out = out ^ x
        return out

    b0 = m(a0, 14) ^ m(a1, 11) ^ m(a2, 13) ^ m(a3, 9)
    b1 = m(a0, 9) ^ m(a1, 14) ^ m(a2, 11) ^ m(a3, 13)
    b2 = m(a0, 13) ^ m(a1, 9) ^ m(a2, 14) ^ m(a3, 11)
    b3 = m(a0, 11) ^ m(a1, 13) ^ m(a2, 9) ^ m(a3, 14)
    return torch.stack([b0, b1, b2, b3], dim=-1).reshape(s.shape)


def _table(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64)).to(device)


def aes_encrypt_ref(blocks: torch.Tensor, round_keys) -> torch.Tensor:
    """blocks: (N, 16) uint8; round_keys (11, 16) uint8 -> (N, 16) uint8.
    Bytes ride in int64 lanes so the S-box lookup is a plain gather."""
    dev = blocks.device
    sbox = _table(SBOX, dev)
    sidx = _table(_SHIFT_IDX, dev)
    rk = torch.as_tensor(round_keys).to(dev, torch.int64)
    st = blocks.to(torch.int64)
    st = st ^ rk[0]
    for r in range(1, 10):
        st = sbox[st]
        st = st[:, sidx]
        st = _mix_columns(st)
        st = st ^ rk[r]
    st = sbox[st]
    st = st[:, sidx]
    st = st ^ rk[10]
    return st.to(torch.uint8)


def aes_decrypt_ref(blocks: torch.Tensor, round_keys) -> torch.Tensor:
    dev = blocks.device
    inv_sbox = _table(INV_SBOX, dev)
    iidx = _table(_INV_SHIFT_IDX, dev)
    rk = torch.as_tensor(round_keys).to(dev, torch.int64)
    st = blocks.to(torch.int64)
    st = st ^ rk[10]
    for r in range(9, 0, -1):
        st = st[:, iidx]
        st = inv_sbox[st]
        st = st ^ rk[r]
        st = _inv_mix_columns(st)
    st = st[:, iidx]
    st = inv_sbox[st]
    st = st ^ rk[0]
    return st.to(torch.uint8)


# ===========================================================================
# CRC32 (reflected 0xEDB88320 — Ethernet/RoCE ICRC polynomial)
# ===========================================================================

def as_int32(v: torch.Tensor) -> torch.Tensor:
    """Wrap integer lanes to int32 two's complement, as ``jnp``'s
    uint32 -> int32 conversion and int32 shifts do (torch's narrowing
    conversions and shifts past the sign bit are not relied on)."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    return (v - ((v >> 31) << 32)).to(torch.int32)


def _crc_table() -> np.ndarray:
    t = np.zeros(256, np.uint32)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = np.uint32((c >> 1) ^ (0xEDB88320 if (c & 1) else 0))
        t[i] = c
    return t


CRC_TABLE = _crc_table()


# slice-by-8 tables: T[k][b] = crc of byte b advanced by k+1 zero bytes
def _crc_tables8() -> np.ndarray:
    t = np.zeros((8, 256), np.uint32)
    t[0] = CRC_TABLE
    for k in range(1, 8):
        t[k] = (t[k - 1] >> np.uint32(8)) ^ CRC_TABLE[t[k - 1] & 0xFF]
    return t


CRC_TABLES8 = _crc_tables8()


def crc32_ref(payload: torch.Tensor, plen: torch.Tensor) -> torch.Tensor:
    """Per-packet CRC32 over payload[:plen].  payload (N, MTU) uint8,
    plen (N,) int -> (N,) int64 holding the unsigned CRC in [0, 2**32).
    torch has no full uint32 arithmetic, so the register rides in int64
    masked to 32 bits (``>>`` on a non-negative int64 is logical)."""
    dev = payload.device
    table = _table(CRC_TABLE, dev)
    data = payload.to(torch.int64)
    plen = plen.to(torch.int64)
    n, mtu = payload.shape
    crc = torch.full((n,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    for i in range(mtu):
        new = (crc >> 8) ^ table[(crc ^ data[:, i]) & 0xFF]
        crc = torch.where(i < plen, new, crc)
    return crc ^ 0xFFFFFFFF


# ===========================================================================
# DPI ternary MLP (paper §5.1.2): 64-byte beat -> score
# ===========================================================================

DPI_DIMS = (64, 128, 64)      # input, hidden1, hidden2 (output dim 1)


def dpi_scores_ref(payload: torch.Tensor, params: Dict) -> torch.Tensor:
    """payload (N, MTU) uint8 -> per-beat scores (N, MTU//64) float32.

    params: w1 (64,128) int8 ternary, s1 (); w2 (128,64) int8, s2 ();
            w3 (64,1) int8, s3 (); biases b1,b2 float32."""
    n, mtu = payload.shape
    beats = mtu // 64
    x = payload.reshape(n * beats, 64).to(torch.float32) / 128.0 - 1.0
    h = torch.relu(x @ (params["w1"].to(torch.float32) * params["s1"])
                   + params["b1"])
    h = torch.relu(h @ (params["w2"].to(torch.float32) * params["s2"])
                   + params["b2"])
    y = h @ (params["w3"].to(torch.float32) * params["s3"])
    return y[:, 0].reshape(n, beats)


# ===========================================================================
# Fused receive chain: AES-128-ECB decrypt, then DPI on the plaintext
# ===========================================================================

def fused_decrypt_dpi_ref(payload: torch.Tensor, round_keys, params: Dict
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """payload (N, MTU) uint8 ciphertext -> (plaintext (N, MTU) uint8,
    (N,) float32 max DPI score over EVERY beat of the MTU).  The score is
    not masked by a packet length, unlike ``DpiService``."""
    n, mtu = payload.shape
    plain = aes_decrypt_ref(payload.reshape(n * (mtu // 16), 16),
                            round_keys).reshape(n, mtu)
    return plain, dpi_scores_ref(plain, params).amax(dim=1)


# ===========================================================================
# DLRM preprocessing (paper §8.1): Neg2Zero -> Log (dense), Modulus (sparse)
# ===========================================================================

def preproc_ref(recs: torch.Tensor, n_dense: int, modulus: int
                ) -> torch.Tensor:
    """recs (M, n_dense+n_sparse) int32.  Dense part: clip negatives to
    zero then log1p, stored as the float32 bit pattern; sparse part:
    value mod ``modulus``, floor-mod (the sign follows the divisor, as
    ``jnp.remainder``)."""
    if modulus == 0:
        raise ValueError("preproc: modulus must be non-zero")
    dense = recs[:, :n_dense]
    sparse = recs[:, n_dense:]
    d = torch.log1p(torch.clamp_min(dense.to(torch.float32), 0.0))
    s = torch.remainder(sparse, modulus)
    return torch.cat([d.view(torch.int32), s.to(torch.int32)], dim=1)


# ===========================================================================
# Segmented payload reduction (the collectives' fold)
# ===========================================================================

def reduce_fold_ref(x: torch.Tensor) -> torch.Tensor:
    """(K, L) -> (L,): strict left fold over rows, ``((x0 + x1) + x2) +
    ...`` per lane.  The order is the contract (float32 addition does
    not associate); int32 wraps on overflow."""
    acc = x[0].clone()
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc
