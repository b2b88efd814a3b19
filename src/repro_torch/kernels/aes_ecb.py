"""AES-128-ECB on the card (paper §5.1.1 on-datapath crypto service).

``aes_ecb_cuda`` launches the hand-written Hopper kernel in
``csrc/aes_ecb.cu`` (one thread per 16-byte block, the rounds of
``csrc/aes_round.cuh``: one T-table a direction, copied across the banks
of shared memory; see the source notes for the bound and design).
``table_image`` builds what the kernels copy those tables from.
``aes_ecb_ref`` is the plain PyTorch version from ``ref.py``.

``aes_ecb_cuda.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R
from repro_torch.kernels.ref import expand_key  # noqa: F401  (re-export)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("aes_ecb")
    lib.aes_ecb_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.aes_ecb_launch.restype = ctypes.c_int
    return lib


def _gf_mul(x: np.ndarray, c: int) -> np.ndarray:
    """c * x in GF(2^8) (the AES polynomial), bytewise."""
    out = np.zeros_like(x)
    while c:
        if c & 1:
            out ^= x
        x = ((x << 1) ^ ((x >> 7) & 1) * 0x1B) & 0xFF
        c >>= 1
    return out


def table_image(decrypt: bool) -> np.ndarray:
    """The tables of one direction as ``csrc/aes_round.cuh`` reads them:
    512 uint32 words, the T-table (256 words: byte r of word x is
    ``m_r * S[x]`` with (m_0..m_3) = (2, 1, 1, 3), or ``InvS[x]`` times
    (14, 9, 13, 11) when decrypting), then the S-box (InvS-box), one entry
    a word in its low byte."""
    box = (R.INV_SBOX if decrypt else R.SBOX).astype(np.uint32)
    coef = (14, 9, 13, 11) if decrypt else (2, 1, 1, 3)
    t = np.zeros(256, np.uint32)
    for r, m in enumerate(coef):
        t |= _gf_mul(box, m) << np.uint32(8 * r)
    return np.concatenate([t, box])


@functools.lru_cache(maxsize=None)
def _table_image_on(device: torch.device, decrypt: bool) -> torch.Tensor:
    """``table_image`` as int32 words on ``device`` (made once)."""
    return torch.as_tensor(table_image(decrypt).view(np.int32)).to(device)


def _round_keys_on(round_keys, device: torch.device) -> torch.Tensor:
    """(11, 16) uint8 round keys as a contiguous, 16-byte aligned tensor on
    ``device`` (the kernels read them as words)."""
    rk = torch.as_tensor(np.asarray(round_keys, np.uint8)) \
        if not isinstance(round_keys, torch.Tensor) else round_keys
    rk = rk.to(device=device, dtype=torch.uint8).contiguous()
    if rk.shape != (11, 16):
        raise ValueError(f"round keys must be (11, 16), got {tuple(rk.shape)}")
    return rk.clone() if rk.data_ptr() % 16 else rk


def aes_ecb_cuda(blocks: torch.Tensor, round_keys: torch.Tensor, *,
                 decrypt: bool = False) -> torch.Tensor:
    """blocks (N, 16) uint8 on the card -> (N, 16) uint8."""
    if not blocks.is_cuda:
        raise ValueError("aes_ecb_cuda needs a CUDA tensor")
    if blocks.dtype != torch.uint8 or blocks.dim() != 2 \
            or blocks.shape[1] != 16:
        raise ValueError(f"blocks must be (N, 16) uint8, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    if not blocks.is_contiguous() or blocks.data_ptr() % 16:
        raise ValueError("blocks must be contiguous and 16-byte aligned")
    rk = _round_keys_on(round_keys, blocks.device)
    out = torch.empty_like(blocks)
    n = blocks.shape[0]
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        err = lib.aes_ecb_launch(
            blocks.data_ptr(), out.data_ptr(), rk.data_ptr(),
            _table_image_on(blocks.device, decrypt).data_ptr(), n,
            int(decrypt), stream)
        aes_ecb_cuda.launches += 1
    _build.check(lib, err, "aes_ecb")
    return out


aes_ecb_cuda.launches = 0


def aes_ecb_ref(blocks: torch.Tensor, round_keys, *,
                decrypt: bool = False) -> torch.Tensor:
    if decrypt:
        return R.aes_decrypt_ref(blocks, round_keys)
    return R.aes_encrypt_ref(blocks, round_keys)
