"""AES-128-ECB on the card (paper §5.1.1 on-datapath crypto service).

``aes_ecb_cuda`` launches the hand-written Hopper kernel in
``csrc/aes_ecb.cu`` (one thread per 16-byte block, S-box and round keys
in shared memory; see the source note for its bound and design).
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


@functools.lru_cache(maxsize=None)
def _sbox(device: torch.device, decrypt: bool) -> torch.Tensor:
    table = R.INV_SBOX if decrypt else R.SBOX
    return torch.as_tensor(table.astype(np.uint8)).to(device)


def _round_keys_on(round_keys, device: torch.device) -> torch.Tensor:
    """(11, 16) uint8 round keys as a contiguous tensor on ``device``."""
    rk = torch.as_tensor(np.asarray(round_keys, np.uint8)) \
        if not isinstance(round_keys, torch.Tensor) else round_keys
    rk = rk.to(device=device, dtype=torch.uint8).contiguous()
    if rk.shape != (11, 16):
        raise ValueError(f"round keys must be (11, 16), got {tuple(rk.shape)}")
    return rk


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
        err = lib.aes_ecb_launch(blocks.data_ptr(), out.data_ptr(),
                                 rk.data_ptr(),
                                 _sbox(blocks.device, decrypt).data_ptr(),
                                 n, int(decrypt), stream)
        aes_ecb_cuda.launches += 1
    _build.check(lib, err, "aes_ecb")
    return out


aes_ecb_cuda.launches = 0


def aes_ecb_ref(blocks: torch.Tensor, round_keys, *,
                decrypt: bool = False) -> torch.Tensor:
    if decrypt:
        return R.aes_decrypt_ref(blocks, round_keys)
    return R.aes_encrypt_ref(blocks, round_keys)
