"""ICRC / CRC32 on the card (paper §4.5).

``crc32_cuda`` launches the hand-written Hopper kernel in
``csrc/crc32.cu`` (one thread per packet, slice-by-8 tables in shared
memory, stops at ``plen``).  ``crc32_ref`` is the plain PyTorch version
from ``ref.py``.  Both return int64 tensors holding the unsigned CRC in
``[0, 2**32)``: torch's uint32 support is thin, so the port never does
arithmetic on uint32 tensors.

``crc32_cuda.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("crc32")
    lib.crc32_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.crc32_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    # the uint32 tables' bits in an int32 tensor (the kernel reads uint32)
    return torch.as_tensor(R.CRC_TABLES8.view("int32")).to(device)


def crc32_cuda(payload: torch.Tensor, plen: torch.Tensor) -> torch.Tensor:
    """payload (N, MTU) uint8, plen (N,) int32 on the card -> (N,) int64."""
    if not payload.is_cuda:
        raise ValueError("crc32_cuda needs a CUDA tensor")
    if payload.dtype != torch.uint8 or payload.dim() != 2:
        raise ValueError(f"payload must be (N, MTU) uint8, got "
                         f"{tuple(payload.shape)} {payload.dtype}")
    n, mtu = payload.shape
    if mtu % 8:
        raise ValueError(f"MTU must be a multiple of 8, got {mtu}")
    if not payload.is_contiguous() or payload.data_ptr() % 8:
        raise ValueError("payload must be contiguous and 8-byte aligned")
    if plen.shape != (n,) or plen.device != payload.device:
        raise ValueError("plen must be (N,) on the payload's device")
    plen = plen.to(torch.int32).contiguous()
    out = torch.empty(n, dtype=torch.int32, device=payload.device)
    if n:
        lib = _lib()
        with torch.cuda.device(payload.device):
            stream = torch.cuda.current_stream(payload.device).cuda_stream
            err = lib.crc32_launch(payload.data_ptr(), plen.data_ptr(),
                                   _tables(payload.device).data_ptr(),
                                   out.data_ptr(), n, mtu, stream)
            crc32_cuda.launches += 1
        _build.check(lib, err, "crc32")
    return out.to(torch.int64) & 0xFFFFFFFF


crc32_cuda.launches = 0

crc32_ref = R.crc32_ref
