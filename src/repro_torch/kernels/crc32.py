"""ICRC / CRC32 on the card (paper §4.5).

``crc32_int32_cuda`` launches the hand-written Hopper kernel in
``csrc/crc32.cu``: a team of lanes a packet, each folding a contiguous
chunk slice-by-4 through tables copied across the banks of shared
memory, the chunks' CRCs combined in GF(2) (see the source note).  It
returns the CRCs' 32 bits as int32, which is what the ICRC tap reports;
``crc32_cuda`` widens them to int64 in ``[0, 2**32)``, the contract of
``ops.crc32``: torch's uint32 support is thin, so the port never does
arithmetic on uint32 tensors.  ``crc32_ref`` is the plain PyTorch
version from ``ref.py``.

``team``, ``powers`` and ``table_image`` are the host's half of the
kernel's scheme: its lane mapping, the powers of x its lanes multiply
by, and the tables it copies; ``warp_lookups`` counts the table lookups
its warps issue, for the design's bound.

``crc32_int32_cuda.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

SEG = 128            # bytes of a lane's piece of its chunk (kSeg)
WARP = 32


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("crc32")
    lib.crc32_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.crc32_launch.restype = ctypes.c_int
    return lib


def team(mtu: int, vec: int) -> Tuple[int, int]:
    """(T, C): the kernel's lanes a packet and bytes a lane for rows of
    ``mtu`` bytes read ``vec`` (16 or 8) bytes a load.  T is the fewest
    lanes, a power of two up to a warp, that hold a row at ``SEG`` bytes
    a lane; C is the row's share of a lane rounded up to whole loads."""
    t = 1
    while t < WARP and t * SEG < mtu:
        t *= 2
    c = -(-mtu // t)
    return t, max(-(-c // vec) * vec, vec)


def powers(mtu: int, vec: int) -> np.ndarray:
    """The (C, T) uint32 table the kernel's lanes multiply by, flattened:
    word ``s * T + k`` is ``x^(8 (k C + s)) mod P`` as a reflected CRC
    register (x^0 is bit 31), i.e. the zero-byte advance ``Z^(k C + s)``
    of that register."""
    t, c = team(mtu, vec)
    z = np.empty(t * c, np.uint32)
    v = 0x80000000
    for i in range(t * c):
        z[i] = v
        v = (v >> 8) ^ int(R.CRC_TABLE[v & 0xFF])
    return np.ascontiguousarray(z.reshape(t, c).T).reshape(-1)


def warp_lookups(plen: np.ndarray, mtu: int, vec: int) -> int:
    """The shared-memory table lookups the kernel's warps issue for rows
    of ``mtu`` bytes at lengths ``plen``, each a warp-wide instruction (one
    wavefront): per segment of a warp's chunks, 4 a word step, 32 steps
    when every lane's segment is full, else up to the lanes' most words
    and 3 byte steps; and 4 a multiply, where a lane of the warp
    multiplies."""
    t, c = team(mtu, vec)
    plen = np.asarray(plen)
    n = len(plen)
    if n == 0:
        return 0
    p = np.arange(-(-n // (WARP // t)))[:, None] * (WARP // t) \
        + np.arange(WARP) // t
    length = np.where(p < n, np.clip(plen[np.minimum(p, n - 1)], 0, mtu), 0)
    l = np.arange(WARP) & (t - 1)
    mine = np.clip(length - l * c, 0, c)
    total = 0
    for s0 in range(0, c, SEG):
        m = np.clip(mine - s0, 0, SEG)
        steps = ((m + 3) >> 2).max(1)
        total += int(np.where((m == SEG).all(1), 4 * (SEG // 4),
                              4 * steps + 3).sum())
    return total + 4 * int((l < length // c).any(1).sum())


def table_image() -> np.ndarray:
    """The slice-by-4 tables in the order the kernel stages them: T3, T2,
    T1, T0 (T_k[b] is byte b advanced by k + 1 zero bytes), 1024 words."""
    return np.ascontiguousarray(R.CRC_TABLES8[3::-1])


@functools.lru_cache(maxsize=None)
def _image_on(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(table_image().view(np.int32).reshape(-1)).to(device)


@functools.lru_cache(maxsize=None)
def _powers_on(device: torch.device, mtu: int, vec: int) -> torch.Tensor:
    return torch.as_tensor(powers(mtu, vec).view(np.int32)).to(device)


def crc32_int32_cuda(payload: torch.Tensor, plen: torch.Tensor
                     ) -> torch.Tensor:
    """payload (N, MTU) uint8, plen (N,) on the card -> (N,) int32: the
    bits of each CRC32 over ``payload[:plen]`` (plen clamped to [0, MTU])."""
    if not payload.is_cuda:
        raise ValueError("crc32_int32_cuda needs a CUDA tensor")
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
        vec = 16 if payload.data_ptr() % 16 == 0 and mtu % 16 == 0 else 8
        t, c = team(mtu, vec)
        lib = _lib()
        with torch.cuda.device(payload.device):
            stream = torch.cuda.current_stream(payload.device).cuda_stream
            err = lib.crc32_launch(
                payload.data_ptr(), plen.data_ptr(),
                _image_on(payload.device).data_ptr(),
                _powers_on(payload.device, mtu, vec).data_ptr(),
                out.data_ptr(), n, mtu, t, c, vec, stream)
            crc32_int32_cuda.launches += 1
        _build.check(lib, err, "crc32")
    return out


crc32_int32_cuda.launches = 0


def crc32_cuda(payload: torch.Tensor, plen: torch.Tensor) -> torch.Tensor:
    """payload (N, MTU) uint8, plen (N,) on the card -> (N,) int64 in
    ``[0, 2**32)``."""
    return crc32_int32_cuda(payload, plen).to(torch.int64) & 0xFFFFFFFF


crc32_ref = R.crc32_ref


def crc32_int32_ref(payload: torch.Tensor, plen: torch.Tensor
                    ) -> torch.Tensor:
    """The plain version of ``crc32_int32_cuda``."""
    return R.as_int32(crc32_ref(payload, plen))
