"""The receive chain fused: AES-128-ECB decrypt, then ML-DPI scoring of
the plaintext, in one pass over the payload.

``fused_decrypt_dpi_cuda`` launches the hand-written Hopper kernel in
``csrc/fused_chain.cu`` (the plaintext stays in shared memory between
the two services, so the payload is read from device memory once and
written once; the AES rounds are ``csrc/aes_round.cuh``'s and the MLP
``csrc/dpi_mma.cuh``'s, the same device code as ``aes_ecb`` and
``dpi_mlp``, so each block decrypts and each beat scores to the same bits
as there; a packet's beats are spread over blocks in 16-beat tiles).
``fused_decrypt_dpi_ref`` is the plain PyTorch version from ``ref.py``:
decrypt, then score.  ``fused_decrypt_dpi`` dispatches
between them as ``ops.py`` does.

The score is the reference's: the max over EVERY 64-byte beat of the
MTU, not masked by a packet length as ``DpiService`` masks it, so this
chain is not a drop-in ``ServiceChain`` member.

``fused_decrypt_dpi_cuda.launches`` counts the kernel launches of this
process.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R
from repro_torch.kernels.aes_ecb import _round_keys_on, _table_image_on
from repro_torch.kernels.dpi_mlp import _checked, _image_of

BLOCK_N = 16              # packets per tile, as the reference's grid step

fused_decrypt_dpi_ref = R.fused_decrypt_dpi_ref


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_chain")
    lib.fused_chain_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.fused_chain_launch.restype = ctypes.c_int
    return lib


def fused_decrypt_dpi_cuda(payload: torch.Tensor, round_keys,
                           params: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """payload (N, MTU) uint8 ciphertext on the card -> (plaintext (N,
    MTU) uint8, (N,) float32 max beat score).  Pass the round keys as a
    tensor on the card to keep them there between calls."""
    if not payload.is_cuda:
        raise ValueError("fused_decrypt_dpi_cuda needs a CUDA tensor")
    if payload.dtype != torch.uint8 or payload.dim() != 2 \
            or payload.shape[1] % 64 or payload.shape[1] == 0:
        raise ValueError(f"payload must be (N, MTU) uint8 with MTU a positive"
                         f" multiple of 64, got {tuple(payload.shape)} "
                         f"{payload.dtype}")
    if not payload.is_contiguous() or payload.data_ptr() % 16:
        raise ValueError("payload must be contiguous and 16-byte aligned")
    dev = payload.device
    rk = _round_keys_on(round_keys, dev)
    p = _checked(params, dev)
    n, mtu = payload.shape
    plain = torch.empty_like(payload)
    scores = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return plain, scores
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_chain_launch(
            payload.data_ptr(), plain.data_ptr(), scores.data_ptr(),
            rk.data_ptr(), _table_image_on(dev, True).data_ptr(),
            _image_of(p).data_ptr(), n, mtu, stream)
        fused_decrypt_dpi_cuda.launches += 1
    _build.check(lib, err, "fused_chain")
    return plain, scores


fused_decrypt_dpi_cuda.launches = 0


def fused_decrypt_dpi(payload: torch.Tensor, round_keys, params: Dict, *,
                      impl: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, MTU) uint8 ciphertext -> (plaintext (N, MTU) uint8, (N,)
    float32 max DPI score over every beat).  A CUDA tensor launches the
    kernel, a CPU tensor takes the plain version, ``impl="ref"`` asks for
    the plain version on any device."""
    from repro_torch.kernels.ops import _use_kernel   # ops imports this
    if _use_kernel(payload, impl):
        return fused_decrypt_dpi_cuda(payload, round_keys, params)
    return fused_decrypt_dpi_ref(payload, round_keys, params)


def fused_decrypt_dpi_tile(payload: torch.Tensor, round_keys, params: Dict,
                           *, tile_pkts: int = BLOCK_N,
                           impl: Optional[str] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming entry: the fused pass over one fragment tile of at most
    ``tile_pkts`` packets, the moment its bytes are acknowledged.  Pads
    to the fixed ``(tile_pkts, MTU)`` shape, as the reference does, and
    returns the first ``n`` rows: row for row the one-shot result, since
    AES and the DPI MLP are row-independent."""
    n = payload.shape[0]
    if n > tile_pkts:
        raise ValueError(f"tile carries {n} packets > tile_pkts={tile_pkts}")
    if n < tile_pkts:
        pad = payload.new_zeros((tile_pkts - n, payload.shape[1]))
        payload = torch.cat([payload, pad])
    plain, scores = fused_decrypt_dpi(payload, round_keys, params, impl=impl)
    return plain[:n], scores[:n]
