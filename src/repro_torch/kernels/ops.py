"""Public wrappers for every kernel of the port — the ``ops.py`` layer.

Each op takes ``impl``:
  * ``None`` (the default) dispatches by the tensor's device: a CUDA
    tensor goes to the hand-written kernel, a CPU tensor to the plain
    PyTorch version;
  * ``"ref"`` asks for the plain version on any device (``chip_smoke.py``
    uses it to hold the kernels against it on the card).

A kernel that fails to build or launch raises; nothing falls back.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import aes_ecb as _aes
from repro_torch.kernels import crc32 as _crc
from repro_torch.kernels import dpi_mlp as _dpi
from repro_torch.kernels.ref import expand_key  # noqa: F401  (re-export)

IMPLS = (None, "ref")

# the kernel wrappers whose ``launches`` counters a run reads
KERNELS = {"aes_ecb": _aes.aes_ecb_cuda, "crc32": _crc.crc32_cuda,
           "dpi_mlp": _dpi.dpi_scores_cuda}


def _use_kernel(x: torch.Tensor, impl: Optional[str]) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    return impl != "ref" and x.is_cuda


def aes_ecb(blocks: torch.Tensor, round_keys, *, decrypt: bool = False,
            impl: Optional[str] = None) -> torch.Tensor:
    """(N, 16) uint8 blocks -> (N, 16) uint8, AES-128-ECB."""
    if _use_kernel(blocks, impl):
        return _aes.aes_ecb_cuda(blocks, round_keys, decrypt=decrypt)
    return _aes.aes_ecb_ref(blocks, round_keys, decrypt=decrypt)


def crc32(payload: torch.Tensor, plen: torch.Tensor, *,
          impl: Optional[str] = None) -> torch.Tensor:
    """(N, MTU) uint8, (N,) lengths -> (N,) int64 CRC32 in [0, 2**32)."""
    if _use_kernel(payload, impl):
        return _crc.crc32_cuda(payload, plen)
    return _crc.crc32_ref(payload, plen)


def dpi_scores(payload: torch.Tensor, params: Dict, *,
               impl: Optional[str] = None) -> torch.Tensor:
    """(N, MTU) uint8 -> (N, MTU//64) float32 per-beat DPI scores."""
    if _use_kernel(payload, impl):
        return _dpi.dpi_scores_cuda(payload, params)
    return _dpi.dpi_scores_ref(payload, params)


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
