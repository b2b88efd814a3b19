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
from repro_torch.kernels import fused_chain as _fused
from repro_torch.kernels import fused_epoch as _epoch
from repro_torch.kernels import preproc as _pre
from repro_torch.kernels import reduce as _red
from repro_torch.kernels.ref import expand_key  # noqa: F401  (re-export)

IMPLS = (None, "ref")

# the kernel wrappers whose ``launches`` counters a run reads
KERNELS = {"aes_ecb": _aes.aes_ecb_cuda, "crc32": _crc.crc32_int32_cuda,
           "dpi_mlp": _dpi.dpi_scores_cuda, "preproc": _pre.preproc_cuda,
           "reduce_fold": _red.reduce_fold_cuda,
           "fused_decrypt_dpi": _fused.fused_decrypt_dpi_cuda,
           "fused_epoch": _epoch.fused_epoch_cuda}


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


def crc32_int32(payload: torch.Tensor, plen: torch.Tensor, *,
                impl: Optional[str] = None) -> torch.Tensor:
    """(N, MTU) uint8, (N,) lengths -> (N,) int32: the CRC32's bits
    wrapped to int32, as the ICRC tap reports them (the kernel's own
    output, with no widening on the card)."""
    if _use_kernel(payload, impl):
        return _crc.crc32_int32_cuda(payload, plen)
    return _crc.crc32_int32_ref(payload, plen)


def dpi_scores(payload: torch.Tensor, params: Dict, *,
               impl: Optional[str] = None) -> torch.Tensor:
    """(N, MTU) uint8 -> (N, MTU//64) float32 per-beat DPI scores."""
    if _use_kernel(payload, impl):
        return _dpi.dpi_scores_cuda(payload, params)
    return _dpi.dpi_scores_ref(payload, params)


def preproc(recs: torch.Tensor, n_dense: int, modulus: int, *,
            rec_w: Optional[int] = None,
            impl: Optional[str] = None) -> torch.Tensor:
    """(M, rec_w) int32 records (or rows of whole records, see
    ``kernels.preproc``) -> (records, rec_w) int32, dense words as
    float32 bits."""
    if _use_kernel(recs, impl):
        return _pre.preproc_cuda(recs, n_dense, modulus, rec_w=rec_w)
    return _pre.preproc_ref(recs, n_dense, modulus, rec_w=rec_w)


def preproc_tile(recs: torch.Tensor, n_dense: int, modulus: int, *,
                 tile_recs: int = _pre.BLOCK_M,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Streaming entry: preprocess one fragment tile of at most
    ``tile_recs`` records the moment its bytes are acknowledged.  The
    reference pads the tile to a fixed shape so its jitted kernel never
    recompiles; an eager launch needs no padding, so this is ``preproc``
    over the tile's own rows, element for element the one-shot result."""
    if recs.shape[0] > tile_recs:
        raise ValueError(f"tile carries {recs.shape[0]} records > "
                         f"tile_recs={tile_recs}")
    return preproc(recs, n_dense, modulus, impl=impl)


def reduce_fold(x: torch.Tensor, *, impl: Optional[str] = None
                ) -> torch.Tensor:
    """(K, L) float32 / int32 -> (L,): strict left fold over rows."""
    if _use_kernel(x, impl):
        return _red.reduce_fold_cuda(x)
    return _red.reduce_fold_ref(x)


def chunk_reduce(payload: torch.Tensor, *, dtype: str = "float32",
                 impl: Optional[str] = None) -> torch.Tensor:
    """Left-fold K collective payloads into one: (K, nbytes) uint8 ->
    (nbytes,) uint8, the bytes read in place as ``dtype`` elements."""
    words = _red.payload_words(payload, dtype)
    return reduce_fold(words, impl=impl).view(torch.uint8)


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
