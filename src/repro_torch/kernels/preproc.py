"""DLRM preprocessing on the card (paper §8.1).

Fuses the paper's three stateless operators into one pass over the
record words:
  Neg2Zero  — clip negative dense features to zero
  Logarithm — log1p on dense features (large-value compression)
  Modulus   — restrict sparse feature range for the embedding tables

``preproc_cuda`` launches the hand-written Hopper kernel in
``csrc/preproc.cu`` (16-, 8- or 4-byte accesses as the rows allow, one
word a thread in a small launch; a thread's columns fixed by its place
in a block of whole records; the floor-mod by a multiply-high with
``floor_mod_magic``'s numbers; no padding).  ``preproc_ref``
is the plain PyTorch version from ``ref.py``.  Both take the record
matrix ``(M, rec_w)`` or, with ``rec_w`` given, a matrix whose rows each
hold a whole number of records (a fragment tile's packets, read in
place through their row stride), and return the ``(records, rec_w)``
int32 matrix whose dense words are float32 bit patterns.

``preproc_cuda.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

BLOCK_M = 512       # the reference's tile rows: preproc_tile's default cap


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("preproc")
    lib.preproc_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.preproc_launch.restype = ctypes.c_int
    return lib


def floor_mod_magic(modulus: int) -> Tuple[int, int, int]:
    """Granlund and Montgomery's divisor by the invariant ``a = |modulus|``
    (their Figure 4.1): ``(magic, sh1, sh2)`` with, for every 32-bit
    unsigned n, ``n // a == (t + ((n - t) >> sh1)) >> sh2`` where ``t =
    (magic * n) >> 32``.  The kernel takes |x| mod a from it and puts the
    floor-mod's sign back itself."""
    a = abs(modulus)
    if not 1 <= a <= 2**31:
        raise ValueError(f"modulus {modulus} is not a non-zero int32")
    shift = (a - 1).bit_length()                    # ceil(log2(a))
    magic = ((1 << 32) * ((1 << shift) - a)) // a + 1
    return magic, min(shift, 1), max(shift - 1, 0)


def _check(recs: torch.Tensor, n_dense: int, modulus: int,
           rec_w: Optional[int]) -> int:
    if recs.dtype != torch.int32 or recs.dim() != 2:
        raise ValueError(f"records must be a 2-D int32 matrix, got "
                         f"{tuple(recs.shape)} {recs.dtype}")
    rec_w = recs.shape[1] if rec_w is None else rec_w
    if rec_w <= 0 or recs.shape[1] % rec_w:
        raise ValueError(f"row of {recs.shape[1]} words is not a whole "
                         f"number of {rec_w}-word records")
    if not 0 <= n_dense <= rec_w:
        raise ValueError(f"n_dense={n_dense} outside a {rec_w}-word record")
    if modulus == 0 or not -2**31 <= modulus < 2**31:
        raise ValueError(f"modulus {modulus} is not a non-zero int32")
    return rec_w


def preproc_cuda(recs: torch.Tensor, n_dense: int, modulus: int, *,
                 rec_w: Optional[int] = None) -> torch.Tensor:
    """recs (R, C) int32 on the card, unit column stride, any row stride;
    each row holds ``C // rec_w`` records -> (R * C // rec_w, rec_w)
    int32, contiguous."""
    if not recs.is_cuda:
        raise ValueError("preproc_cuda needs a CUDA tensor")
    rec_w = _check(recs, n_dense, modulus, rec_w)
    if recs.numel() >= 2**31:
        raise ValueError(f"{recs.numel()} words: the kernel indexes fewer "
                         "than 2^31")
    rows, cols = recs.shape
    unit_cols = cols <= 1 or recs.stride(1) == 1
    rows_apart = rows <= 1 or recs.stride(0) >= cols
    if not (unit_cols and rows_apart):
        recs = recs.contiguous()
    out = torch.empty((rows * cols // rec_w, rec_w), dtype=torch.int32,
                      device=recs.device)
    if rows * cols:
        lib = _lib()
        with torch.cuda.device(recs.device):
            stream = torch.cuda.current_stream(recs.device).cuda_stream
            err = lib.preproc_launch(recs.data_ptr(), out.data_ptr(), rows,
                                     cols, recs.stride(0), rec_w, n_dense,
                                     modulus, *floor_mod_magic(modulus),
                                     stream)
            preproc_cuda.launches += 1
        _build.check(lib, err, "preproc")
    return out


preproc_cuda.launches = 0


def preproc_ref(recs: torch.Tensor, n_dense: int, modulus: int, *,
                rec_w: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version, same arguments as ``preproc_cuda``."""
    rec_w = _check(recs, n_dense, modulus, rec_w)
    return R.preproc_ref(recs.reshape(-1, rec_w), n_dense, modulus)
