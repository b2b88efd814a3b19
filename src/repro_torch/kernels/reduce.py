"""Segmented payload reduction on the card — the math of the collective
subsystem (ring reduce-scatter / allreduce and the in-fabric reduction
offload of ``repro_torch.core.collectives``).

The operation: fold K contribution payloads (rows) into one, summing
element-wise in **row order** — ``((x0 + x1) + x2) + ...`` — a strict
left fold.  Order is part of the contract: float32 addition is
commutative but not associative, and the collective layer's bit-identity
guarantee (ring schedule == switch offload == oracle) holds exactly
because every path folds contributions in the same canonical order.

``reduce_fold_cuda`` launches the hand-written Hopper kernel in
``csrc/reduce.cu`` (a thread folds runs of 4 lanes, every row's loads in
flight before its first add, rows folded in order);
``reduce_fold_ref`` is the plain PyTorch version from ``ref.py``.
``ops.chunk_reduce`` takes the wire bytes, ``(K, nbytes)`` uint8, views
them as the collective dtype without a copy (``payload_words``), folds,
and views the result back as bytes.

``reduce_fold_cuda.launches`` counts the kernel launches of this
process.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

DTYPES = {"float32": torch.float32, "int32": torch.int32}
_CODES = {torch.float32: 0, torch.int32: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("reduce")
    lib.reduce_fold_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.reduce_fold_launch.restype = ctypes.c_int
    return lib


def reduce_fold_cuda(x: torch.Tensor) -> torch.Tensor:
    """(K, L) float32 or int32 on the card, unit lane stride -> (L,)."""
    if not x.is_cuda:
        raise ValueError("reduce_fold_cuda needs a CUDA tensor")
    if x.dtype not in _CODES or x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be (K>=1, L) float32 or int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    k, lanes = x.shape
    if lanes >= 2**31:
        raise ValueError(f"{lanes} lanes: the kernel indexes fewer than 2^31")
    if lanes > 1 and x.stride(1) != 1 or k > 1 and x.stride(0) < lanes:
        x = x.contiguous()
    out = torch.empty(lanes, dtype=x.dtype, device=x.device)
    if lanes:
        lib = _lib()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.reduce_fold_launch(x.data_ptr(), out.data_ptr(), k,
                                         lanes, x.stride(0),
                                         _CODES[x.dtype], stream)
            reduce_fold_cuda.launches += 1
        _build.check(lib, err, "reduce_fold")
    return out


reduce_fold_cuda.launches = 0

reduce_fold_ref = R.reduce_fold_ref


def payload_words(payload: torch.Tensor, dtype: str) -> torch.Tensor:
    """The collective's wire payloads, ``(K, nbytes)`` uint8, viewed in
    place as ``(K, nbytes / 4)`` elements of ``dtype`` (never converted).
    ``nbytes`` must be a multiple of the dtype width (collective chunks
    are element-aligned by construction)."""
    if dtype not in DTYPES:
        raise ValueError(f"unsupported collective dtype {dtype!r}")
    if payload.dtype != torch.uint8 or payload.dim() != 2:
        raise ValueError(f"payload must be (K, nbytes) uint8, got "
                         f"{tuple(payload.shape)} {payload.dtype}")
    width = torch.empty((), dtype=DTYPES[dtype]).element_size()
    assert payload.shape[1] % width == 0, (payload.shape[1], dtype)
    return payload.contiguous().view(DTYPES[dtype])
