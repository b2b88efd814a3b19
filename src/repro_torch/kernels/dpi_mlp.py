"""ML-based deep-packet-inspection scores on the card (paper §5.1.2).

A ternary fully-connected network (weights in {-1, 0, +1} with a float
scale per layer) scores every 64-byte beat of every payload.
``dpi_scores_cuda`` launches the hand-written Hopper kernel in
``csrc/dpi_mlp.cu`` (weights staged pre-scaled in shared memory, one
thread per beat, fp32 FMA on the CUDA cores).  ``dpi_scores_ref`` is the
plain PyTorch version from ``ref.py``.

Training and ternarization stay in the reference package for now: the
port takes the reference's ternary parameters through
``dpi_params_from_numpy``.

``dpi_scores_cuda.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

D_IN, D_H1, D_H2 = R.DPI_DIMS
_SHAPES = {"w1": (D_IN, D_H1), "b1": (D_H1,), "w2": (D_H1, D_H2),
           "b2": (D_H2,), "w3": (D_H2, 1), "s1": (), "s2": (), "s3": ()}


def dpi_params_from_numpy(params: Dict[str, np.ndarray],
                          device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The reference's ternary DPI parameters as the port's tensors:
    ``w*`` int8, ``b*`` and ``s*`` float32, on ``device`` (default the
    card)."""
    dev = resolve_device(device)
    out = {}
    for k, shape in _SHAPES.items():
        a = np.asarray(params[k])
        if a.shape != shape:
            raise ValueError(f"DPI parameter {k}: shape {a.shape}, "
                             f"expected {shape}")
        if k.startswith("w"):
            if not np.array_equal(a, np.clip(np.rint(a), -1, 1)):
                raise ValueError(f"DPI weight {k} is not ternary")
            out[k] = to_device(a.astype(np.int8), dev)
        else:
            out[k] = to_device(a.astype(np.float32), dev)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dpi_mlp")
    lib.dpi_mlp_launch.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_longlong, ctypes.c_void_p]
    lib.dpi_mlp_launch.restype = ctypes.c_int
    return lib


def _checked(params: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, shape in _SHAPES.items():
        t = params[k]
        want = torch.int8 if k.startswith("w") else torch.float32
        if t.device != device or t.dtype != want or tuple(t.shape) != shape:
            raise ValueError(
                f"DPI parameter {k} must be {want} {shape} on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} "
                f"(see dpi_params_from_numpy)")
        out[k] = t.contiguous()
    return out


def dpi_scores_cuda(payload: torch.Tensor, params: Dict) -> torch.Tensor:
    """payload (N, MTU) uint8 on the card -> per-beat scores (N, MTU//64)
    float32."""
    if not payload.is_cuda:
        raise ValueError("dpi_scores_cuda needs a CUDA tensor")
    if payload.dtype != torch.uint8 or payload.dim() != 2 \
            or payload.shape[1] % 64:
        raise ValueError(f"payload must be (N, MTU) uint8 with MTU % 64 == 0,"
                         f" got {tuple(payload.shape)} {payload.dtype}")
    if not payload.is_contiguous() or payload.data_ptr() % 16:
        raise ValueError("payload must be contiguous and 16-byte aligned")
    p = _checked(params, payload.device)
    n, mtu = payload.shape
    beats = mtu // 64
    out = torch.empty(n * beats, dtype=torch.float32, device=payload.device)
    if n * beats:
        lib = _lib()
        with torch.cuda.device(payload.device):
            stream = torch.cuda.current_stream(payload.device).cuda_stream
            err = lib.dpi_mlp_launch(
                payload.data_ptr(), p["w1"].data_ptr(), p["b1"].data_ptr(),
                p["w2"].data_ptr(), p["b2"].data_ptr(), p["w3"].data_ptr(),
                p["s1"].data_ptr(), p["s2"].data_ptr(), p["s3"].data_ptr(),
                out.data_ptr(), n * beats, stream)
            dpi_scores_cuda.launches += 1
        _build.check(lib, err, "dpi_mlp")
    return out.reshape(n, beats)


dpi_scores_cuda.launches = 0

dpi_scores_ref = R.dpi_scores_ref
