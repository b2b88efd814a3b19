"""ML-based deep-packet-inspection scores on the card (paper §5.1.2).

A ternary fully-connected network (weights in {-1, 0, +1} with a float
scale per layer) scores every 64-byte beat of every payload.
``dpi_scores_cuda`` launches the hand-written Hopper kernel in
``csrc/dpi_mlp.cu``: the MLP of ``csrc/dpi_mma.cuh`` on the tensor cores,
one warp per 16-beat tile, layer 1 exact in int8 (``byte ^ 0x80`` is
``128 * x`` as s8), layer 2 as three bf16 products over an exact split of
h1 with fp32 accumulation, layer 3 in fp32.  The kernels take the
weights as one image in the order the tensor cores read them
(``weight_image``), built once per weight set.  ``dpi_scores_ref`` is the
plain PyTorch version from ``ref.py``.

``train_dpi_params`` trains the float model on synthetic "big-data
payloads vs. executables" (``repro_torch.data.dpi_dataset``) with
full-batch SGD and ternarizes it (``ternarize``, on the host, into the
format ``dpi_params_from_numpy`` takes), as the reference does.  The
three products of that training are ``torch.matmul`` under autograd:
the reference computes them in jnp too, outside any Pallas kernel.

``dpi_scores_cuda.launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from typing import Dict, Tuple

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
    lib.dpi_mlp_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p]
    lib.dpi_mlp_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def fragment_order() -> Tuple[np.ndarray, np.ndarray]:
    """The order in which the kernels read w1 and w2 as the tensor cores'
    B operands (``csrc/dpi_mma.cuh``): for each byte of the packed w1 (s8)
    and each element of the packed w2 (bf16), its flat index into w1 (64,
    128) and w2 (128, 64).  w1: [ks 2][j 16][lane 32][word 2][byte 4] of
    w1[32ks + 16word + 4t + byte][8j + g]; w2: [kc 8][n 8][lane 32][word
    2][half 2] of w2[16kc + 8word + 2t + half][8n + g]; lane = 4g + t.
    These are the m16n8k32 s8 and m16n8k16 bf16 B-fragment layouts."""
    ks, j, lane, word, byte = np.meshgrid(np.arange(2), np.arange(16),
                                          np.arange(32), np.arange(2),
                                          np.arange(4), indexing="ij")
    w1 = (32 * ks + 16 * word + 4 * (lane & 3) + byte) * D_H1 \
        + 8 * j + (lane >> 2)
    kc, n, lane, word, half = np.meshgrid(np.arange(8), np.arange(8),
                                          np.arange(32), np.arange(2),
                                          np.arange(2), indexing="ij")
    w2 = (16 * kc + 8 * word + 2 * (lane & 3) + half) * D_H2 \
        + 8 * n + (lane >> 2)
    return w1.reshape(-1), w2.reshape(-1)


def weight_image(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernels' weights as one image that a block copies into shared
    memory as it is (25,616 uint8 on the parameters' device): w1 as s8
    and w2 as bf16 (exact: both are ternary) in ``fragment_order()``, then
    float32 b1, b2, w3 * s3 (the plain version's product), s1 / 128 (exact:
    a power of two) and s2, and two zero words."""
    p = params
    i1, i2 = (torch.from_numpy(i).to(p["w1"].device)
              for i in fragment_order())
    tail = torch.cat([p["b1"], p["b2"],
                      p["w3"].reshape(-1).to(torch.float32) * p["s3"],
                      (p["s1"] * (1.0 / 128)).reshape(1), p["s2"].reshape(1),
                      p["b1"].new_zeros(2)])
    return torch.cat([p["w1"].reshape(-1)[i1].view(torch.uint8),
                      p["w2"].reshape(-1)[i2].to(torch.bfloat16)
                      .view(torch.uint8),
                      tail.view(torch.uint8)])


# the images of the last few weight sets, so that a set is packed once and
# not on every launch.  An entry keeps its tensors alive, so that their
# addresses cannot be reused, and names their version counters, so that
# an in-place update of any of them packs anew.
_IMAGES: "OrderedDict[tuple, tuple]" = OrderedDict()


def _image_of(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    key = tuple((p[k].data_ptr(), p[k]._version) for k in _SHAPES)
    hit = _IMAGES.get(key)
    if hit is None:
        hit = _IMAGES[key] = (dict(p), weight_image(p))
        while len(_IMAGES) > 4:
            _IMAGES.popitem(last=False)
    return hit[1]


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
            err = lib.dpi_mlp_launch(payload.data_ptr(),
                                     _image_of(p).data_ptr(), out.data_ptr(),
                                     n * beats, stream)
            dpi_scores_cuda.launches += 1
        _build.check(lib, err, "dpi_mlp")
    return out.reshape(n, beats)


dpi_scores_cuda.launches = 0

dpi_scores_ref = R.dpi_scores_ref


# ---------------------------------------------------------------------------
# Training + ternarization
# ---------------------------------------------------------------------------

_FLOAT_KEYS = ("w1", "b1", "w2", "b2", "w3")


def init_dpi_params(seed: int = 0, device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """The float model's initial parameters: normal weights times 0.2,
    zero biases, unit scales — the reference's rule, drawn on a CPU
    ``torch.Generator`` seeded with ``seed`` (the same weights on every
    device; they cannot equal JAX's threefry draws), then moved to
    ``device`` (default the card)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    p = {"w1": torch.randn((D_IN, D_H1), generator=gen) * 0.2,
         "b1": torch.zeros(D_H1),
         "w2": torch.randn((D_H1, D_H2), generator=gen) * 0.2,
         "b2": torch.zeros(D_H2),
         "w3": torch.randn((D_H2, 1), generator=gen) * 0.2,
         "s1": torch.tensor(1.0), "s2": torch.tensor(1.0),
         "s3": torch.tensor(1.0)}
    return {k: v.to(dev) for k, v in p.items()}


def _float_forward(p: Dict[str, torch.Tensor], x: torch.Tensor
                   ) -> torch.Tensor:
    h = torch.relu(x @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    return (h @ p["w3"])[:, 0]


def ternarize(params: Dict) -> Dict[str, np.ndarray]:
    """Magnitude-threshold ternarization with per-layer scale (TWN rule:
    threshold = 0.7 * mean|w|, scale = mean|w| over kept entries), on
    the host in numpy as the reference computes it.  Returns ``w*`` int8,
    ``s*`` and ``b*`` float32 (the fixture's format)."""
    def host(v):
        return (v.detach().to("cpu").numpy() if torch.is_tensor(v)
                else np.asarray(v))
    out = {}
    for i, w_name in enumerate(("w1", "w2", "w3"), 1):
        w = host(params[w_name])
        thr = 0.7 * np.abs(w).mean()
        tern = np.sign(w) * (np.abs(w) > thr)
        kept = np.abs(w[np.abs(w) > thr])
        scale = float(kept.mean()) if kept.size else 1.0
        out[w_name] = np.asarray(tern, np.int8)
        out[f"s{i}"] = np.asarray(scale, np.float32)
    out["b1"] = np.asarray(host(params["b1"]), np.float32)
    out["b2"] = np.asarray(host(params["b2"]), np.float32)
    return out


def train_float_dpi_params(params: Dict, beats: np.ndarray,
                           labels: np.ndarray, steps: int = 300,
                           lr: float = 3e-3, device: DeviceLike = None
                           ) -> Dict[str, torch.Tensor]:
    """Full-batch SGD of the float model from ``params`` (tensors or
    numpy arrays: ``w1, b1, w2, b2, w3``) on ``beats`` (M, 64) uint8 and
    ``labels`` (M,) {0, 1}, on ``device`` (default the card): ``x =
    beats / 128 - 1`` in float32 and the reference's numerically stable
    logistic loss, ``max(l, 0) - l * y + log1p(exp(-|l|))``, averaged.
    Returns the trained float weights and biases."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(beats)).to(dev, torch.float32) \
        / 128.0 - 1.0
    y = torch.as_tensor(np.asarray(labels)).to(dev, torch.float32)
    p = {k: (params[k] if torch.is_tensor(params[k])
             else torch.from_numpy(np.array(params[k], np.float32)))
         .to(dev, torch.float32, copy=True).requires_grad_(True)
         for k in _FLOAT_KEYS}
    for _ in range(steps):
        logits = _float_forward(p, x)
        loss = torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                          - logits * y
                          + torch.log1p(torch.exp(-torch.abs(logits))))
        grads = torch.autograd.grad(loss, [p[k] for k in _FLOAT_KEYS])
        with torch.no_grad():
            p = {k: (p[k] - lr * g).requires_grad_(True)
                 for k, g in zip(_FLOAT_KEYS, grads)}
    return {k: v.detach() for k, v in p.items()}


def train_dpi_params(beats: np.ndarray, labels: np.ndarray,
                     steps: int = 300, lr: float = 3e-3, seed: int = 0,
                     device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """beats (M, 64) uint8, labels (M,) {0,1}: train the float model from
    ``init_dpi_params(seed)`` on ``device`` (default the card) and
    return its ternary parameters (``ternarize``)."""
    p0 = init_dpi_params(seed, device)
    return ternarize(train_float_dpi_params(p0, beats, labels, steps, lr,
                                            device))
