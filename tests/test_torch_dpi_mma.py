"""The arithmetic of the port's tensor-core DPI MLP, on the CPU.

``csrc/dpi_mma.cuh`` computes the ternary MLP in a scheme of its own:
layer 1 as an exact int32 product of ``byte ^ 0x80`` (read as s8, that is
``128 * x``) with the s8 weights, scaled by ``s1 / 128`` after the sum;
layer 2 over an exact three-way bf16 split of h1 (``hi + mid + lo``) with
fp32 sums, scaled by ``s2`` after the sum; layer 3 in fp32.  The CUDA
kernel cannot run here, so this file emulates the scheme in numpy and
torch and holds it against the reference's Pallas kernel (interpret
mode) and the port's plain version, at rtol = atol = 1e-5, on the fixture
weights and on weights forced to all +1 and all -1 (the largest sums),
over random, all-0x00 and all-0xFF beats.  Every case is also held
against a float64 evaluation of the same MLP at 1e-5.  Where a float32
reference itself lies further than 1e-5 from float64 (all +1 weights on
random bytes: layer 1 sums 64 products of both signs that cancel, and the
all-positive layers 2 and 3 add the rounding of 128 such sums), the test
asserts that the scheme is the closer of the two to float64 instead.
tests/test_torch_cuda.py holds the kernel itself against the plain
version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dpi_mlp import dpi_scores_pallas
from repro_torch.data import load_dpi_params_seed0
from repro_torch.kernels.dpi_mlp import dpi_params_from_numpy, dpi_scores_ref

torch.set_num_threads(1)

DPI_RTOL = DPI_ATOL = 1e-5
N_PKTS, MTU = 4, 1024


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> nearest bf16 (ties to even), back as float32."""
    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def _fma32(a, b, c) -> np.ndarray:
    """a * b + c in float64, rounded once to float32 (fmaf: the product
    of a float32 and an int below 2**14 is exact in float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _split3(h1: np.ndarray):
    hi = _bf16(h1)
    mid = _bf16(h1 - hi)
    lo = _bf16(h1 - hi - mid)
    return hi, mid, lo


def _mma_scheme(payload: np.ndarray, p: dict) -> np.ndarray:
    """The kernel's scheme: (N, MTU) uint8 -> (N, MTU // 64) float32."""
    n, mtu = payload.shape
    x8 = (payload.reshape(-1, 64) ^ 0x80).view(np.int8).astype(np.int32)
    acc1 = x8 @ p["w1"].astype(np.int32)                      # exact
    s1q = np.float32(p["s1"]) * np.float32(1 / 128)
    h1 = np.maximum(_fma32(acc1, s1q, p["b1"]), np.float32(0))
    pieces = _split3(h1)
    w2 = p["w2"].astype(np.float32)
    acc2 = np.zeros((h1.shape[0], w2.shape[1]), np.float32)
    for piece in pieces:                  # three passes, fp32 sums
        acc2 = acc2 + (torch.from_numpy(piece) @ torch.from_numpy(w2)
                       ).numpy()
    h2 = np.maximum(_fma32(acc2, np.float32(p["s2"]), p["b2"]),
                    np.float32(0))
    w3 = p["w3"].astype(np.float32) * np.float32(p["s3"])
    return (h2 @ w3)[:, 0].reshape(n, mtu // 64), h1, pieces


def _float64(payload: np.ndarray, p: dict) -> np.ndarray:
    """The MLP of the reference in float64."""
    x = payload.reshape(-1, 64).astype(np.float64) / 128.0 - 1.0
    h = np.maximum(x @ (p["w1"] * np.float64(p["s1"])) + p["b1"], 0.0)
    h = np.maximum(h @ (p["w2"] * np.float64(p["s2"])) + p["b2"], 0.0)
    return (h @ (p["w3"] * np.float64(p["s3"])))[:, 0].reshape(
        payload.shape[0], -1)


def _excess(got, want) -> float:
    """The largest |got - want| / (atol + rtol * |want|): <= 1 passes."""
    return float(np.max(np.abs(np.float64(got) - want)
                        / (DPI_ATOL + DPI_RTOL * np.abs(want))))


def _params(weights: str) -> dict:
    p = {k: np.asarray(v) for k, v in load_dpi_params_seed0().items()}
    if weights != "fixture":
        sign = 1 if weights == "plus1" else -1
        for k in ("w1", "w2", "w3"):
            p[k] = np.full_like(p[k], sign)
    return p


def _payload(kind: str) -> np.ndarray:
    if kind == "random":
        return np.random.default_rng(0).integers(0, 256, (N_PKTS, MTU),
                                                 dtype=np.uint8)
    return np.full((N_PKTS, MTU), 0x00 if kind == "0x00" else 0xFF,
                   np.uint8)


@pytest.mark.parametrize("weights", ["fixture", "plus1", "minus1"])
@pytest.mark.parametrize("bytes_", ["random", "0x00", "0xFF"])
def test_mma_scheme_matches_reference_and_plain(weights, bytes_):
    p, pay = _params(weights), _payload(bytes_)
    got, h1, (hi, mid, lo) = _mma_scheme(pay, p)
    # the split is exact: three bf16 pieces of 8 bits hold fp32's 24
    np.testing.assert_array_equal(
        hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64),
        h1.astype(np.float64))
    np.testing.assert_array_equal(hi + mid + lo, h1)
    pallas = np.asarray(dpi_scores_pallas(jnp.asarray(pay),
                                          {k: jnp.asarray(v)
                                           for k, v in p.items()},
                                          interpret=True))
    plain = dpi_scores_ref(torch.from_numpy(pay),
                           dpi_params_from_numpy(p, "cpu")).numpy()
    exact = _float64(pay, p)
    assert got.shape == plain.shape == pallas.shape == (N_PKTS, MTU // 64)
    print(f"dpi mma scheme ({weights}, {bytes_}): worst abs error vs "
          f"float64 {np.max(np.abs(got - exact)):.3e}")
    np.testing.assert_allclose(got, exact, rtol=DPI_RTOL, atol=DPI_ATOL,
                               err_msg="float64")
    for name, want in (("pallas", pallas), ("plain", plain)):
        worst = float(np.max(np.abs(got.astype(np.float64) - want)))
        print(f"dpi mma scheme vs {name} ({weights}, {bytes_}): worst abs "
              f"error {worst:.3e}")
        if _excess(want, exact) <= 1.0:
            np.testing.assert_allclose(got, want, rtol=DPI_RTOL,
                                       atol=DPI_ATOL, err_msg=name)
        else:             # the float32 reference is the one that is off
            assert _excess(got, exact) < _excess(want, exact), name


def test_weight_image_is_what_the_kernels_read():
    """The kernels copy ``weight_image`` into shared memory as it is;
    read it back as the MMA loop does (lane 4g + t of n-tile j reads the
    j-th 256 bytes' uint2 number lane) and recover both matrices as the
    PTX fragment layouts define the B operands: m16n8k32 s8 (4 k a word,
    words k and k + 16) and m16n8k16 bf16 (2 k a word, words k and
    k + 8); then b1, b2, w3 * s3, s1 / 128 and s2 in float32."""
    from repro_torch.kernels.dpi_mlp import weight_image
    rng = np.random.default_rng(3)
    p = {k: np.asarray(v) for k, v in load_dpi_params_seed0().items()}
    p["w1"] = rng.integers(-1, 2, (64, 128)).astype(np.int8)
    p["w2"] = rng.integers(-1, 2, (128, 64)).astype(np.int8)
    tp = dpi_params_from_numpy(p, "cpu")
    image = weight_image(tp).numpy()
    assert image.dtype == np.uint8 and image.shape == (25616,)
    f1 = image[:8192].view(np.int8).reshape(2, 16, 32, 2, 4)
    f2 = torch.from_numpy(image[8192:24576].copy()).view(torch.bfloat16) \
        .float().numpy().reshape(8, 8, 32, 2, 2)
    got1 = np.zeros_like(p["w1"])
    got2 = np.zeros((128, 64), np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(16):
            for ks in range(2):
                for word in range(2):
                    for byte in range(4):
                        got1[32 * ks + 16 * word + 4 * t + byte, 8 * j + g] = \
                            f1[ks, j, lane, word, byte]
        for n in range(8):
            for kc in range(8):
                for word in range(2):
                    for half in range(2):
                        got2[16 * kc + 8 * word + 2 * t + half, 8 * n + g] = \
                            f2[kc, n, lane, word, half]
    np.testing.assert_array_equal(got1, p["w1"])
    np.testing.assert_array_equal(got2, p["w2"].astype(np.float32))
    tail = image[24576:].view(np.float32)
    np.testing.assert_array_equal(tail[:128], p["b1"])
    np.testing.assert_array_equal(tail[128:192], p["b2"])
    np.testing.assert_array_equal(
        tail[192:256], (tp["w3"].float() * tp["s3"]).numpy()[:, 0])
    np.testing.assert_array_equal(tail[256:], [np.float32(p["s1"]) / 128,
                                               p["s2"], 0, 0])
