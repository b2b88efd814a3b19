"""The port's kernels against the JAX reference, on the CPU.

Inputs are made from numpy seeds and go through three versions: the
port's plain PyTorch version (``repro_torch.kernels.ops``, which a CPU
tensor dispatches to), the reference's pure-jnp oracle and the
reference's Pallas wrapper in interpret mode (as tests/test_kernels.py
runs it).  AES, CRC32 and the key schedule must agree bit for bit; DPI
scores within rtol = atol = 1e-5 (float32 sums taken in another order),
with the worst error printed.  tests/test_torch_cuda.py holds the
hand-written kernels against the plain versions on the card.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dpi_mlp import init_dpi_params, ternarize
from repro_torch.data import load_dpi_params_seed0
from repro_torch.kernels import ops
from repro_torch.kernels.aes_ecb import aes_ecb_cuda
from repro_torch.kernels.crc32 import crc32_cuda
from repro_torch.kernels.dpi_mlp import dpi_params_from_numpy, dpi_scores_cuda

torch.set_num_threads(1)

DPI_RTOL = DPI_ATOL = 1e-5
KEY = np.arange(16, dtype=np.uint8)


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


# ---------------------------------------------------------------------------
# AES
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_expand_key_matches_reference(seed):
    key = KEY if seed == 0 else \
        np.random.default_rng(seed).integers(0, 256, 16, dtype=np.uint8)
    np.testing.assert_array_equal(ops.expand_key(key), jref.expand_key(key))
    assert ops.expand_key(key).dtype == np.uint8


def test_aes_fips197_vector():
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       np.uint8)
    rk = ops.expand_key(KEY)
    ct = ops.aes_ecb(_t(pt[None]), rk).numpy()[0]
    assert ct.tobytes().hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
    back = ops.aes_ecb(_t(ct[None]), rk, decrypt=True).numpy()[0]
    np.testing.assert_array_equal(back, pt)


# the Pallas wrapper in interpret mode compiles per shape (seconds each),
# so one case runs it and the others hold the port against the oracle
@pytest.mark.parametrize("n,seed,impl", [(1, 0, "ref"), (37, 1, "ref"),
                                         (512, 2, "pallas"),
                                         (1029, 3, "ref")])
def test_aes_matches_reference(n, seed, impl):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    rk = ops.expand_key(rng.integers(0, 256, 16, dtype=np.uint8))
    enc = ops.aes_ecb(_t(blocks), rk).numpy()
    np.testing.assert_array_equal(
        enc, np.asarray(jops.aes_ecb(jnp.asarray(blocks), rk, impl=impl)))
    dec = ops.aes_ecb(_t(enc), rk, decrypt=True).numpy()
    np.testing.assert_array_equal(dec, blocks)
    np.testing.assert_array_equal(
        ops.aes_ecb(_t(blocks), rk, decrypt=True).numpy(),
        np.asarray(jops.aes_ecb(jnp.asarray(blocks), rk, decrypt=True,
                                impl=impl)))


# ---------------------------------------------------------------------------
# CRC32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,mtu,seed", [(9, 64, 0), (17, 256, 1),
                                        (5, 512, 2)])
def test_crc32_matches_zlib_and_reference(n, mtu, seed):
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (n, mtu), dtype=np.uint8)
    plen = rng.integers(0, mtu + 1, n).astype(np.int32)
    plen[0] = mtu                                  # a full packet
    got = ops.crc32(_t(pay), _t(plen)).numpy()
    assert got.dtype == np.int64 and (got >= 0).all() and (got < 2**32).all()
    want = np.array([zlib.crc32(pay[i, :plen[i]].tobytes())
                     for i in range(n)], np.int64)
    np.testing.assert_array_equal(got, want)
    for impl in ("ref", "pallas"):
        np.testing.assert_array_equal(
            got, np.asarray(jops.crc32(jnp.asarray(pay), jnp.asarray(plen),
                                       impl=impl)).astype(np.int64),
            err_msg=impl)


def test_crc32_full_mtu_and_out_of_range_lengths():
    """MTU-sized payloads, plen past the MTU (clamped) and negative plen
    (nothing read), against zlib."""
    rng = np.random.default_rng(7)
    pay = rng.integers(0, 256, (4, 4096), dtype=np.uint8)
    plen = np.array([4096, 5000, -3, 4095], np.int32)
    got = ops.crc32(_t(pay), _t(plen)).numpy()
    want = [zlib.crc32(pay[i, :max(0, min(plen[i], 4096))].tobytes())
            for i in range(4)]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# DPI MLP
# ---------------------------------------------------------------------------

def _worst(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b))) \
        if np.size(a) else 0.0


@pytest.mark.parametrize("n,mtu,seed", [(3, 64, 0), (5, 256, 1),
                                        (2, 4096, 2)])
def test_dpi_scores_match_reference(n, mtu, seed):
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v) for k, v in
              ternarize(init_dpi_params(jax.random.key(seed))).items()}
    pay = rng.integers(0, 256, (n, mtu), dtype=np.uint8)
    tparams = dpi_params_from_numpy(params, "cpu")
    got = ops.dpi_scores(_t(pay), tparams).numpy()
    assert got.shape == (n, mtu // 64) and got.dtype == np.float32
    for impl in ("ref", "pallas"):
        want = np.asarray(jops.dpi_scores(jnp.asarray(pay), params,
                                          impl=impl))
        print(f"dpi {impl}: worst abs error {_worst(got, want):.3e}")
        np.testing.assert_allclose(got, want, rtol=DPI_RTOL, atol=DPI_ATOL,
                                   err_msg=impl)


def test_dpi_fixture_scores_match_reference():
    """The committed fixture through both packages on mixed traffic."""
    from repro.data.dpi_dataset import payload_with_embedded_malware
    params = load_dpi_params_seed0()
    rng = np.random.default_rng(5)
    pay = np.stack([payload_with_embedded_malware(4096, f, rng)
                    for f in (0.0, 0.2, 1.0, 0.0)])
    got = ops.dpi_scores(_t(pay), dpi_params_from_numpy(params, "cpu"))
    want = np.asarray(jops.dpi_scores(jnp.asarray(pay), params, impl="ref"))
    print(f"dpi fixture: worst abs error {_worst(got.numpy(), want):.3e}")
    np.testing.assert_allclose(got.numpy(), want, rtol=DPI_RTOL,
                               atol=DPI_ATOL)


def test_dpi_params_from_numpy():
    params = load_dpi_params_seed0()
    t = dpi_params_from_numpy(params, "cpu")
    assert set(t) == set(params)
    for k, v in t.items():
        assert v.device.type == "cpu"
        assert v.dtype == (torch.int8 if k.startswith("w") else torch.float32)
        np.testing.assert_array_equal(v.numpy(), params[k])
    bad = dict(params, w2=params["w2"].astype(np.float32) * 0.5)
    with pytest.raises(ValueError, match="ternary"):
        dpi_params_from_numpy(bad, "cpu")
    with pytest.raises(ValueError, match="shape"):
        dpi_params_from_numpy(dict(params, b1=params["b2"]), "cpu")


def test_fixture_is_the_trained_reference_model():
    """The fixture, through the reference's own DpiService, flags
    embedded executables and passes benign payloads (the property
    tests/test_services.py asserts for a freshly trained model)."""
    from repro.core.services import DpiService as JDpi
    from repro.data.dpi_dataset import payload_with_embedded_malware
    svc = JDpi(params={k: jnp.asarray(v)
                       for k, v in load_dpi_params_seed0().items()})
    rng = np.random.default_rng(2)
    mal = np.stack([payload_with_embedded_malware(4096, 1.0, rng)
                    for _ in range(16)])
    ben = np.stack([payload_with_embedded_malware(4096, 0.0, rng)
                    for _ in range(16)])
    plen = jnp.asarray(np.full(16, 4096, np.int32))
    assert np.asarray(svc(jnp.asarray(mal), plen)).mean() > 0.9
    assert np.asarray(svc(jnp.asarray(ben), plen)).mean() < 0.2


# ---------------------------------------------------------------------------
# Dispatch: a CPU tensor never reaches a kernel, a kernel never falls back
# ---------------------------------------------------------------------------

def test_cuda_impl_on_cpu_tensor_raises():
    """The kernel wrappers take only CUDA tensors, and ``ops`` knows no
    impl but None (by device) and "ref"."""
    blocks = torch.zeros((4, 16), dtype=torch.uint8)
    pay = torch.zeros((2, 64), dtype=torch.uint8)
    plen = torch.full((2,), 64, dtype=torch.int32)
    params = dpi_params_from_numpy(load_dpi_params_seed0(), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        aes_ecb_cuda(blocks, ops.expand_key(KEY))
    with pytest.raises(ValueError, match="CUDA"):
        crc32_cuda(pay, plen)
    with pytest.raises(ValueError, match="CUDA"):
        dpi_scores_cuda(pay, params)
    for bad in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="impl"):
            ops.aes_ecb(blocks, ops.expand_key(KEY), impl=bad)
        with pytest.raises(ValueError, match="impl"):
            ops.crc32(pay, plen, impl=bad)
        with pytest.raises(ValueError, match="impl"):
            ops.dpi_scores(pay, params, impl=bad)


def test_build_target_covers_the_shared_headers(tmp_path, monkeypatch):
    """A kernel's library is named by the hash of its source, the flags
    and every shared header in csrc/: a changed header (dpi_mma.cuh, which
    dpi_mlp.cu and fused_chain.cu include) names a new library, so a
    stale one is never reused."""
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    assert (csrc / "dpi_mma.cuh").exists()
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.target(name) for name in _build.SOURCES}
    assert before == {name: _build.target(name) for name in _build.SOURCES}
    header = csrc / "dpi_mma.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    after = {name: _build.target(name) for name in _build.SOURCES}
    for name in ("dpi_mlp", "fused_chain"):
        assert after[name] != before[name], name
    (csrc / "new_helper.cuh").write_text("#pragma once\n")
    assert _build.target("dpi_mlp") != after["dpi_mlp"]


def test_default_device_needs_a_card():
    """Entry points default to the card; without one they raise instead
    of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dpi_params_from_numpy(load_dpi_params_seed0())
