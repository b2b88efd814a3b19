"""The hand-written CUDA kernels against their plain PyTorch versions,
on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
decision is taken inside a fixture, never at import).  The module
imports no JAX, so it runs on a machine with the card and PyTorch only:

    python -m pytest -m cuda tests/test_torch_cuda.py

AES and CRC32 must be bit-exact (CRC32 also against zlib); DPI scores
within rtol = atol = 1e-5, the worst error printed.
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.data import load_dpi_params_seed0
from repro_torch.kernels import ops
from repro_torch.kernels.dpi_mlp import dpi_params_from_numpy

DPI_RTOL = DPI_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 4097])
def test_cuda_aes_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    blocks = _t(rng.integers(0, 256, (n, 16), dtype=np.uint8)).to(cuda)
    rk = ops.expand_key(rng.integers(0, 256, 16, dtype=np.uint8))
    for decrypt in (False, True):
        got = ops.aes_ecb(blocks, rk, decrypt=decrypt)
        want = ops.aes_ecb(blocks, rk, decrypt=decrypt, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,mtu", [(1, 64), (130, 256), (33, 4096)])
def test_cuda_crc32_matches_plain(cuda, n, mtu):
    rng = np.random.default_rng(mtu)
    pay = rng.integers(0, 256, (n, mtu), dtype=np.uint8)
    plen = rng.integers(-1, mtu + 2, n).astype(np.int32)
    got = ops.crc32(_t(pay).to(cuda), _t(plen).to(cuda)).cpu().numpy()
    want = [zlib.crc32(pay[i, :max(0, min(plen[i], mtu))].tobytes())
            for i in range(n)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,mtu", [(1, 64), (77, 4096)])
def test_cuda_dpi_matches_plain(cuda, n, mtu):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(n)
    pay = _t(rng.integers(0, 256, (n, mtu), dtype=np.uint8)).to(cuda)
    params = dpi_params_from_numpy(load_dpi_params_seed0(), cuda)
    got = ops.dpi_scores(pay, params)
    want = ops.dpi_scores(pay, params, impl="ref")
    print(f"dpi cuda: worst abs error "
          f"{float((got - want).abs().max()):.3e}")
    torch.testing.assert_close(got, want, rtol=DPI_RTOL, atol=DPI_ATOL)


@pytest.mark.cuda
def test_cuda_launch_counters_count_kernel_launches_only(cuda):
    pay = torch.zeros((4, 64), dtype=torch.uint8, device=cuda)
    plen = torch.full((4,), 64, dtype=torch.int32, device=cuda)
    ops.reset_launches()
    ops.crc32(pay, plen)
    ops.crc32(pay, plen, impl="ref")
    ops.aes_ecb(pay.reshape(-1, 16), ops.expand_key(np.zeros(16, np.uint8)))
    assert ops.launches() == {"aes_ecb": 1, "crc32": 1, "dpi_mlp": 0}
