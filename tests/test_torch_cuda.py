"""The hand-written CUDA kernels against their plain PyTorch versions,
on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
decision is taken inside a fixture, never at import).  The module
imports no JAX, so it runs on a machine with the card and PyTorch only:

    python -m pytest -m cuda tests/test_torch_cuda.py

AES (both directions, at block counts around the lane, warp, block and
grid edges, and with its round keys rewritten in place), CRC32 (at its
plen edges, team sizes and load sizes; the ICRC tap's flags too) and the
segmented reduce must be bit-exact (CRC32 also against zlib),
preprocessing bit-exact on the sparse words and within 1 ulp on the dense
ones; DPI scores within rtol = atol = 1e-5, the worst error
printed, and within 1e-5 of a float64 evaluation of the same MLP.  The
fused decrypt+DPI chain: plaintext bit-exact, scores within 1e-5, and
bit-equal to ``dpi_scores(plaintext).amax(1)`` (both kernels run the MLP
of ``csrc/dpi_mma.cuh``, and a beat's score does not depend on the tile,
warp or block that computes it), at launches that pair their warps and
launches that do not.  The fused epoch kernel: its output blob equals
``epoch_ref``'s bit for bit (every shape key of the CPU suites, in the
instantiation the wrapper picks and in each of the two by hand, a
watermark exit, a full wire's abort, ``max_ticks = 1``, a world too wide
for shared memory), the wrapper picks the instantiation by size, and
``run_network(epoch_mode="fused")`` on nodes on the card equals per-tick
stepping on the CPU, whole world.  The data-parallel DLRM exchange: the
bucketed fused ring on the card equals ``allreduce_oracle`` of the whole
vector bit for bit, and one step of ``repro_torch.examples.
allreduce_dlrm`` on the card keeps its sums and parameters bit-identical
to the oracle fold; the DLRM's seeded weights are the CPU's.  The LM
model stack, at float32 with TF32 off: every smoke arch's weights drawn
from one seed equal the CPU's bit for bit, its forward, prefill and
decode logits within 1e-4 of the CPU's; the MoE gives the same bits on
two runs; ``serve_batch`` gives the CPU's greedy tokens.  LM training:
one AdamW update (granite-3-2b) and one Adafactor update (deepseek-v3-
671b) on the card within ``TRAIN_UPDATE_ULPS`` of the CPU's; the smoke
``Trainer`` crashes at step 6 and resumes from step 4 on the card, its
losses those of an uninterrupted run; and granite-3-2b's losses over 4
steps from the same CPU-generator weights within 1e-4 of the CPU's.
DPI training: ``train_dpi_params``' float loop on the card within 1e-5
of the CPU's (of each leaf's largest magnitude), any ternary entry that
differs within that of the threshold, and the card's weights above the
0.85 accuracy bar through the DPI kernel.  The sharded landing zone: a
shard streamed into a zone sharded over "data" of an NCCL mesh of one
(in a subprocess) equals the unsharded zone bit for bit.
"""
import itertools
import zlib

import numpy as np
import pytest
import torch

import _fused_worlds as W
from repro_torch.core import fused as tfused
from repro_torch.core import rdma as trdma
from repro_torch.data import load_dpi_params_seed0
from repro_torch.kernels import fused_epoch as fe
from repro_torch.kernels import ops
from repro_torch.kernels.dpi_mlp import dpi_params_from_numpy
from repro_torch.kernels.fused_chain import (fused_decrypt_dpi,
                                             fused_decrypt_dpi_tile)

DPI_RTOL = DPI_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# block counts around a lane (1), a warp's run of 32 (31-33), 8 runs
# (255-257), a block of 512 threads (511-513) and twice that (1023-1025);
# on an H100 (132 SMs, 2 blocks of 512 threads an SM): a block a run up
# to one an SM (4223-4225 = 132 x 32 +- 1), a warp's second run in flight
# (67,583-67,585 = 132 x 16 x 32 +- 1), the resident grid (135,167-135,169
# = 2 x 132 x 16 x 32 +- 1), and past its two blocks a lane: 1,100,000 is
# more than 132 x 2 x 512 x 2 = 270,336
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 255, 256, 257, 511, 512, 513,
                               1023, 1024, 1025, 4097, 4223, 4224, 4225,
                               67_583, 67_584, 67_585, 135_167, 135_168,
                               135_169, 1_100_000])
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
def test_cuda_aes_reads_round_keys_rewritten_in_place(cuda):
    """AesService keeps its schedule on the card: two keys in successive
    calls on one buffer, rewritten in place between them, give each key's
    blocks (the decrypt schedule is derived on the card at every launch,
    never cached by the buffer's address)."""
    rng = np.random.default_rng(21)
    blocks = _t(rng.integers(0, 256, (3000, 16), dtype=np.uint8)).to(cuda)
    rk = torch.empty((11, 16), dtype=torch.uint8, device=cuda)
    for key in (rng.integers(0, 256, 16, dtype=np.uint8) for _ in range(2)):
        rk.copy_(_t(ops.expand_key(key)))
        for decrypt in (False, True):
            got = ops.aes_ecb(blocks, rk, decrypt=decrypt)
            want = ops.aes_ecb(blocks, rk, decrypt=decrypt, impl="ref")
            torch.cuda.synchronize()
            assert torch.equal(got, want), (key, decrypt)


def _crc_inputs(cuda, n, mtu, offset, seed):
    """n random rows (the first of them at the plen edges -1, 0, 1, 15,
    16, 17, 127-129, MTU - 1, MTU, MTU + 1) in a card buffer whose base is
    ``offset`` bytes past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (n, mtu), dtype=np.uint8)
    plen = rng.integers(-1, mtu + 2, n).astype(np.int32)
    edges = [-1, 0, 1, 15, 16, 17, 127, 128, 129, mtu - 1, mtu, mtu + 1]
    plen[:min(n, len(edges))] = edges[:n]
    buf = torch.empty(n * mtu + 16, dtype=torch.uint8, device=cuda)
    at = (offset - buf.data_ptr()) % 16
    rows = buf[at:at + n * mtu].view(n, mtu)
    rows.copy_(_t(pay))
    assert rows.data_ptr() % 16 == offset
    return pay, plen, rows, _t(plen).to(cuda)


# teams of 1 (MTU 8-64), 2 (136, 256) and 32 lanes (4096: one warp a
# packet; 8192: two 128-byte segments a lane), batches around a warp's
# worth of teams and past the resident grid (4225 warps), and bases 8 B
# off a 16-byte boundary (8-byte loads)
@pytest.mark.cuda
@pytest.mark.parametrize("n,mtu,offset", [
    (1, 64, 0), (130, 256, 0), (33, 4096, 0), (12, 8, 0), (40, 24, 0),
    (33, 136, 0), (15, 256, 0), (16, 256, 0), (17, 256, 0), (12, 8192, 0),
    (4225, 4096, 0), (33, 64, 8), (17, 256, 8), (40, 24, 8), (64, 4096, 8)])
def test_cuda_crc32_matches_plain(cuda, n, mtu, offset):
    pay, plen, rows, plen_t = _crc_inputs(cuda, n, mtu, offset, mtu + n)
    got = ops.crc32(rows, plen_t)
    want = ops.crc32(rows, plen_t, impl="ref")
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and torch.equal(got, want)
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        [zlib.crc32(pay[i, :max(0, min(plen[i], mtu))].tobytes())
         for i in range(n)])


@pytest.mark.cuda
def test_cuda_crc_service_flags_match_plain(cuda):
    """The ICRC tap takes the kernel's int32 bits: the same values, and the
    same chain flags, as with the plain version."""
    from repro_torch.core.services import CrcService, ServiceChain
    pay, plen, rows, plen_t = _crc_inputs(cuda, 300, 4096, 0, 17)
    ops.reset_launches()
    got = CrcService(device=cuda)(rows, plen_t)
    assert ops.launches()["crc32"] == 1
    want = CrcService(impl="ref", device=cuda)(rows, plen_t)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    crcs = np.array([zlib.crc32(pay[i, :max(0, min(plen[i], 4096))]
                                .tobytes()) for i in range(300)], np.uint32)
    np.testing.assert_array_equal(got.cpu().numpy(), crcs.view(np.int32))
    flags = [ServiceChain(parallel=[CrcService(impl=impl, device=cuda)] * 2)
             .process(rows, plen_t)[1] for impl in (None, "ref")]
    assert torch.equal(flags[0], flags[1])


def _float64_scores(pay, params):
    """The MLP of the reference in float64, (N, MTU) -> (N, MTU // 64)."""
    x = pay.reshape(-1, 64).double() / 128.0 - 1.0
    h = torch.relu(x @ (params["w1"].double() * params["s1"].double())
                   + params["b1"].double())
    h = torch.relu(h @ (params["w2"].double() * params["s2"].double())
                   + params["b2"].double())
    y = h @ (params["w3"].double() * params["s3"].double())
    return y.reshape(pay.shape[0], -1)


def _excess(got, want) -> float:
    """The largest |got - want| / (atol + rtol * |want|): <= 1 passes."""
    return float(((got.double() - want).abs()
                  / (DPI_ATOL + DPI_RTOL * want.abs())).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,mtu", [(1, 64), (77, 4096), (5, 192), (3, 320),
                                   (7, 1024), (9, 8192), (1029, 1088)])
def test_cuda_dpi_matches_plain(cuda, n, mtu):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(n)
    pay = _t(rng.integers(0, 256, (n, mtu), dtype=np.uint8)).to(cuda)
    params = dpi_params_from_numpy(load_dpi_params_seed0(), cuda)
    got = ops.dpi_scores(pay, params)
    want = ops.dpi_scores(pay, params, impl="ref")
    print(f"dpi cuda n={n} mtu={mtu}: worst abs error "
          f"{float((got - want).abs().max()):.3e}")
    torch.testing.assert_close(got, want, rtol=DPI_RTOL, atol=DPI_ATOL)
    assert _excess(got, _float64_scores(pay, params)) <= 1.0


def _adversarial_params(cuda, weights):
    p = {k: np.asarray(v) for k, v in load_dpi_params_seed0().items()}
    if weights != "fixture":
        for k in ("w1", "w2", "w3"):
            p[k] = np.full_like(p[k], 1 if weights == "plus1" else -1)
    return dpi_params_from_numpy(p, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["fixture", "plus1", "minus1"])
@pytest.mark.parametrize("bytes_", ["random", "0x00", "0xFF"])
def test_cuda_dpi_adversarial_bytes_and_weights(cuda, weights, bytes_):
    """The largest sums: weights forced to all +1 or all -1, beats of all
    0x00 or all 0xFF.  The kernel stays within 1e-5 of float64, and of the
    plain version wherever the plain version's own float32 rounding keeps
    it within 1e-5 of float64 (all +1 on random bytes sums cancelling
    products; there the kernel must be the closer of the two)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    params = _adversarial_params(cuda, weights)
    if bytes_ == "random":
        pay = _t(np.random.default_rng(0).integers(0, 256, (33, 4096),
                                                   dtype=np.uint8)).to(cuda)
    else:
        pay = torch.full((33, 4096), 0 if bytes_ == "0x00" else 0xFF,
                         dtype=torch.uint8, device=cuda)
    got = ops.dpi_scores(pay, params)
    want = ops.dpi_scores(pay, params, impl="ref")
    exact = _float64_scores(pay, params)
    print(f"dpi cuda ({weights}, {bytes_}): worst abs error vs plain "
          f"{float((got - want).abs().max()):.3e}, vs float64 "
          f"{float((got.double() - exact).abs().max()):.3e}")
    assert _excess(got, exact) <= 1.0
    if _excess(want, exact) <= 1.0:
        torch.testing.assert_close(got, want, rtol=DPI_RTOL, atol=DPI_ATOL)
    else:
        assert _excess(got, exact) < _excess(want, exact)
    # the fused kernel scores the same bits as dpi_mlp
    rk = ops.expand_key(np.arange(16, dtype=np.uint8))
    ct = ops.aes_ecb(pay.reshape(-1, 16), rk).reshape(pay.shape)
    plain, fused = fused_decrypt_dpi(ct, rk, params)
    assert torch.equal(plain, pay)
    assert torch.equal(fused, got.amax(dim=1))


@pytest.mark.cuda
def test_cuda_launch_counters_count_kernel_launches_only(cuda):
    pay = torch.zeros((4, 64), dtype=torch.uint8, device=cuda)
    plen = torch.full((4,), 64, dtype=torch.int32, device=cuda)
    ops.reset_launches()
    ops.crc32(pay, plen)
    ops.crc32(pay, plen, impl="ref")
    ops.aes_ecb(pay.reshape(-1, 16), ops.expand_key(np.zeros(16, np.uint8)))
    assert ops.launches() == {"aes_ecb": 1, "crc32": 1, "dpi_mlp": 0,
                              "preproc": 0, "reduce_fold": 0,
                              "fused_decrypt_dpi": 0, "fused_epoch": 0}


def _preproc_inputs(rng, m, rec_w=39):
    recs = rng.integers(-2**31, 2**31, (m, rec_w), dtype=np.int64)
    recs[:, :13] = rng.integers(-100, 100_000, (m, 13))
    recs[0, 13:16] = (-2**31, 2**31 - 1, -1)
    return recs.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,modulus", [(1, 7), (52, 100_000), (4099, 1000),
                                       (212_992, 100_000), (33, -9)])
def test_cuda_preproc_matches_plain(cuda, m, modulus):
    recs = _t(_preproc_inputs(np.random.default_rng(m), m)).to(cuda)
    got = ops.preproc(recs, 13, modulus)
    want = ops.preproc(recs, 13, modulus, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(got[:, 13:], want[:, 13:])
    ulps = int((got[:, :13].long() - want[:, :13].long()).abs().max())
    print(f"preproc cuda m={m}: dense worst {ulps} ulp")
    assert ulps <= 1


@pytest.mark.cuda
def test_cuda_preproc_reads_a_packet_strided_tile(cuda):
    """The tile decoder's shape: 26 records at the head of each 1024-word
    packet, read in place through the packets' row stride."""
    rng = np.random.default_rng(5)
    pkts = rng.integers(-2**31, 2**31, (3, 1024), dtype=np.int64)
    words = _t(pkts.astype(np.int32)).to(cuda)
    got = ops.preproc(words[:, :26 * 39], 13, 1000, rec_w=39)
    want = ops.preproc(words[:, :26 * 39].contiguous(), 13, 1000, rec_w=39,
                       impl="ref")
    torch.cuda.synchronize()
    assert got.shape == (78, 39)
    assert torch.equal(got[:, 13:], want[:, 13:])
    assert int((got[:, :13].long() - want[:, :13].long()).abs().max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("k,lanes", [(1, 5), (2, 1001), (3, 513), (8, 77),
                                     (5, 1 << 20)])
def test_cuda_reduce_fold_matches_plain(cuda, k, lanes):
    rng = np.random.default_rng(k * lanes)
    xf = rng.standard_normal((k, lanes)).astype(np.float32)
    xf[0, :1] = np.nan
    if lanes >= 5:
        xf[:, 1:5] = [np.inf, -np.inf, -0.0, 1e38]
    xi = rng.integers(-2**31, 2**31, (k, lanes), dtype=np.int64)
    for x in (_t(xf), _t(xi.astype(np.int32))):
        x = x.to(cuda)
        got = ops.reduce_fold(x)
        want = ops.reduce_fold(x, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    payload = _t(xf).to(cuda).view(torch.uint8)             # (k, 4 * lanes)
    assert torch.equal(ops.chunk_reduce(payload),
                       ops.chunk_reduce(payload, impl="ref"))


def _fold_rows(rng, cuda, k, lanes, stride, skew):
    """(k, lanes) float32 and int32 views of one flat buffer on the card,
    rows ``stride`` words apart, the first ``skew`` words in: float32 with
    NaN, +-inf, -0.0 and 3e38 planted, int32 over the full range (sums
    wrap)."""
    n = skew + (k - 1) * stride + lanes
    xf = rng.standard_normal(n).astype(np.float32)
    xf[rng.integers(0, n, min(n, 16))] = rng.choice(
        np.array([np.nan, np.inf, -np.inf, -0.0, 3e38], np.float32),
        min(n, 16))
    xi = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return [_t(a).to(cuda).as_strided((k, lanes), (stride, 1), skew)
            for a in (xf, xi)]


# K up to 9 (8 rows in flight, then a batch of 1), odd lanes, row strides
# that are and are not multiples of 4 words, and a base 4 or 8 bytes past
# a 16-byte boundary: the ring's (2, 124,881) read in place from its
# (2, 499,524)-byte payload, the offload's packets of 1,024 and 977 words
@pytest.mark.cuda
@pytest.mark.parametrize("skew", [0, 1, 2])
@pytest.mark.parametrize("k,lanes,stride", [
    (2, 124_881, 124_881), (2, 124_881, 124_884), (3, 1024, 1024),
    (4, 977, 977), (4, 977, 980), (1, 3, 3), (9, 1024, 1024),
    (9, 977, 1001), (8, 4099, 4100), (7, 1, 2), (5, 130, 131)])
def test_cuda_reduce_fold_at_misaligned_strides(cuda, k, lanes, stride, skew):
    rng = np.random.default_rng(k * lanes + stride + skew)
    for x in _fold_rows(rng, cuda, k, lanes, stride, skew):
        got = ops.reduce_fold(x)
        want = ops.reduce_fold(x, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            (k, lanes, stride, skew, x.dtype)


@pytest.mark.cuda
def test_cuda_chunk_reduce_reads_the_ring_payload_in_place(cuda):
    """The ring's fold: (2, 499,524) uint8 payloads, row 1 4 bytes past a
    16-byte boundary, folded in place as float32 and as int32."""
    rng = np.random.default_rng(499_524)
    pay = _t(rng.integers(0, 256, (2, 499_524), dtype=np.uint8)).to(cuda)
    for dtype in ("float32", "int32"):
        got = ops.chunk_reduce(pay, dtype=dtype)
        want = ops.chunk_reduce(pay, dtype=dtype, impl="ref")
        torch.cuda.synchronize()
        assert torch.equal(got, want), dtype


PREPROC_MODULI = [1, -1, 2, -2, 3, -3, 7, -9, 1000, 100_000, -100_000,
                  2**30, 2**31 - 1, -(2**31 - 1), -2**31 + 1, -2**31]


def _check_preproc(got, want, n_dense):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got[:, n_dense:], want[:, n_dense:])
    if n_dense:
        ulps = int((got[:, :n_dense].long() - want[:, :n_dense].long())
                   .abs().max())
        assert ulps <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("modulus", PREPROC_MODULI)
def test_cuda_preproc_every_modulus_edge(cuda, modulus):
    """Full-range sparse words, INT32_MIN and INT32_MAX among them, by
    every modulus edge: bit-exact (the kernel's multiply-high floor-mod
    against torch.remainder); a batch and a strided tile."""
    rng = np.random.default_rng(abs(modulus) % 1_000_003)
    recs = _preproc_inputs(rng, 4099)
    m = abs(modulus)
    recs[1, 13:] = np.clip([-2**31, 2**31 - 1, -2**31 + 1, 2**31 - 2, 0, -1,
                            1, m - 1, m, m + 1, -m - 1, -m, -m + 1, 2 * m,
                            -2 * m, 2 * m - 1, 1 - 2 * m, -2**31 + m,
                            2**31 - m, 3, 4, 5, 6, 7, 8, 9],
                           -2**31, 2**31 - 1)
    recs = _t(recs).to(cuda)
    _check_preproc(ops.preproc(recs, 13, modulus),
                   ops.preproc(recs, 13, modulus, impl="ref"), 13)
    pkts = _t(rng.integers(-2**31, 2**31, (2, 1024), dtype=np.int64)
              .astype(np.int32)).to(cuda)
    tile = pkts[:, :26 * 39]
    _check_preproc(ops.preproc(tile, 13, modulus, rec_w=39),
                   ops.preproc(tile, 13, modulus, rec_w=39, impl="ref"), 13)


# at most 65,536 words (one word a thread): the tile (2 packet rows of
# 1,014 words, 1,024 apart), one packet, an odd record count a packet
# (975 words); above it: 65 packets (8-byte accesses), 130 packets of 975
# words (4-byte), batches whose base is 4, 8 or 12 bytes past a 16-byte
# boundary, 70,000 rows (past blockIdx.y's 65,535); records of 1, 8 and
# 600 words (wider than a block: columns found per vector)
@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,stride,skew,rec_w,n_dense", [
    (2, 1014, 1024, 0, 39, 13), (1, 1014, 1024, 0, 39, 13),
    (7, 1014, 1024, 0, 39, 13), (3, 975, 1024, 0, 39, 13),
    (65, 1014, 1024, 0, 39, 13), (130, 975, 1024, 0, 39, 13),
    (4099, 39, 39, 1, 39, 13), (4099, 39, 39, 2, 39, 13),
    (4099, 39, 39, 3, 39, 13), (70_000, 2, 3, 0, 1, 1),
    (97, 8, 8, 0, 8, 3), (300, 1, 1, 0, 1, 0), (3, 1200, 1201, 0, 600, 200),
    (120, 1200, 1200, 0, 600, 200)])
def test_cuda_preproc_vector_widths_and_strides(cuda, rows, cols, stride,
                                                skew, rec_w, n_dense):
    rng = np.random.default_rng(rows * cols + skew)
    flat = rng.integers(-2**31, 2**31, skew + rows * stride + 4,
                        dtype=np.int64)
    flat[::3] = rng.integers(-100, 1_000_000, flat[::3].size)
    words = _t(flat.astype(np.int32)).to(cuda).as_strided(
        (rows, cols), (stride, 1), skew)
    _check_preproc(ops.preproc(words, n_dense, 100_000, rec_w=rec_w),
                   ops.preproc(words, n_dense, 100_000, rec_w=rec_w,
                               impl="ref"), n_dense)


@pytest.mark.cuda
def test_cuda_launch_counters_of_preproc_and_reduce(cuda):
    recs = torch.zeros((4, 39), dtype=torch.int32, device=cuda)
    pay = torch.zeros((3, 64), dtype=torch.uint8, device=cuda)
    ops.reset_launches()
    ops.preproc(recs, 13, 1000)
    ops.preproc(recs, 13, 1000, impl="ref")
    ops.preproc_tile(recs, 13, 1000)
    ops.chunk_reduce(pay)
    ops.chunk_reduce(pay, dtype="int32")
    ops.chunk_reduce(pay, impl="ref")
    assert ops.launches() == {"aes_ecb": 0, "crc32": 0, "dpi_mlp": 0,
                              "preproc": 2, "reduce_fold": 2,
                              "fused_decrypt_dpi": 0, "fused_epoch": 0}


def _fused_inputs(cuda, n, mtu, seed):
    rng = np.random.default_rng(seed)
    pay = _t(rng.integers(0, 256, (n, mtu), dtype=np.uint8)).to(cuda)
    rk = _t(ops.expand_key(rng.integers(0, 256, 16, dtype=np.uint8))).to(cuda)
    return pay, rk, dpi_params_from_numpy(load_dpi_params_seed0(), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("n,mtu", [(1, 64), (17, 256), (33, 1024),
                                   (131, 4096), (5, 8192)])
def test_cuda_fused_chain_matches_plain(cuda, n, mtu):
    """Ragged packet counts (not multiples of 16), MTUs below, at and
    above the kernel's 4 KiB chunk."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pay, rk, params = _fused_inputs(cuda, n, mtu, n + mtu)
    plain, scores = fused_decrypt_dpi(pay, rk, params)
    wplain, wscores = fused_decrypt_dpi(pay, rk, params, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(plain, wplain)
    print(f"fused cuda n={n} mtu={mtu}: scores worst abs error "
          f"{float((scores - wscores).abs().max()):.3e}")
    torch.testing.assert_close(scores, wscores, rtol=DPI_RTOL, atol=DPI_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,mtu", [(1, 64), (17, 256), (33, 1024),
                                   (131, 4096), (5, 8192), (300, 4096)])
def test_cuda_fused_scores_are_dpi_mlp_bits(cuda, n, mtu):
    """Per packet the fused kernel's score is dpi_mlp's max over the
    plaintext's beats, bit for bit: one device MLP for both kernels,
    whether the launch pairs its warps (small) or not (300 packets)."""
    pay, rk, params = _fused_inputs(cuda, n, mtu, 3 * n + mtu)
    plain, scores = fused_decrypt_dpi(pay, rk, params)
    assert torch.equal(scores, ops.dpi_scores(plain, params).amax(dim=1))


@pytest.mark.cuda
def test_cuda_fused_two_packet_tiles_are_the_one_shot_rows(cuda):
    """The secure ingest's launch: 2-packet tiles (paired warps) against
    one launch over all 131 packets (one warp a tile), bit for bit."""
    pay, rk, params = _fused_inputs(cuda, 131, 4096, 11)
    plain, scores = fused_decrypt_dpi(pay, rk, params)
    for lo in range(0, 131, 2):
        hi = min(lo + 2, 131)
        p_t, s_t = fused_decrypt_dpi_tile(pay[lo:hi], rk, params, tile_pkts=2)
        assert torch.equal(p_t, plain[lo:hi])
        assert torch.equal(s_t, scores[lo:hi]), f"tile [{lo}, {hi})"


@pytest.mark.cuda
def test_cuda_fused_chain_roundtrip_and_tiles(cuda):
    """AES-encrypt on the card, fused-decrypt: the bytes come back; a
    full tile and a short final tile give the one-shot rows."""
    pay, rk, params = _fused_inputs(cuda, 13, 4096, 7)
    ct = ops.aes_ecb(pay.reshape(-1, 16), rk).reshape(13, 4096)
    plain, scores = fused_decrypt_dpi(ct, rk, params)
    torch.cuda.synchronize()
    assert torch.equal(plain, pay)
    for lo, hi in ((0, 8), (8, 13)):
        p_t, s_t = fused_decrypt_dpi_tile(ct[lo:hi], rk, params, tile_pkts=8)
        assert torch.equal(p_t, plain[lo:hi])
        assert torch.equal(s_t, scores[lo:hi])
    with pytest.raises(ValueError, match="tile carries"):
        fused_decrypt_dpi_tile(ct, rk, params, tile_pkts=8)


@pytest.mark.cuda
def test_cuda_fused_chain_is_fp32_not_tf32(cuda):
    """The kernels' MLP is exact int8, exact bf16 products summed in fp32
    and fp32 FMA, whatever PyTorch's TF32 switch says: with TF32 allowed
    for matmuls, the fused and the dpi_mlp scores still sit within 1e-5 of
    a float64 evaluation of the same MLP (TF32 keeps about three decimal
    digits)."""
    pay, rk, params = _fused_inputs(cuda, 64, 4096, 9)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        plain, scores = fused_decrypt_dpi(pay, rk, params)
        beats = ops.dpi_scores(plain, params)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    y = _float64_scores(plain, params)
    worst = float((scores.double() - y.amax(dim=1)).abs().max())
    worst_beat = float((beats.double() - y).abs().max())
    print(f"fused cuda vs float64: worst abs error {worst:.3e}; dpi_mlp "
          f"{worst_beat:.3e}")
    assert worst <= DPI_ATOL
    assert _excess(beats, y) <= 1.0


@pytest.mark.cuda
def test_cuda_fused_chain_counts_kernel_launches_only(cuda):
    pay, rk, params = _fused_inputs(cuda, 3, 256, 1)
    ops.reset_launches()
    fused_decrypt_dpi(pay, rk, params)
    fused_decrypt_dpi(pay, rk, params, impl="ref")
    fused_decrypt_dpi_tile(pay[:1], rk, params, tile_pkts=2)
    assert ops.launches()["fused_decrypt_dpi"] == 2
    assert sum(ops.launches().values()) == 2


# packets a launch: the 2-packet tile (paired warps), 131, the main path's
# 8192; at MTU 4096 (4 tiles a packet) on an H100 (132 SMs x 16 warps):
# 264 tiles (one pair a tile over 132 blocks), 268, 1056 (the last paired
# launch, 8 pairs a block) and 1060 (the first unpaired one)
@pytest.mark.cuda
@pytest.mark.parametrize("mtu", [64, 4096])
@pytest.mark.parametrize("n", [2, 66, 67, 131, 264, 265, 8192])
def test_cuda_fused_plaintext_and_scores_bit_exact(cuda, n, mtu):
    """The plaintext is the plain decrypt's, bit for bit, and the scores
    are dpi_mlp's max over it, at launch sizes around the grid's edges."""
    pay, rk, params = _fused_inputs(cuda, n, mtu, 5 * n + mtu)
    plain, scores = fused_decrypt_dpi(pay, rk, params)
    want = ops.aes_ecb(pay.reshape(-1, 16), rk, decrypt=True,
                       impl="ref").reshape(n, mtu)
    torch.cuda.synchronize()
    assert torch.equal(plain, want)
    assert torch.equal(scores, ops.dpi_scores(plain, params).amax(dim=1))


# ---------------------------------------------------------------------------
# the fused epoch kernel
# ---------------------------------------------------------------------------

PORT = "repro_torch.core"


def _kernel_and_plain(cuda, world):
    """One epoch of ``world``'s blob on the card and in the plain
    version; both output blobs as numpy."""
    blob = _t(world.vec0).to(cuda)
    fe.fused_epoch(blob, world.skey)
    torch.cuda.synchronize()
    ref = _t(world.vec0)
    fe.epoch_ref(ref, world.skey)
    return blob.cpu().numpy(), ref.numpy()


def _assert_same_blob(world, got, want):
    lay = world.layout
    bad = [n for n in lay.index
           if not np.array_equal(lay.get(got, n), lay.get(want, n))]
    assert not bad, f"fields differ: {bad}"


@pytest.mark.cuda
@pytest.mark.parametrize("max_ticks", [100_000, 1])
@pytest.mark.parametrize("suite", sorted(W.FIXED))
def test_cuda_fused_epoch_matches_plain(cuda, suite, max_ticks):
    world = tfused.try_pack(W.build(PORT, suite, **W.FIXED[suite]),
                            max_ticks, 8)
    got, want = _kernel_and_plain(cuda, world)
    _assert_same_blob(world, got, want)
    steps = world.layout.get(got, "steps")
    assert steps == 1 if max_ticks == 1 else steps > 1


@pytest.mark.cuda
@pytest.mark.parametrize("suite", sorted(W.SUITES))
def test_cuda_fused_epoch_property_worlds(cuda, suite):
    """Random worlds of each property suite's shape (loss, ECN, spray,
    both RX modes, packed mid-flight), kernel against plain."""
    rng = np.random.default_rng(len(suite))
    for _ in range(6):
        kw = {"seed": int(rng.integers(1, 2 ** 31)),
              "presteps": int(rng.integers(0, 24))}
        if suite.startswith("star"):
            kw["nbytes"] = int(rng.integers(200, 3200))
            if suite == "star_ecn":
                kw["kmax"] = int(rng.choice([6, 8, 12]))
            else:
                kw["loss"] = float(rng.choice([0.02, 0.08, 0.15]))
        else:
            kw.update(loss=float(rng.choice([0.02, 0.08])),
                      reorder=float(rng.choice([0.1, 0.25, 0.3])),
                      jitter=int(rng.integers(1, 4)))
        world = tfused.try_pack(W.build(PORT, suite, **kw), 100_000, 8)
        got, want = _kernel_and_plain(cuda, world)
        _assert_same_blob(world, got, want)


@pytest.mark.cuda
def test_cuda_fused_epoch_watermark_exit(cuda):
    nodes = W.build_star(PORT, 11, nbytes=3000, bw=2)
    wms = {(0, next(iter(nodes[0]._peer))): 512}
    world = tfused.try_pack(nodes, 100_000, 8, wms)
    got, want = _kernel_and_plain(cuda, world)
    _assert_same_blob(world, got, want)
    assert world.layout.get(got, "wm_hit") == 1
    assert world.layout.get(got, "steps") > 1


@pytest.mark.cuda
def test_cuda_fused_epoch_full_wire_aborts(cuda):
    """A full wire: the kernel sets ``abort`` as the plain version does
    (a blob whose every wire slot is taken), and on a world that
    overflows its wire, on the card, ``run_fused_epoch`` returns None
    and leaves the world as it was."""
    world = tfused.try_pack(W.build(PORT, "p2p_gbn_spray",
                                    **W.FIXED["p2p_gbn_spray"]), 100_000, 8)
    c = world.layout.views(world.vec0)
    c["w_arr"][c["w_valid"] == 0] = c["now"][0] + 10 ** 6
    c["w_valid"][:] = 1
    c["p_dl"][tuple(np.argwhere(c["p_held"] > 0)[0])] = 0
    got, want = _kernel_and_plain(cuda, world)
    _assert_same_blob(world, got, want)
    assert world.layout.get(got, "abort") == 1
    nodes = W.overflow_world(PORT, device=cuda)
    before = W.snap(nodes)
    ops.reset_launches()
    assert tfused.run_fused_epoch(nodes) is None
    assert ops.launches()["fused_epoch"] == 1
    assert not W.diff(before, W.snap(nodes))


@pytest.mark.cuda
def test_cuda_run_network_fused_matches_tick(cuda):
    """Nodes on the card, fused epochs; nodes on the CPU, per-tick
    steps: the same ticks and the same world, and one kernel launch an
    epoch."""
    on_card = W.build_star(PORT, 17, loss=0.08, nbytes=2800, device=cuda)
    on_cpu = W.build_star(PORT, 17, loss=0.08, nbytes=2800)
    ops.reset_launches()
    tfused.STATS.reset()
    t = trdma.run_network(on_card, epoch_mode="fused")
    assert t == trdma.run_network(on_cpu, epoch_mode="tick")
    assert ops.launches()["fused_epoch"] == tfused.STATS.epochs >= 1
    d = W.diff(W.snap(on_cpu), W.snap(on_card))
    assert not d, "\n".join(d[:40])


@pytest.mark.cuda
def test_cuda_fused_epoch_wrapper_checks(cuda):
    world = tfused.try_pack(W.build(PORT, "star_ecn", **W.FIXED["star_ecn"]),
                            10, 8)
    blob = _t(world.vec0).to(cuda)
    ops.reset_launches()
    with pytest.raises(ValueError, match="int32"):
        fe.fused_epoch_cuda(blob.long(), world.skey)
    with pytest.raises(ValueError, match="layout"):
        fe.fused_epoch_cuda(blob[:-1].clone(), world.skey)
    with pytest.raises(ValueError, match="CUDA"):
        fe.fused_epoch_cuda(blob.cpu(), world.skey)
    with pytest.raises(ValueError, match="contiguous"):
        fe.fused_epoch_cuda(torch.stack([blob, blob], 1)[:, 0], world.skey)
    with pytest.raises(ValueError, match="CPU blob"):
        fe.epoch_ref(blob, world.skey)
    assert ops.launches()["fused_epoch"] == 0
    fe.fused_epoch(blob, world.skey)
    assert ops.launches()["fused_epoch"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("where", fe.RESIDENCIES)
@pytest.mark.parametrize("suite", sorted(W.FIXED))
def test_cuda_fused_epoch_each_residency(cuda, suite, where):
    """Every suite's shape key through the shared-memory instantiation
    and through the device-memory one: both bit-equal to ``epoch_ref``."""
    world = tfused.try_pack(W.build(PORT, suite, **W.FIXED[suite]),
                            100_000, 8)
    blob = _t(world.vec0).to(cuda)
    ops.reset_launches()
    fe.launch_epoch(blob, world.skey, where)
    torch.cuda.synchronize()
    assert ops.launches()["fused_epoch"] == 1
    assert fe.fused_epoch_cuda.last_residency == where
    ref = _t(world.vec0)
    fe.epoch_ref(ref, world.skey)
    _assert_same_blob(world, blob.cpu().numpy(), ref.numpy())
    assert world.layout.get(ref.numpy(), "steps") > 1


@pytest.mark.cuda
def test_cuda_fused_epoch_wide_world_in_device_memory(cuda):
    """A world whose blob and scratch exceed a block's shared memory
    (40 flows x 128 plan rows, a 297 KB blob), its whole epoch on the
    card: the wrapper runs it in device memory, bit-equal to
    ``epoch_ref``; the shared-memory instantiation refuses it."""
    world = tfused.try_pack(W.wide_world(PORT), 100_000, 8)
    blob = _t(world.vec0).to(cuda)
    assert fe.residency(world.skey, fe.smem_limit(blob.device)) == "global"
    got, want = _kernel_and_plain(cuda, world)
    assert fe.fused_epoch_cuda.last_residency == "global"
    _assert_same_blob(world, got, want)
    assert world.layout.get(got, "steps") > 1000
    with pytest.raises(ValueError, match="shared memory"):
        fe.launch_epoch(blob, world.skey, "shared")


@pytest.mark.cuda
def test_cuda_fused_epoch_picks_residency_by_size(cuda):
    """The wrapper reads the card's opt-in shared memory and launches
    the shared-memory instantiation exactly where the blob and scratch
    fit it: every suite's world, not the wide one."""
    worlds = [tfused.try_pack(W.build(PORT, s, **W.FIXED[s]), 1, 8)
              for s in sorted(W.FIXED)]
    worlds.append(tfused.try_pack(W.wide_world(PORT), 1, 8))
    ran = []
    for world in worlds:
        blob = _t(world.vec0).to(cuda)
        limit = fe.smem_limit(blob.device)
        optin = getattr(torch.cuda.get_device_properties(blob.device),
                        "shared_memory_per_block_optin", limit)
        assert limit == optin
        fe.fused_epoch(blob, world.skey)
        torch.cuda.synchronize()
        want = "shared" if 4 * fe.smem_words(world.skey, True) <= limit \
            else "global"
        assert fe.fused_epoch_cuda.last_residency == want
        ran.append(want)
    assert ran == ["shared"] * len(W.FIXED) + ["global"]


@pytest.mark.cuda
def test_cuda_bucketed_fused_ring_is_the_whole_oracle(cuda):
    """4 ranks x 1,000,003 f32 (4 MB a rank) in buckets of 400,000: ring
    chunk 250,001 cut into slices of 100,000, 100,000 and 50,001, each
    exchanged in fused epochs on the card, joined bit-identical to the
    oracle of the whole vector; no refusal, no abort, a kernel launch an
    epoch and the ring's folds on the card."""
    from repro_torch.core.collectives import allreduce_oracle, make_ring_group
    rng = np.random.default_rng(29)
    n = 1_000_003
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    g = make_ring_group(4, 400_000 * 4 + 16, epoch_mode="fused", device=cuda)
    tfused.STATS.reset()
    ops.reset_launches()
    out = g.allreduce_bucketed(xs, 400_000)
    launched = ops.launches()
    want = allreduce_oracle(xs)
    for r, o in enumerate(out):
        assert (o.view(np.uint32) == want.view(np.uint32)).all(), r
    st = tfused.STATS.snapshot()
    assert st["refusals"] == 0 and st["aborts"] == 0
    assert st["epochs"] == 3 * 6
    assert launched["fused_epoch"] == st["epochs"]
    assert launched["reduce_fold"] == 3 * 3 * 4     # 3 buckets x 3 steps


@pytest.mark.cuda
def test_cuda_allreduce_dlrm_step_is_the_oracle_fold(cuda):
    """One step of the example on the card: the example asserts every
    rank's sum bit-identical to allreduce_oracle and the parameters
    bit-identical to the oracle-fold model; the offload's folds ran on
    the card."""
    from repro_torch.examples import allreduce_dlrm
    ops.reset_launches()
    out = allreduce_dlrm.main(steps=1)
    assert ops.launches()["reduce_fold"] > 0
    assert out["absorbed"] > 0 and np.isfinite(out["losses"]).all()
    assert out["flat"].shape == (out["n_grad"],)


# ---------------------------------------------------------------------------
# the LM model stack and its serving path
# ---------------------------------------------------------------------------

LM_CARD_ATOL = 1e-4     # float32, TF32 off: sums in another order


@pytest.fixture
def no_tf32(cuda):
    """float32 products stay float32 on the card (TF32 off) for the
    test, as on the CPU."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _lm_pair(arch, cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    host = Model(cfg, device="cpu").init_params(0)
    card = Model(cfg, device=cuda).init_params(0)
    return cfg, host, card


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-4b", "gemma2-27b", "gemma2-2b",
                                  "granite-3-2b", "xlstm-125m",
                                  "whisper-base", "deepseek-v3-671b",
                                  "deepseek-v2-236b", "qwen2-vl-72b",
                                  "recurrentgemma-9b"])
def test_cuda_lm_forward_and_decode_equal_the_cpu(no_tf32, arch):
    """Every smoke arch at float32 on the card: the same weights as the
    CPU model drawn from the same seed (bit for bit), and the forward
    logits, the prefill's and four decode steps' logits within
    ``LM_CARD_ATOL`` of the CPU's; the worst error printed."""
    from _lm_batches import ENC_LEN, lm_batch, prompt_of
    cfg, host, card = _lm_pair(arch, no_tf32)
    for k, v in host.state_dict().items():
        assert torch.equal(card.state_dict()[k].cpu(), v), k
    batch = lm_batch(cfg, 2, 24, seed=1)
    errs = []
    outs = {}
    for m in (host, card):
        dev = m.device

        def put(b):
            return {k: torch.from_numpy(v.copy()).to(dev)
                    for k, v in b.items()}
        with torch.no_grad():
            logits = [m.forward(put(batch), train=False)[0]]
        cache = m.init_cache(2, 28, enc_len=ENC_LEN if cfg.is_encdec else 0)
        lg, cache = m.prefill(put(prompt_of(batch, 20)), cache)
        logits.append(lg)
        toks = torch.from_numpy(batch["tokens"].copy()).to(dev)
        for t in range(20, 24):
            lg, cache = m.decode_step(cache, toks[:, t:t + 1], t)
            logits.append(lg)
        outs[dev.type] = [x.float().cpu() for x in logits]
    errs = [float((a - b).abs().max())
            for a, b in zip(outs["cuda"], outs["cpu"])]
    print(f"{arch}: card vs CPU, forward / prefill / 4 decode logits max "
          f"abs errs " + ", ".join(f"{e:.2e}" for e in errs))
    assert max(errs) < LM_CARD_ATOL


@pytest.mark.cuda
def test_cuda_moe_is_run_to_run_equal(no_tf32):
    """The MoE on the card: two runs give the same bits (the combine
    sums each token's experts by gathers in one order), and the result
    is within ``LM_CARD_ATOL`` of the CPU's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe, params as P
    cfg = get_smoke_config("deepseek-v3-671b").replace(
        compute_dtype="float32")
    p = P.init(moe.moe_spec(cfg), torch.Generator().manual_seed(0),
               "float32")
    x = torch.randn((4, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    pc = {k: (v.to(no_tf32) if isinstance(v, torch.Tensor)
              else {kk: vv.to(no_tf32) for kk, vv in v.items()})
          for k, v in p.items()}
    a = moe.moe_ffn(cfg, pc, x.to(no_tf32), torch.float32)[0]
    b = moe.moe_ffn(cfg, pc, x.to(no_tf32), torch.float32)[0]
    assert torch.equal(a, b)
    host = moe.moe_ffn(cfg, p, x, torch.float32)[0]
    assert float((a.cpu() - host).abs().max()) < LM_CARD_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "xlstm-125m",
                                  "recurrentgemma-9b"])
def test_cuda_serve_batch_tokens_equal_the_cpu(no_tf32, arch):
    """``serve_batch`` at float32 on the card gives the CPU's greedy
    tokens, from one seed."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve_batch
    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    card = serve_batch(cfg, None, 4, 32, 16, device=no_tf32)[0]
    host = serve_batch(cfg, None, 4, 32, 16, device="cpu")[0]
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(), host)


@pytest.mark.cuda
def test_cuda_dlrm_init_equals_the_cpu(cuda):
    """The DLRM draws its weights on a CPU generator: one seed, the same
    weights on the card and on the host."""
    from repro_torch.configs.dlrm import smoke_config
    from repro_torch.models.dlrm import DLRM
    a = DLRM(smoke_config(), seed=3, device=cuda).state_dict()
    b = DLRM(smoke_config(), seed=3, device="cpu").state_dict()
    for k in b:
        assert torch.equal(a[k].cpu(), b[k]), k


# ---------------------------------------------------------------------------
# LM training
# ---------------------------------------------------------------------------

# one update, card vs CPU, per element in float32 ulps of the larger of
# the value before and after it: AdamW is elementwise (IEEE division and
# square root on both), Adafactor divides by means that the card sums in
# another order
TRAIN_UPDATE_ULPS = {"adamw": 4, "adafactor": 32}


def _ulps(got, want, before):
    scale = np.maximum(np.abs(want), np.abs(before))
    return np.abs(got.astype(np.float64) - want) / np.spacing(
        np.maximum(scale, np.finfo(np.float32).tiny))


def _update_on(dev, arch, grads_np, state_np):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import params as P
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import make_optimizer
    cfg = get_smoke_config(arch)
    m = Model(cfg, device=dev).init_params(0)
    groups = P.leaf_groups(m)
    grads = {k: (list(_t(grads_np[k]).to(dev).unbind(0))
                 if isinstance(v, list) else _t(grads_np[k]).to(dev))
             for k, v in groups.items()}
    state = {"slots": {k: {n: _t(a).to(dev) for n, a in sl.items()}
                       for k, sl in state_np["slots"].items()},
             "count": torch.tensor(state_np["count"], dtype=torch.int32,
                                   device=dev)}
    with torch.no_grad():
        _, new = make_optimizer(cfg.optimizer).update(
            grads, state, groups, torch.tensor(1e-3))
    host = {k: (torch.stack(v) if isinstance(v, list) else v)
            .detach().cpu().numpy() for k, v in groups.items()}
    return host, {k: {n: t.cpu().numpy() for n, t in sl.items()}
                  for k, sl in new["slots"].items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b"])
def test_cuda_optimizer_update_equals_the_cpu(no_tf32, arch):
    """One update of the arch's optimizer (AdamW, Adafactor) from the
    same parameters, numpy-seeded gradients and a nonzero state (count
    3) on the card and on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import params as P
    from repro_torch.models.model import Model, param_spec
    from repro_torch.optim.optimizers import make_optimizer
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(5)
    before = {k: (torch.stack(v) if isinstance(v, list) else v)
              .detach().numpy().copy() for k, v in P.leaf_groups(
                  Model(cfg, device="cpu").init_params(0)).items()}
    grads = {k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
             for k, v in before.items()}
    spec = make_optimizer(cfg.optimizer).state_spec(param_spec(cfg))
    state = {"slots": {k: {n: (rng.random(s.shape) * 1e-4).astype(
        np.float32) for n, s in sl.items()}
        for k, sl in spec["slots"].items()}, "count": 3}
    p_card, s_card = _update_on(no_tf32, arch, grads, state)
    p_host, s_host = _update_on("cpu", arch, grads, state)
    errs = {k: float(_ulps(p_card[k], p_host[k], before[k]).max())
            for k in p_host}
    errs.update({f"{k}.{n}": float(_ulps(
        s_card[k][n], s_host[k][n], state["slots"][k][n]).max())
        for k in s_host for n in s_host[k]})
    worst = max(errs, key=errs.get)
    print(f"{arch} {cfg.optimizer}: card vs CPU, {len(errs)} leaves and "
          f"slots, worst {errs[worst]:.0f} ulps ({worst})")
    assert errs[worst] <= TRAIN_UPDATE_ULPS[cfg.optimizer]


@pytest.mark.cuda
def test_cuda_trainer_crash_and_resume(no_tf32, tmp_path):
    """The smoke Trainer on the card: a crash at step 6 leaves the step-4
    checkpoint, the resume runs steps 4..9, and its losses are an
    uninterrupted run's (the restored state is exact)."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.train.loop import Trainer, lm_batch_iterator
    cfg = get_smoke_config("granite-3-2b").replace(compute_dtype="float32")

    def tc(d):
        return TrainConfig(steps=10, checkpoint_every=4, learning_rate=1e-3,
                           checkpoint_dir=str(tmp_path / d), log_every=100)
    m = Model(cfg, device=no_tf32)
    with pytest.raises(RuntimeError, match="injected failure"):
        Trainer(m, tc("ck")).run(lm_batch_iterator(cfg, 4, 32), crash_at=6)
    res = Trainer(m, tc("ck")).run(lm_batch_iterator(cfg, 4, 32))
    assert res.resumed_from == 4 and res.steps_run == 6
    # the resume restarts the batches at shard 0 while the steps go on
    # from 4 (as the reference does): the same shards uninterrupted
    shards = itertools.chain(lm_batch_iterator(cfg, 4, 32, n=4),
                             lm_batch_iterator(cfg, 4, 32))
    whole = Trainer(Model(cfg, device=no_tf32), tc("whole")).run(shards)
    assert whole.steps_run == 10
    err = max(abs(a - b) for a, b in zip(res.losses, whole.losses[4:]))
    print(f"resumed losses {res.losses}; uninterrupted {whole.losses[4:]};"
          f" max err {err:.2e}")
    assert err < LM_CARD_ATOL


@pytest.mark.cuda
def test_cuda_train_losses_equal_the_cpu(no_tf32, tmp_path):
    """granite-3-2b smoke at float32: 4 steps from the same CPU-generator
    weights on the card and on the CPU; per-step losses within
    ``LM_CARD_ATOL``, and the parameters after the last step within 2.5 x
    lr a step per element of the CPU's."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.train.loop import Trainer, lm_batch_iterator
    cfg = get_smoke_config("granite-3-2b").replace(compute_dtype="float32")
    runs = {}
    for dev in (no_tf32, torch.device("cpu")):
        m = Model(cfg, device=dev)
        tc = TrainConfig(steps=4, checkpoint_every=100, learning_rate=1e-3,
                         warmup_steps=0, log_every=100,
                         checkpoint_dir=str(tmp_path / dev.type))
        res = Trainer(m, tc).run(lm_batch_iterator(cfg, 4, 32))
        runs[dev.type] = (res.losses, {k: v.cpu() for k, v in
                                       m.state_dict().items()})
    (lc, pc), (lh, ph) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(lc, lh))
    elem = max(float((pc[k] - ph[k]).abs().max()) for k in ph) / (4 * 1e-3)
    print(f"card losses {lc}, CPU {lh}: max err {loss_err:.2e}; params "
          f"worst {elem:.3f} x lr a step")
    assert len(lc) == len(lh) == 4
    assert loss_err < LM_CARD_ATOL
    assert elem < 2.5


# ---------------------------------------------------------------------------
# DPI training, and the sharded landing zone on a mesh of one
# ---------------------------------------------------------------------------

DPI_TRAIN_RTOL = 1e-5   # card vs CPU float weights, of each leaf's max |w|


@pytest.mark.cuda
def test_cuda_train_dpi_params_equals_the_cpu(no_tf32):
    """``train_dpi_params``' float loop (200 steps on ``make_dataset(2048,
    seed=0)`` from the same CPU-generator weights) on the card within
    ``DPI_TRAIN_RTOL`` of the CPU's, relative to each leaf's largest
    magnitude; a ternary entry that differs must lie within that
    tolerance of the threshold; the card's ternary weights score
    ``make_dataset(512, seed=2)`` through the DPI kernel above the
    reference's 0.85 bar."""
    from repro_torch.data.dpi_dataset import make_dataset
    from repro_torch.kernels import dpi_mlp
    x, y = make_dataset(2048, seed=0)
    floats = {}
    for name, dev in (("card", no_tf32), ("cpu", torch.device("cpu"))):
        p0 = dpi_mlp.init_dpi_params(0, dev)
        floats[name] = {k: v.cpu().numpy() for k, v in
                        dpi_mlp.train_float_dpi_params(
                            p0, x, y, 200, device=dev).items()}
    card, cpu = floats["card"], floats["cpu"]
    errs = {k: float(np.abs(card[k] - cpu[k]).max() / np.abs(cpu[k]).max())
            for k in cpu}
    tc, th = dpi_mlp.ternarize(card), dpi_mlp.ternarize(cpu)
    flips = []
    for k in ("w1", "w2", "w3"):
        thr = 0.7 * np.abs(cpu[k]).mean()
        bound = DPI_TRAIN_RTOL * float(np.abs(cpu[k]).max())
        flips += [(k, idx, float(abs(abs(cpu[k][idx]) - thr)), bound)
                  for idx in zip(*np.nonzero(tc[k] != th[k]))]
    print(f"card vs CPU float error: {errs}; ternary flips {flips}")
    assert max(errs.values()) < DPI_TRAIN_RTOL
    assert all(d < b for _, _, d, b in flips), flips
    assert all(tc[k].tobytes() == dpi_mlp.train_dpi_params(
        x, y, 200, device=no_tf32)[k].tobytes() for k in tc)
    xt, yt = make_dataset(512, seed=2)
    before = ops.launches()["dpi_mlp"]
    scores = ops.dpi_scores(_t(xt.reshape(len(xt), 64)).to(no_tf32),
                            dpi_params_from_numpy(tc, no_tf32))[:, 0]
    assert ops.launches()["dpi_mlp"] == before + 1
    acc = float(((scores.cpu().numpy() > 0) == (yt > 0.5)).mean())
    print(f"card-trained ternary DPI accuracy {acc:.4f}")
    assert acc > 0.85


_LANDING = r"""
import sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.core.ingest import (BalboaIngest, IngestConfig,
                                     make_dlrm_tile_decoder)
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel.sharding import NamedSharding, PartitionSpec
mesh = make_host_mesh()
assert dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
rows = NamedSharding(mesh, PartitionSpec("data", None))
n_pkts = 20
def fetch(shardings):
    ing = BalboaIngest(
        IngestConfig(batch_bytes=n_pkts * 4096, n_storage_nodes=4,
                     qps_per_node=2, tile_pkts=2, link_bw_pkts_per_tick=1),
        None, lambda i: syn.encode_dlrm_packets(
            syn.dlrm_shard(i, 26 * n_pkts, 13, 26)), shardings=shardings,
        tile_to_batch=make_dlrm_tile_decoder(13, 26, 100_000))
    return ing, ing.fetch_shard_streaming(0)
_, (whole, wrep) = fetch(None)
ops.reset_launches()
ing, (got, rep) = fetch({"dense": rows, "sparse": rows})
assert ops.launches()["preproc"] > 0
assert rep.events == wrep.events
for k in ("dense", "sparse"):
    assert isinstance(got[k], DTensor) and got[k].to_local().is_cuda
    assert torch.equal(got[k].full_tensor().view(torch.int32),
                       whole[k].view(torch.int32)), k
assert ing.tiles_decoded == rep.tiles and ing.tiles_skipped == 0
dist.destroy_process_group()
print("LANDING_OK", ing.tiles_decoded, rep.tiles)
"""


@pytest.mark.cuda
def test_cuda_sharded_landing_zone_on_a_mesh_of_one(cuda):
    """A 20-packet shard streamed (preprocessing kernel) into a zone
    sharded ("data", None) on an NCCL mesh of one equals the unsharded
    zone bit for bit.  The world of one lives in a subprocess."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", _LANDING], env=env,
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LANDING_OK" in out.stdout, out.stdout
