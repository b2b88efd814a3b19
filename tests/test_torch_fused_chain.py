"""The port's fused decrypt+DPI chain against the JAX reference, on the
CPU.

Inputs are made from numpy seeds and go through the port's
``fused_decrypt_dpi`` (a CPU tensor takes the plain version), the
reference's ``fused_decrypt_dpi_ref`` and, in some cases, the
reference's Pallas kernel ``fused_decrypt_dpi_pallas`` in interpret mode
(as tests/test_kernels.py runs it; each new shape compiles for seconds,
so the other cases hold the port against the reference's oracle).  The
plaintext must agree bit for bit; the scores within rtol = atol = 1e-5
(float32 sums taken in another order), with the worst error printed.
tests/test_torch_cuda.py holds the hand-written kernel against the plain
version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_chain import (fused_decrypt_dpi_pallas,
                                       fused_decrypt_dpi_ref as jfused_ref)
from repro_torch.data import load_dpi_params_seed0
from repro_torch.kernels import ops
from repro_torch.kernels.dpi_mlp import dpi_params_from_numpy
from repro_torch.kernels.fused_chain import (BLOCK_N, fused_decrypt_dpi,
                                             fused_decrypt_dpi_cuda,
                                             fused_decrypt_dpi_tile)

torch.set_num_threads(1)

DPI_RTOL = DPI_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


@pytest.fixture(scope="module")
def fixture_params():
    p = load_dpi_params_seed0()
    return dpi_params_from_numpy(p, "cpu"), {k: jnp.asarray(v)
                                             for k, v in p.items()}


def _check(got, want, what):
    plain, scores = got
    wplain, wscores = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(plain.numpy(), wplain, err_msg=what)
    worst = float(np.abs(scores.numpy() - wscores).max())
    print(f"{what}: plaintext bit-exact, scores worst abs error "
          f"{worst:.3e} (rtol=atol={DPI_RTOL})")
    np.testing.assert_allclose(scores.numpy(), wscores, rtol=DPI_RTOL,
                               atol=DPI_ATOL, err_msg=what)


# packet counts not divisible by BLOCK_N (the reference's padded grid)
@pytest.mark.parametrize("n,mtu,seed,impl", [
    (1, 256, 0, "ref"), (7, 1024, 1, "pallas"), (17, 256, 2, "pallas"),
    (23, 1024, 3, "ref"), (33, 256, 4, "ref"), (40, 256, 5, "ref"),
    (3, 4096, 6, "pallas")])
def test_fused_matches_reference(fixture_params, n, mtu, seed, impl):
    assert n % BLOCK_N
    tparams, jparams = fixture_params
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (n, mtu), dtype=np.uint8)
    rk = ops.expand_key(rng.integers(0, 256, 16, dtype=np.uint8))
    got = fused_decrypt_dpi(_t(pay), rk, tparams)
    assert got[0].shape == (n, mtu) and got[0].dtype == torch.uint8
    assert got[1].shape == (n,) and got[1].dtype == torch.float32
    jfn = fused_decrypt_dpi_pallas if impl == "pallas" else jfused_ref
    _check(got, jfn(jnp.asarray(pay), rk, jparams),
           f"n={n} mtu={mtu} vs reference {impl}")
    # the port's plain version asked for by name is the same function
    again = fused_decrypt_dpi(_t(pay), rk, tparams, impl="ref")
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_fused_decrypt_roundtrip(fixture_params):
    """Encrypt with the port's AES, fused-decrypt, recover the bytes."""
    tparams, _ = fixture_params
    rng = np.random.default_rng(3)
    plain = rng.integers(0, 256, (7, 256), dtype=np.uint8)
    rk = ops.expand_key(rng.integers(0, 256, 16, dtype=np.uint8))
    ct = ops.aes_ecb(_t(plain.reshape(-1, 16)), rk).reshape(7, 256)
    got, scores = fused_decrypt_dpi(ct, rk, tparams)
    np.testing.assert_array_equal(got.numpy(), plain)
    want = ops.dpi_scores(_t(plain), tparams).amax(dim=1)
    assert torch.equal(scores, want)


def test_fused_tile_entry_matches_oneshot(fixture_params):
    """A full tile and a short final tile give the one-shot rows; a tile
    larger than ``tile_pkts`` raises, as the reference's does."""
    tparams, _ = fixture_params
    rng = np.random.default_rng(11)
    pay = _t(rng.integers(0, 256, (13, 256), dtype=np.uint8))
    rk = ops.expand_key(rng.integers(0, 256, 16, dtype=np.uint8))
    p_all, s_all = fused_decrypt_dpi(pay, rk, tparams)
    for lo, hi in ((0, 8), (8, 13)):
        p_t, s_t = fused_decrypt_dpi_tile(pay[lo:hi], rk, tparams,
                                          tile_pkts=8)
        assert p_t.shape == (hi - lo, 256) and s_t.shape == (hi - lo,)
        assert torch.equal(p_t, p_all[lo:hi])
        assert torch.equal(s_t, s_all[lo:hi])
    with pytest.raises(ValueError, match="tile carries"):
        fused_decrypt_dpi_tile(pay, rk, tparams, tile_pkts=8)


def test_fused_score_is_the_max_over_every_beat(fixture_params):
    """The reference takes the max over EVERY beat of the MTU, not over
    the beats a short ``plen`` covers as ``DpiService`` does: a packet
    whose highest-scoring beat lies past its length keeps that score."""
    tparams, jparams = fixture_params
    rng = np.random.default_rng(21)
    # pick the highest- and lowest-scoring of 256 random beats
    cand = rng.integers(0, 256, (256, 64), dtype=np.uint8)
    cs = ops.dpi_scores(_t(cand), tparams)[:, 0].numpy()
    hot, cold = cand[cs.argmax()], cand[cs.argmin()]
    plain = np.tile(cold, (2, 16))                          # (2, 1024)
    plain[0, 15 * 64:] = hot          # past a 256-byte plen
    rk = ops.expand_key(rng.integers(0, 256, 16, dtype=np.uint8))
    ct = ops.aes_ecb(_t(plain.reshape(-1, 16)), rk).reshape(2, 1024)
    got = fused_decrypt_dpi(ct, rk, tparams)
    _check(got, jfused_ref(jnp.asarray(ct.numpy()), rk, jparams),
           "max over every beat")
    beats = ops.dpi_scores(_t(plain), tparams)
    masked = float(beats[0, :256 // 64].max())     # DpiService's view
    assert float(got[1][0]) == pytest.approx(float(cs.max()), abs=DPI_ATOL)
    assert float(got[1][0]) > masked + 0.1
    assert float(got[1][1]) == pytest.approx(float(cs.min()), abs=DPI_ATOL)


def test_fused_dispatch_and_launch_counter(fixture_params):
    """A CPU tensor takes the plain version and launches nothing; the
    CUDA wrapper refuses a CPU tensor; an unknown impl raises."""
    tparams, _ = fixture_params
    pay = torch.zeros((2, 64), dtype=torch.uint8)
    rk = ops.expand_key(np.zeros(16, np.uint8))
    ops.reset_launches()
    fused_decrypt_dpi(pay, rk, tparams)
    fused_decrypt_dpi_tile(pay[:1], rk, tparams, tile_pkts=2)
    assert ops.launches()["fused_decrypt_dpi"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_decrypt_dpi_cuda(pay, rk, tparams)
    with pytest.raises(ValueError, match="unknown impl"):
        fused_decrypt_dpi(pay, rk, tparams, impl="cuda")
