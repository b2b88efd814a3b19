"""The port's service chain against the JAX reference, on the CPU.

Each service and the composed ``ServiceChain`` get the same payloads
(numpy seeds) in both packages; payloads and flag words must be
bit-identical, including the reference's quirk that ``CrcService``
returns the raw CRC32 wrapped to int32 rather than a mismatch flag.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import services as jsvc
from repro.data.dpi_dataset import payload_with_embedded_malware
from repro_torch.core import services as svc
from repro_torch.data import load_dpi_params_seed0

torch.set_num_threads(1)

KEY = np.arange(16, dtype=np.uint8)


@pytest.fixture(scope="module")
def params():
    return load_dpi_params_seed0()


def _traffic(seed, n=6, mtu=4096):
    """Benign, partly and fully malicious payloads with ragged lengths
    (a zero length and a sub-beat length included)."""
    rng = np.random.default_rng(seed)
    fracs = [0.0, 0.2, 1.0, 0.0, 0.5, 1.0, 0.2, 0.0][:n]
    pay = np.stack([payload_with_embedded_malware(mtu, f, rng)
                    for f in fracs])
    plen = rng.integers(0, mtu + 1, n).astype(np.int32)
    plen[:3] = (mtu, 0, 40)[:min(3, n)]
    return pay, plen


def _both(jfn, tfn, pay, plen):
    j = jfn(jnp.asarray(pay), jnp.asarray(plen))
    t = tfn(torch.from_numpy(pay.copy()), torch.from_numpy(plen.copy()))
    return j, t


@pytest.mark.parametrize("decrypt", [False, True])
def test_aes_service_matches_reference(decrypt):
    pay, plen = _traffic(1)
    j, t = _both(jsvc.AesService(key=KEY, decrypt=decrypt),
                 svc.AesService(key=KEY, decrypt=decrypt, device="cpu"),
                 pay, plen)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert t.dtype == torch.uint8 and t.shape == pay.shape


def test_aes_service_roundtrip():
    pay, plen = _traffic(2)
    enc = svc.AesService(key=KEY, device="cpu")
    dec = svc.AesService(key=KEY, decrypt=True, device="cpu")
    ct = enc(torch.from_numpy(pay), torch.from_numpy(plen))
    assert not torch.equal(ct, torch.from_numpy(pay))
    np.testing.assert_array_equal(
        dec(ct, torch.from_numpy(plen)).numpy(), pay)


@pytest.mark.parametrize("seed", [3, 4])
def test_dpi_service_matches_reference(params, seed):
    pay, plen = _traffic(seed, n=8)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    j, t = _both(jsvc.DpiService(params=jparams),
                 svc.DpiService(params=params, device="cpu"), pay, plen)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert t.dtype == torch.int32
    assert t.numpy()[1] == 0                       # plen 0: no beat counts


def test_dpi_service_flags_malware(params):
    rng = np.random.default_rng(2)
    dpi = svc.DpiService(params=params, device="cpu")
    mal = np.stack([payload_with_embedded_malware(4096, 1.0, rng)
                    for _ in range(8)])
    ben = np.stack([payload_with_embedded_malware(4096, 0.0, rng)
                    for _ in range(8)])
    plen = torch.full((8,), 4096, dtype=torch.int32)
    assert dpi(torch.from_numpy(mal), plen).float().mean() > 0.9
    assert dpi(torch.from_numpy(ben), plen).float().mean() < 0.2


def test_crc_service_returns_wrapped_raw_crc():
    """Bit-exact with the reference, which casts the uint32 CRC to int32:
    CRCs at or above 2**31 come out negative."""
    pay, plen = _traffic(5, n=8, mtu=256)
    j, t = _both(jsvc.CrcService(use_pallas=False), svc.CrcService(
        device="cpu"), pay, plen)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert t.dtype == torch.int32
    assert (t.numpy() < 0).any() and (t.numpy() > 0).any()
    np.testing.assert_array_equal(
        svc.as_int32(torch.tensor([0, 2**31 - 1, 2**31, 2**32 - 1])).numpy(),
        np.array([0, 2**31 - 1, 2**31, 2**32 - 1], np.uint32).view(np.int32))


def test_service_chain_matches_reference(params):
    """Pre-transform CRC tap, on-path decrypt, post-transform DPI tap, and
    a second CRC tap whose raw value is shifted past the sign bit."""
    pay, plen = _traffic(6, n=6)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jchain = jsvc.ServiceChain(
        parallel=[jsvc.CrcService(use_pallas=False),
                  jsvc.CrcService(use_pallas=False)],
        on_path=[jsvc.AesService(key=KEY, decrypt=True, use_pallas=False)],
        parallel_after=[jsvc.DpiService(params=jparams, use_pallas=False)])
    tchain = svc.ServiceChain(
        parallel=[svc.CrcService(device="cpu"), svc.CrcService(device="cpu")],
        on_path=[svc.AesService(key=KEY, decrypt=True, device="cpu")],
        parallel_after=[svc.DpiService(params=params, device="cpu")])
    jout, jflags = jchain.process(jnp.asarray(pay), jnp.asarray(plen))
    tout, tflags = tchain.process(torch.from_numpy(pay),
                                  torch.from_numpy(plen))
    np.testing.assert_array_equal(np.asarray(jout), tout.numpy())
    np.testing.assert_array_equal(np.asarray(jflags), tflags.numpy())
    assert tflags.dtype == torch.int32
    assert tchain.flag_bits == jchain.flag_bits
    assert tchain.describe() == jchain.describe()


def test_service_chain_flag_bit_layout_and_limits():
    class _Always(svc.ParallelPathService):
        def __init__(self, name):
            self.name = name

        def __call__(self, payload, plen):
            return torch.ones(payload.shape[0], dtype=torch.int32)

    a, b, c = _Always("a"), _Always("b"), _Always("a")
    chain = svc.ServiceChain(parallel=[a, b], parallel_after=[c])
    assert chain.flag_bits == {"a": 0, "b": 1, "a@2": 2}
    _, flags = chain.process(torch.zeros((2, 64), dtype=torch.uint8),
                             torch.full((2,), 64, dtype=torch.int32))
    assert flags.tolist() == [7, 7]
    with pytest.raises(ValueError, match="at most 32"):
        svc.ServiceChain(parallel=[_Always(str(i)) for i in range(33)])


def test_null_services_and_unported_preproc():
    pay = torch.zeros((3, 64), dtype=torch.uint8)
    plen = torch.full((3,), 64, dtype=torch.int32)
    assert svc.OnPathService()(pay, plen) is pay
    assert svc.ParallelPathService()(pay, plen).tolist() == [0, 0, 0]
    with pytest.raises(NotImplementedError, match="ingest slice"):
        svc.PreprocService(device="cpu")


def test_services_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        svc.AesService(key=KEY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        svc.CrcService()
