"""The arithmetic of the port's AES rounds, on the CPU.

``csrc/aes_round.cuh`` (shared by ``aes_ecb.cu`` and ``fused_chain.cu``)
encrypts and decrypts in a scheme of its own: one T-table a direction,
whose rotations by one, two and three bytes stand for the tables of rows
1-3; the last round from the S-box (InvS-box), four bytes put together by
two byte permutes; decryption as FIPS-197's equivalent inverse cipher,
with round keys 1-9 passed through InvMixColumns as a block's prologue
derives them; and the tables replicated across the 32 banks of shared
memory in rows of 64 words (32 copies of T[e], then 32 of S[e]), lane l
reading copy l at the byte offset one permute forms.  The CUDA kernels
cannot run here, so this file emulates the scheme in numpy (the staged
words as each warp of a block writes them, every permute with its
selector, each lookup through the lane's offset) and holds it bit for bit
against the reference's Pallas kernel (interpret mode), the reference's
oracle and the port's plain version, and checks that no lookup of a warp
has a bank conflict whatever the data.
tests/test_torch_cuda.py holds the kernels themselves against the plain
version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.aes_ecb import aes_ecb_pallas
from repro_torch.kernels import ref as R
from repro_torch.kernels.aes_ecb import table_image
from repro_torch.kernels.ref import expand_key

torch.set_num_threads(1)

COPIES = 32                      # aes::kCopies, one a bank
U32 = np.uint32
WARPS = 16                       # the warps of a block of either kernel


def _byte_perm(x, y, s: int) -> np.ndarray:
    """CUDA's __byte_perm: byte i of the result is byte ``(s >> 4i) & 7``
    of the eight bytes of y:x."""
    x, y = np.broadcast_arrays(np.asarray(x, U32), np.asarray(y, U32))
    pool = [(x >> U32(8 * i)) & U32(0xFF) for i in range(4)] + \
        [(y >> U32(8 * i)) & U32(0xFF) for i in range(4)]
    out = np.zeros(x.shape, U32)
    for i in range(4):
        sel = (s >> (4 * i)) & 0xF
        assert sel < 8                   # no sign replication
        out |= pool[sel] << U32(8 * i)
    return out


def _stage(image: np.ndarray) -> np.ndarray:
    """The shared-memory words ``stage_tables`` writes with a block of
    WARPS warps: warp w loads chunks w, w + WARPS, ... of 32 image words,
    one a lane, and each 16-byte store writes the word its lane takes by
    shuffle from lane ``src``.  Every word is written exactly once."""
    copies = COPIES
    smem = np.zeros(256 * 2 * copies, U32)
    written = np.zeros(smem.size, np.int64)
    lanes_a_row = copies // 4
    rows_a_store = 32 // lanes_a_row
    for warp in range(WARPS):
        for chunk in range(warp, 16, WARPS):
            v = image[chunk * 32:chunk * 32 + 32]
            part, e0 = int(chunk >= 8), (chunk % 8) * 32
            for k in range(0, 32, rows_a_store):
                for lane in range(32):
                    src = k + lane // lanes_a_row
                    q = ((e0 + src) * 2 * copies + part * copies) // 4 \
                        + lane % lanes_a_row
                    smem[4 * q:4 * q + 4] = v[src]
                    written[4 * q:4 * q + 4] += 1
    assert (written == 1).all()
    return smem


def _rotl(x: np.ndarray, k: int) -> np.ndarray:
    return (x << U32(k)) | (x >> U32(32 - k))


def _xt4(x: np.ndarray) -> np.ndarray:
    return ((x & U32(0x7F7F7F7F)) << U32(1)) ^ \
        (((x >> U32(7)) & U32(0x01010101)) * U32(0x1B))


def _inv_mix(a: np.ndarray) -> np.ndarray:
    """aes_round.cuh's inv_mix on packed column words."""
    a = a ^ _xt4(_xt4(a ^ _rotl(a, 16)))
    a1 = _rotl(a, 24)
    return _xt4(a ^ a1) ^ a1 ^ _rotl(a, 16) ^ _rotl(a, 8)


def _schedule(rk: np.ndarray, decrypt: bool) -> np.ndarray:
    """The 44 words ``stage_round_keys`` writes: the (11, 16) schedule
    read as little-endian words, words 4-39 through InvMixColumns when
    decrypting."""
    w = np.ascontiguousarray(rk, np.uint8).view("<u4").reshape(44).astype(U32)
    if decrypt:
        w[4:40] = _inv_mix(w[4:40])
    return w


class _Lookups:
    """``aes::Tables``: reads the staged words as the lanes do, and records
    the words each warp reads at once, to count bank conflicts."""

    def __init__(self, smem: np.ndarray, n: int):
        self.smem = smem
        self.lane4 = (np.arange(n) % 32 * 4).astype(U32)
        self.worst = 0

    def at(self, w: np.ndarray, r: int) -> np.ndarray:
        return _byte_perm(w, self.lane4, 0x5504 | (r << 4))

    def _read(self, offset: np.ndarray) -> np.ndarray:
        assert (offset % 4 == 0).all()
        addr = (offset // 4).astype(np.int64)
        for w0 in range(0, addr.size, 32):      # one warp's 32 lanes
            words = np.unique(addr[w0:w0 + 32])  # one word: a broadcast
            self.worst = max(self.worst,
                             int(np.bincount(words % 32).max()))
        return self.smem[addr]

    def T(self, w: np.ndarray, r: int) -> np.ndarray:
        return self._read(self.at(w, r))

    def S(self, w: np.ndarray, r: int) -> np.ndarray:
        return self._read(self.at(w, r) + U32(4 * COPIES))


def _scheme(blocks: np.ndarray, rk: np.ndarray, decrypt: bool):
    """``aes::crypt`` on (N, 16) uint8 blocks, one block a lane (block i
    on lane i % 32, as both kernels lay them out).  Returns the blocks and
    the worst bank conflict of any lookup."""
    n = blocks.shape[0]
    tb = _Lookups(_stage(table_image(decrypt)), n)
    k = _schedule(rk, decrypt).reshape(11, 4)
    w = np.ascontiguousarray(blocks).view("<u4").astype(U32) \
        ^ k[10 if decrypt else 0]
    step = -1 if decrypt else 1

    def src(c, r):
        return w[:, (c + step * r) % 4]
    for r in range(1, 10):
        kc = k[10 - r if decrypt else r]
        w = np.stack([tb.T(src(c, 0), 0)
                      ^ _rotl(tb.T(src(c, 1), 1), 8)
                      ^ _rotl(tb.T(src(c, 2), 2), 16)
                      ^ _rotl(tb.T(src(c, 3), 3), 24)
                      ^ kc[c] for c in range(4)], axis=1)
    kc = k[0 if decrypt else 10]
    w = np.stack([(_byte_perm(tb.S(src(c, 0), 0), tb.S(src(c, 1), 1), 0x1140)
                   | _byte_perm(tb.S(src(c, 2), 2), tb.S(src(c, 3), 3),
                                0x4011)) ^ kc[c]
                  for c in range(4)], axis=1)
    return w.astype("<u4").view(np.uint8).reshape(n, 16), tb.worst


@pytest.mark.parametrize("lane", [0, 31])
def test_scheme_fips197_vector(lane):
    """The FIPS-197 vector on the first and the last lane of a warp (each
    reads its own copies), the other lanes random."""
    key = np.arange(16, dtype=np.uint8)
    pt = np.random.default_rng(lane).integers(0, 256, (32, 16), np.uint8)
    pt[lane] = np.frombuffer(
        bytes.fromhex("00112233445566778899aabbccddeeff"), np.uint8)
    rk = expand_key(key)
    ct, _ = _scheme(pt, rk, False)
    assert ct[lane].tobytes().hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
    back, _ = _scheme(ct, rk, True)
    np.testing.assert_array_equal(back, pt)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 31, 33, 257])
def test_scheme_matches_reference_pallas_and_plain(n, seed):
    """Bit for bit against JAX's Pallas kernel (interpret mode), JAX's
    oracle and the port's plain version, both directions; no bank
    conflict."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    rk = expand_key(rng.integers(0, 256, 16, dtype=np.uint8))
    for decrypt in (False, True):
        pallas = np.asarray(aes_ecb_pallas(jnp.asarray(blocks), rk,
                                           decrypt=decrypt, interpret=True))
        oracle = np.asarray((jref.aes_decrypt_ref if decrypt
                             else jref.aes_encrypt_ref)(jnp.asarray(blocks),
                                                        jnp.asarray(rk)))
        plain = (R.aes_decrypt_ref if decrypt else R.aes_encrypt_ref)(
            torch.from_numpy(blocks), rk).numpy()
        np.testing.assert_array_equal(pallas, oracle)
        got, worst = _scheme(blocks, rk, decrypt)
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, plain)
        assert worst == 1, (decrypt, worst)


@pytest.mark.parametrize("decrypt", [False, True])
def test_table_image_is_what_the_kernels_read(decrypt):
    """512 words: the T-table (byte r of word x is m_r * S[x], the
    direction's MixColumns column), then the box, one entry a word in its
    low byte.  Staged by a block, row e holds 32 copies of T[e] then 32 of
    S[e]; the rotations of T are the tables of rows 1-3, the
    circulant matrix's columns 1-3."""
    box = (R.INV_SBOX if decrypt else R.SBOX).astype(np.uint8)
    coef = (14, 9, 13, 11) if decrypt else (2, 1, 1, 3)
    image = table_image(decrypt)
    assert image.dtype == U32 and image.shape == (512,)

    def gmul(x, c):                  # GF(2^8) product, one byte at a time
        out = 0
        for bit in range(8):
            if c >> bit & 1:
                out ^= x
            x = ((x << 1) ^ (0x1B if x & 0x80 else 0)) & 0xFF
        return out
    t_bytes = image[:256].astype("<u4").view(np.uint8).reshape(256, 4)
    for x in range(256):
        assert [int(b) for b in t_bytes[x]] == \
            [gmul(int(box[x]), m) for m in coef], x
    np.testing.assert_array_equal(image[256:], box)
    for r in range(1, 4):
        want = np.zeros(256, U32)
        for i in range(4):
            want |= np.array([gmul(int(box[x]), coef[(i - r) % 4])
                              for x in range(256)], U32) << U32(8 * i)
        np.testing.assert_array_equal(_rotl(image[:256], 8 * r), want)
    rows = _stage(image).reshape(256, 2, COPIES)
    for j in range(COPIES):
        np.testing.assert_array_equal(rows[:, 0, j], image[:256])
        np.testing.assert_array_equal(rows[:, 1, j], box)


def test_prologue_round_keys_are_the_equivalent_inverse_cipher_schedule():
    """Words 4-39 of the decrypt schedule are InvMixColumns of the round
    keys (FIPS-197 5.3.5), held against the plain version's byte-wise
    InvMixColumns; words 0-3 and 40-43 are the keys as they are."""
    rk = expand_key(np.random.default_rng(7).integers(0, 256, 16,
                                                      dtype=np.uint8))
    dk = _schedule(rk, True).astype("<u4").view(np.uint8).reshape(11, 16)
    want = R._inv_mix_columns(torch.from_numpy(rk.astype(np.int64))).numpy()
    np.testing.assert_array_equal(dk[1:10], want[1:10])
    np.testing.assert_array_equal(dk[[0, 10]], rk[[0, 10]])
    np.testing.assert_array_equal(_schedule(rk, False).view(np.uint8)
                                  .reshape(11, 16), rk)
