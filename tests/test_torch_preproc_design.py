"""The word, column and block mapping of the port's preprocessing kernel,
and its floor-mod by a magic number, on the CPU.

``csrc/preproc.cu`` rewrites V words at a time (16-byte accesses on a
contiguous batch, 8- or 4-byte ones where the rows' starts allow no
more, one word a thread in a launch of at most 65,536 words, which its
latency bounds) with blocks of rec_w x G threads (507 for 39-word
records), so a thread's vectors, a block apart, all start in the column
it works out once from its place in the block; a record wider than a
block (rec_w > 512) finds its columns per vector.  Rows that lie back to back are one row; other rows
stride over blockIdx.y.  The sparse words' floor-mod is Granlund and
Montgomery's multiply-high by ``kernels.preproc.floor_mod_magic``'s
numbers on |x|, its sign put back, then moved to the divisor's side.

The kernel cannot run here, so this file emulates the launch and the
kernel in numpy: every word read and written exactly once, each
thread's fixed columns the words' true columns, the tile's 2,028 words
in four blocks of one word a thread; the emulated output against the
reference's oracle (``preproc_ref``) and Pallas kernel (interpret mode);
and the floor-mod against ``torch.remainder`` and ``jnp.remainder`` at
every int32 edge and modulus edge.  tests/test_torch_cuda.py holds the
kernel itself against the plain version on the card at the same edges.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.preproc import preproc_pallas
from repro_torch.kernels.preproc import floor_mod_magic

MAX_THREADS, SMALL_WORDS = 512, 1 << 16         # preproc.cu's constants
U32 = np.uint32
I32_MIN, I32_MAX = -2**31, 2**31 - 1


# --- the floor-mod ------------------------------------------------------

def _floor_mod(x: np.ndarray, m: int) -> np.ndarray:
    """preproc.cu's floor_mod, in uint32/int32 numpy arithmetic."""
    magic, sh1, sh2 = floor_mod_magic(m)
    a = U32(abs(m) & 0xFFFFFFFF)
    x = np.asarray(x, np.int32)
    n = np.where(x < 0, U32(0) - x.view(U32), x.view(U32)).astype(U32)
    t = ((n.astype(np.uint64) * np.uint64(magic)) >> np.uint64(32)).astype(U32)
    q = (t + ((n - t) >> U32(sh1))) >> U32(sh2)
    u = n - q * a                                       # |x| mod |m|
    r = np.where(x < 0, (U32(0) - u).view(np.int32), u.view(np.int32))
    fix = (r != 0) & ((r ^ np.int32(m)) < 0)
    return np.where(fix, r + np.int32(m), r).astype(np.int32)


MODULI = [1, -1, 2, -2, 3, -3, 7, -9, 1000, 100_000, -100_000, 2**30,
          2**31 - 1, -(2**31 - 1), I32_MIN + 1, I32_MIN]


def _edges(m: int) -> np.ndarray:
    a = abs(m)
    near = [I32_MIN, I32_MIN + 1, I32_MIN + 2, -1, 0, 1, I32_MAX - 1, I32_MAX]
    for c in (a, 2 * a, 3 * a, a // 2):
        near += [c - 1, c, c + 1, -c - 1, -c, -c + 1]
    near += [I32_MIN + a - 1, I32_MIN + a, I32_MAX - a, I32_MAX - a + 1]
    v = np.array([x for x in near if I32_MIN <= x <= I32_MAX], np.int64)
    rng = np.random.default_rng(a % 1_000_003)
    return np.concatenate([v, rng.integers(I32_MIN, I32_MAX + 1, 20_000)]
                          ).astype(np.int32)


@pytest.mark.parametrize("m", MODULI)
def test_magic_floor_mod_matches_remainder_at_the_edges(m):
    x = _edges(m)
    got = _floor_mod(x, m)
    np.testing.assert_array_equal(
        got, torch.remainder(torch.from_numpy(x), m).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jnp.remainder(jnp.asarray(x), jnp.int32(m))))


def test_magic_numbers_divide_every_uint32_quotient_boundary():
    """For each |m|, |x| / |m| from the magic number is the true quotient
    at every multiple of |m| and one below it across the uint32 range
    (where a multiply-high divisor would first go wrong), and at 2^32 - 1."""
    for m in [1, 2, 3, 5, 7, 9, 10, 39, 641, 1000, 100_000, 6_700_417,
              2**16 + 1, 2**30 - 1, 2**30 + 1, 2**31 - 1, 2**31]:
        magic, sh1, sh2 = floor_mod_magic(m)
        assert 1 <= magic < 2**32
        k = np.unique(np.linspace(0, (2**32 - 1) // m, 4000).astype(np.uint64))
        n = np.concatenate([k * m, np.maximum(k * m, 1) - 1,
                            [2**32 - 1]]).astype(np.uint64)
        n = n[n < 2**32]
        t = (n * np.uint64(magic)) >> np.uint64(32)
        q = (t + ((n - t) >> np.uint64(sh1))) >> np.uint64(sh2)
        np.testing.assert_array_equal(q, n // np.uint64(m))
    with pytest.raises(ValueError):
        floor_mod_magic(0)


# --- the launch and the kernel's mapping ---------------------------------

def _plan(rows, row_words, stride, rec_w, in_bytes=0, out_bytes=0):
    """preproc_launch and launch<V>: (rows, row_words, V, threads, gx, gy)
    with the input's and output's byte addresses given mod 16 (gx before
    the launch caps it at the resident grid)."""
    small = rows * row_words <= SMALL_WORDS
    if rows == 1 or stride == row_words:
        rows, row_words = 1, rows * row_words

    def fits(v):
        return in_bytes % (4 * v) == 0 and out_bytes % (4 * v) == 0 and \
            (rows == 1 or (row_words % v == 0 and stride % v == 0))
    v = 1 if small else 4 if fits(4) else 2 if fits(2) else 1
    threads = MAX_THREADS // rec_w * rec_w if rec_w <= MAX_THREADS \
        else MAX_THREADS
    nvec = -(-row_words // v)
    gx = -(-nvec // threads)
    return rows, row_words, v, threads, gx, min(rows, 65535)


def _dense_bits(col, rec_w, n_dense, v):
    """preproc.cu's dense_bits, over an array of first columns."""
    bits = np.zeros_like(col)
    col = col.copy()
    for j in range(v):
        bits |= (col < n_dense).astype(col.dtype) << j
        col = np.where(col + 1 == rec_w, 0, col + 1)
    return bits


def _emulate(words, off, rows, row_words, stride, rec_w, n_dense, modulus,
             in_bytes=0, grid_x=None):
    """The kernel over ``rows`` rows of ``row_words`` words at
    ``words[off + r * stride:]``, as launched: the dense output's words, and
    (V, threads, gx, gy).  Asserts each word is read and written once and
    each thread's fixed columns are its words' columns."""
    rows, row_words, v, threads, gx, gy = _plan(rows, row_words, stride,
                                                rec_w, in_bytes)
    gx = gx if grid_x is None else grid_x
    nvec = -(-row_words // v)
    fixed = threads % rec_w == 0
    t = np.arange(threads)
    mine = _dense_bits(v * t % rec_w, rec_w, n_dense, v)
    passes = -(-nvec // (gx * threads)) + 1
    # (block x, pass, thread) -> q
    q = (np.arange(gx)[:, None, None] * threads
         + np.arange(passes)[None, :, None] * gx * threads + t[None, None, :])
    bits = np.broadcast_to(mine, q.shape) if fixed else \
        _dense_bits(v * q % rec_w, rec_w, n_dense, v)
    w = v * q[..., None] + np.arange(v)                 # word in row
    live = (q < nvec)[..., None] & (w < row_words)
    dense = (bits[..., None] >> np.arange(v)) & 1
    assert (dense[live] == (w[live] % rec_w < n_dense)).all(), \
        "a thread's columns are not its words' columns"
    w, dense = w[live], dense[live].astype(bool)
    assert np.unique(w).size == w.size == row_words, \
        "a word of a row read more or less than once"
    # blockIdx.y's row loop: rows blockIdx.y + k * gy, each row once
    seen = (np.arange(gy)[:, None]
            + gy * np.arange(-(-rows // gy))[None, :]).reshape(-1)
    seen = seen[seen < rows]
    assert np.array_equal(np.sort(seen), np.arange(rows))
    x = words[off + seen[:, None] * stride + w[None, :]]
    dense = np.broadcast_to(dense, x.shape)
    y = _floor_mod(x, modulus)
    d = np.asarray(jnp.log1p(jnp.maximum(
        jnp.asarray(x[dense]).astype(jnp.float32), 0.0)))
    y[dense] = d.view(np.int32)
    out = np.empty((rows, row_words), np.int32)
    out[seen[:, None], w[None, :]] = y
    return out.reshape(-1), (v, threads, gx, gy)


def _want(recs, n_dense, modulus, pallas):
    j = jnp.asarray(recs)
    w = np.asarray(jref.preproc_ref(j, n_dense, modulus))
    if pallas:
        np.testing.assert_array_equal(
            np.asarray(preproc_pallas(j, n_dense, modulus)), w)
    return w


def _words(rng, n):
    x = rng.integers(I32_MIN, I32_MAX + 1, n, dtype=np.int64)
    x[::3] = rng.integers(-100, 1_000_000, x[::3].size)
    x[:4] = [I32_MIN, I32_MAX, -1, 0]
    return x.astype(np.int32)


# (records, rec_w, n_dense, modulus, misalignment of the base in bytes)
BATCHES = [(1, 39, 13, 100_000, 0), (52, 39, 13, 100_000, 0),
           (4099, 39, 13, 1000, 0), (20_000, 39, 13, 100_000, 0),
           (33, 39, 13, -9, 0), (77, 39, 13, -1, 0), (97, 8, 3, 100, 0),
           (4099, 39, 13, I32_MIN, 8), (2000, 39, 13, I32_MAX, 4),
           (1681, 39, 13, 7, 4), (300, 1, 0, 7, 0), (300, 1, 1, 7, 0),
           (9, 600, 200, 1000, 0), (120, 600, 200, 1000, 0)]


@pytest.mark.parametrize("m,rec_w,n_dense,modulus,skew", BATCHES)
def test_batch_mapping_matches_the_reference(m, rec_w, n_dense, modulus,
                                             skew):
    """A contiguous (M, rec_w) batch is one row: above 65,536 words
    16-byte vectors on an aligned base (8- or 4-byte ones off it), one
    word a thread below; every word once, each thread's columns fixed
    (found per vector for a record wider than a block), the output the
    reference's."""
    rng = np.random.default_rng(m * 7 + rec_w)
    words = _words(rng, m * rec_w + 4)
    off = skew // 4
    recs = words[off:off + m * rec_w].reshape(m, rec_w)
    got, (v, threads, gx, gy) = _emulate(
        words, off, m, rec_w, rec_w, rec_w, n_dense, modulus, in_bytes=skew)
    small = m * rec_w <= SMALL_WORDS
    assert v == (1 if small else {0: 4, 8: 2, 4: 1}[skew]) and gy == 1
    assert threads == (507 if rec_w == 39 else min(512, 512 // rec_w * rec_w)
                       if rec_w <= 512 else 512)
    np.testing.assert_array_equal(got.reshape(m, rec_w),
                                  _want(recs, n_dense, modulus, m <= 4099))
    # a grid capped below the blocks the words need strides further
    capped, _ = _emulate(words, off, m, rec_w, rec_w, rec_w, n_dense,
                         modulus, in_bytes=skew, grid_x=1)
    np.testing.assert_array_equal(capped, got)


# (packets, words a packet, records a packet): the tile decoder's 2-packet
# tile, the on-path service's batches (65 and 130 packets: past 65,536
# words, 8-byte vectors; 25 records, 975 words: 4-byte), and rows past
# blockIdx.y's 65,535
PACKETS = [(2, 1024, 26), (1, 1024, 26), (7, 1024, 26), (65, 1024, 26),
           (130, 1024, 25), (70_000, 3, 2)]


@pytest.mark.parametrize("pkts,pkt_words,rpp", PACKETS)
def test_packet_rows_mapping_matches_the_reference(pkts, pkt_words, rpp):
    rec_w = 39 if pkt_words == 1024 else 1
    n_dense = 13 if rec_w == 39 else 1
    rng = np.random.default_rng(pkts + rpp)
    words = _words(rng, pkts * pkt_words)
    row_words = rpp * rec_w
    got, (v, threads, gx, gy) = _emulate(
        words, 0, pkts, row_words, pkt_words, rec_w, n_dense, 100_000)
    recs = words.reshape(pkts, pkt_words)[:, :row_words].reshape(-1, rec_w)
    np.testing.assert_array_equal(got.reshape(-1, rec_w),
                                  _want(recs, n_dense, 100_000, pkts < 100))
    if pkts == 2 and rpp == 26:
        # the tile: 4 blocks (2 a packet row) of 507 threads, one word a
        # thread, every thread busy
        assert (v, threads, gx, gy) == (1, 507, 2, 2)
        assert 2 * threads == row_words
    if pkts == 1:
        assert (v, gx, gy) == (1, 2, 1)             # one row of 1,014
    if pkts == 65:
        assert (v, gx, gy) == (2, 1, 65)
    if pkts == 130:
        assert (v, gx, gy) == (1, 2, 130)
    if pkts == 70_000:
        assert v == 1 and gy == 65_535 and gx == 1


def test_main_path_batch_plan():
    """The 8192-packet batch's 212,992 records of 39 words: 16-byte
    vectors, blocks of 507 threads, 4,096 blocks' worth of vectors (the
    launch spreads them over passes of the resident grid)."""
    rows, row_words, v, threads, gx, gy = _plan(212_992, 39, 39, 39)
    assert (rows, row_words, v, threads, gx, gy) == (
        1, 8_306_688, 4, 507, 4096, 1)
    assert 8_306_688 // 4 == 4096 * 507
