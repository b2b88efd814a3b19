"""The scheme of the port's CRC32 kernel, on the CPU.

``csrc/crc32.cu`` splits a packet across a team of T lanes (the fewest,
a power of two up to a warp, that hold the row at 128 bytes a lane;
``kernels/crc32.py:team``), 32 / T packets a warp.  Lane l folds the
contiguous chunk [l C, (l + 1) C) up to plen.  A warp copies the chunks'
128-byte pieces, a segment at a time, into its buffer in shared memory,
whole pieces per instruction, 16 or 8 bytes a load, only loads that
start below the piece owner's plen, the 16-byte columns of piece P
swizzled to c ^ (P % 8); each lane reads its own piece back and folds
whole words slice-by-4 through tables
copied 32 times across the banks of shared memory (lane l reads copy l),
the last plen % 4 bytes by the byte recurrence; lane 0 starts from
0xFFFFFFFF, the others from 0.  Lanes l < q = plen // C multiply their
CRC by x^(8 t), t the bytes after their chunk, from the host's table of
powers (``kernels/crc32.py:powers``, laid out [plen % C][q - 1 - l]), by a
carry-less product of operands with three-bit holes reduced by one
slice-by-4 step; an XOR across the team and the final XOR end it.  The
kernel cannot run here, so this file emulates that scheme in numpy, lane
by lane and lookup by lookup, and holds it bit for bit against zlib, the
reference's oracle (``repro.kernels.ref.crc32_ref``), its Pallas kernel
(interpret mode) and the port's plain version, at MTUs 8 to 8192, plen
-1 to MTU + 1, batches around a warp's worth of teams and rows 8 bytes
off a 16-byte boundary.  It also checks the power table and the product
against a bitwise GF(2) product, that no load leaves the row or starts
at or past plen, that a copy instruction reads whole lines, that bytes
past plen and stale bytes of the buffer change nothing, that the staged
copies are the host's tables, and that every lookup of a warp, every
store of a copy and every read of a piece is one wavefront a phase (no
bank conflict) whatever the data.
tests/test_torch_cuda.py holds the kernel itself against the plain
version and zlib on the card at the same edges.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.crc32 import crc32_pallas
from repro_torch.kernels import ref as R
from repro_torch.kernels.crc32 import powers, table_image, team, warp_lookups

torch.set_num_threads(1)

U32, U64 = np.uint32, np.uint64
POLY = 0xEDB88320
WARP, COPIES, SEG, THREADS = 32, 32, 128, 512       # crc32.cu's constants
HALF_BYTES = 256 * 2 * COPIES * 4                   # kHalfBytes
MTUS = (8, 24, 64, 136, 256, 4096, 8192)


def _edges(mtu: int) -> list:
    return [-1, 0, 1, 15, 16, 17, 127, 128, 129, mtu - 1, mtu, mtu + 1]


def _byte_perm(x, y, s: int) -> np.ndarray:
    """CUDA's __byte_perm: byte i of the result is byte ``(s >> 4i) & 7``
    of the eight bytes of y:x."""
    x, y = np.broadcast_arrays(np.asarray(x, U32), np.asarray(y, U32))
    pool = [(x >> U32(8 * i)) & U32(0xFF) for i in range(4)] + \
        [(y >> U32(8 * i)) & U32(0xFF) for i in range(4)]
    out = np.zeros(x.shape, U32)
    for i in range(4):
        out |= pool[(s >> (4 * i)) & 7] << U32(8 * i)
    return out


def _stage(image: np.ndarray) -> np.ndarray:
    """The shared-memory words ``stage`` writes: thread t's j-th 16-byte
    store is store t + j THREADS, four copies of the image word its first
    word maps to.  Every word is written exactly once."""
    smem = np.zeros(2 * HALF_BYTES // 4, U32)
    written = np.zeros(smem.size, np.int64)
    stores = smem.size // 4 // THREADS
    for j in range(stores):
        w = 4 * (np.arange(THREADS) + j * THREADS)
        v = image.reshape(-1)[(2 * (w >> 14) + ((w >> 5) & 1)) * 256
                              + ((w >> 6) & 255)]
        for i in range(4):
            smem[w + i] = v
            np.add.at(written, w + i, 1)
    assert (written == 1).all()
    return smem


SMEM = _stage(table_image())


class Warp:
    """Lookups of a batch of warps ((G, 32) lanes) into the staged
    tables; counts the wavefronts of the worst bank of every lookup."""

    def __init__(self, shape):
        lane = np.broadcast_to(np.arange(WARP, dtype=np.uint32), shape)
        self.lo = U32(4) * lane
        self.hi = U32(4 * COPIES) + U32(4) * lane
        self.worst = 0
        self.lookups = 0                # lanes' lookups that count
        self.instructions = 0           # warp lookup instructions issued
        self.buffer_worst = 0           # the copies' stores, the reads

    def _at(self, off: np.ndarray, active: np.ndarray) -> np.ndarray:
        words = (off // 4).astype(np.int64)
        bank = words % 32
        same = words[:, :, None] == words[:, None, :]
        earlier = np.tri(WARP, k=-1, dtype=bool)[None]
        seen = (same & earlier & active[:, None, :]).any(-1)
        first = active & ~seen
        counts = np.zeros((off.shape[0], 32), np.int64)
        np.add.at(counts, (np.arange(off.shape[0])[:, None], bank), first)
        self.worst = max(self.worst, int(counts.max()))
        self.lookups += int(active.sum())
        self.instructions += int(active.any(1).sum())
        return SMEM[words]

    def fold4(self, c, active):
        """Z^4(c) through lane-offset lookups (T3, T2 | T1, T0)."""
        h = U32(HALF_BYTES)
        return (self._at(_byte_perm(c, self.lo, 0x5504), active)
                ^ self._at(_byte_perm(c, self.hi, 0x5514), active)
                ^ self._at(h + _byte_perm(c, self.lo, 0x5524), active)
                ^ self._at(h + _byte_perm(c, self.hi, 0x5534), active))

    def byte(self, crc, b, active):
        h = U32(HALF_BYTES)
        return (crc >> U32(8)) ^ self._at(
            h + _byte_perm(crc ^ b, self.hi, 0x5504), active)


def _clmul(x, y) -> np.ndarray:
    """crc32.cu's clmul: integer products of operands masked to every
    fourth bit."""
    xs = [np.asarray(x, U32) & U32(0x11111111 << a) for a in range(4)]
    ys = [np.asarray(y, U32) & U32(0x11111111 << a) for a in range(4)]
    z = [np.zeros(np.broadcast(x, y).shape, U64) for _ in range(4)]
    for a in range(4):
        for b in range(4):
            z[(a + b) & 3] ^= xs[a].astype(U64) * ys[b].astype(U64)
    m = 0x1111111111111111
    return ((z[0] & U64(m)) | (z[1] & U64(m << 1)) | (z[2] & U64(m << 2))
            | (z[3] & U64((m << 3) & (2**64 - 1))))


def _gf_mul(r, k, warp: Warp, active) -> np.ndarray:
    p = _clmul(r, k) << U64(1)
    return (p >> U64(32)).astype(U32) ^ warp.fold4(
        (p & U64(0xFFFFFFFF)).astype(U32), active)


def _mul_bitwise(a: int, b: int) -> int:
    """a (x) b mod P on reflected registers, one bit of b at a time."""
    acc = 0
    for k in range(32):                 # b's bit 31 - k: x^k
        if (b >> (31 - k)) & 1:
            acc ^= a
        a = (a >> 1) ^ (POLY if a & 1 else 0)
    return acc


def _vec(base: int, mtu: int) -> int:
    """The wrapper's load size: 16 bytes when base and MTU allow."""
    return 16 if base % 16 == 0 and mtu % 16 == 0 else 8


def _worst_bank(addr: np.ndarray, active: np.ndarray, width: int) -> int:
    """The most distinct words one bank serves in one phase of a warp's
    ``width``-byte shared-memory accesses at byte ``addr`` ((G, 32)): a
    phase is the lanes whose accesses make up 128 bytes."""
    per = 128 // width
    worst = 0
    for ph in range(0, WARP, per):
        a, act = addr[:, ph:ph + per], active[:, ph:ph + per]
        words = (a[..., None] // 4 + np.arange(width // 4)).reshape(
            a.shape[0], -1)
        on = np.repeat(act, width // 4, axis=1)
        for bank in range(32):
            sel = np.where(on & (words % 32 == bank), words, -1)
            distinct = np.array([len(set(r[r >= 0])) for r in sel])
            worst = max(worst, int(distinct.max()))
    return worst


def emulate(pay: np.ndarray, plen: np.ndarray, vec: int, base: int = 0):
    """crc32.cu on (N, MTU) rows at byte ``base`` of the device, read
    ``vec`` bytes a load -> (CRCs, the warps' lookups).  Emulates each
    segment's copies into the warp's buffer (which starts full of stale
    bytes) and each lane's reads of its piece, and asserts that every copy
    lies in its row and starts below its owner's plen, that a copy
    instruction reads whole lines, and that no buffer store or read of a
    phase conflicts."""
    n, mtu = pay.shape
    t, c = team(mtu, vec)
    per_warp = WARP // t
    groups = -(-n // per_warp)
    lane = np.arange(WARP)
    p = np.arange(groups)[:, None] * per_warp + lane // t     # (G, 32)
    live = p < n
    pc = np.minimum(p, n - 1)
    length = np.where(live, np.clip(plen[pc], 0, mtu), 0)
    l = lane & (t - 1)
    mine = np.clip(length - l * c, 0, c)
    warp = Warp(p.shape)
    crc = np.where(l == 0, U32(0xFFFFFFFF), U32(0)) * np.ones(p.shape, U32)
    rows = pay.reshape(-1)
    buf = np.random.default_rng(99).integers(0, 256, (groups, WARP * SEG),
                                             dtype=np.uint8)
    g_ix = np.arange(groups)[:, None]
    loads, pieces = SEG // vec, WARP // (SEG // vec)
    aligned = base % 128 == 0 and mtu % 128 == 0 and c % 128 == 0
    for s0 in range(0, c, SEG):
        b = lane % loads
        for k in range(loads):                   # a copy instruction
            piece = k * pieces + lane // loads
            at = l[piece] * c + s0 + b * vec     # in the owner's row
            copy = b * vec < mine[:, piece] - s0
            assert ((at + vec <= mtu) | ~copy).all(), "a copy leaves the row"
            assert ((at < length[:, piece]) | ~copy).all(), \
                "a copy starts past plen"
            src = pc[:, piece] * mtu + np.where(copy, at, 0)
            for r in range(groups):
                lines = {(base + x) // 128 for x in src[r][copy[r]]}
                assert len(lines) <= (1 if aligned else 2) * pieces, lines
            col = b if vec == 16 else b >> 1
            dst = piece * SEG + ((col ^ (piece & 7)) << 4) + \
                (0 if vec == 16 else (b & 1) << 3)
            dst = np.broadcast_to(dst, p.shape)
            warp.buffer_worst = max(warp.buffer_worst,
                                    _worst_bank(dst, copy, vec))
            for i in range(vec):
                buf[g_ix, dst + i] = np.where(copy, rows[src + i],
                                              buf[g_ix, dst + i])
        words = np.zeros(p.shape + (SEG // 4,), U32)
        for cc in range(SEG // 16):              # a lane reads its piece
            at = np.broadcast_to(lane * SEG + ((cc ^ (lane & 7)) << 4),
                                 p.shape)
            warp.buffer_worst = max(warp.buffer_worst, _worst_bank(
                at, np.ones(p.shape, bool), 16))
            for i in range(4):
                w = np.zeros(p.shape, U32)
                for bb in range(4):
                    w |= buf[g_ix, at + 4 * i + bb].astype(U32) << U32(8 * bb)
                words[..., 4 * cc + i] = w
        # fold_seg: a warp whose lanes all hold a full segment folds every
        # word; any other steps every lane up to the lanes' most words,
        # keeping each lane's crc past its own, then 3 byte steps
        m = np.clip(mine - s0, 0, SEG)
        whole = m >> 2
        full = (m == SEG).all(1)[:, None]
        steps = ((m + 3) >> 2).max(1)[:, None]
        tail = np.zeros(p.shape, U32)
        for j in range(SEG // 4):
            run = np.broadcast_to(full | (j < steps), p.shape)
            f = warp.fold4(crc ^ words[..., j], run)
            crc = np.where(run & (full | (j < whole)), f, crc)
            tail = np.where(run & ~full & (j == whole), words[..., j], tail)
        part = np.broadcast_to(~full, p.shape)
        for i in range(3):
            f = warp.byte(crc, tail >> U32(8 * i), part)
            crc = np.where(part & (i < (m & 3)), f, crc)
    q, s = length // c, length % c
    mul = l < q
    k = powers(mtu, vec)[np.where(mul, s * t + (q - 1 - l), 0)]
    u = np.where(mul, _gf_mul(crc, k, warp, mul), crc)
    d = t // 2
    while d:
        u = u ^ u[:, lane ^ d]
        d //= 2
    out = np.zeros(n, U32)
    first = live & (l == 0)
    out[p[first]] = u[first] ^ U32(0xFFFFFFFF)
    return out, warp


def _zlib(pay, plen) -> np.ndarray:
    mtu = pay.shape[1]
    return np.array([zlib.crc32(pay[i, :max(0, min(int(plen[i]), mtu))]
                                .tobytes()) for i in range(len(pay))], U32)


def _check(pay, plen, vec, base=0):
    got, warp = emulate(pay, plen, vec, base)
    np.testing.assert_array_equal(got, _zlib(pay, plen))
    assert warp.worst == 1, f"a lookup took {warp.worst} wavefronts"
    assert warp.buffer_worst == 1, "a buffer access conflicts"
    return got, warp


@pytest.mark.parametrize("mtu", MTUS)
def test_team_mapping(mtu):
    """Teams are powers of two up to a warp, hold the row, leave no lane a
    sliver, and 128 B a lane at MTU 4096."""
    for vec in (8, 16) if mtu % 16 == 0 else (8,):
        t, c = team(mtu, vec)
        assert t & (t - 1) == 0 and 1 <= t <= WARP
        assert c % vec == 0 and t * c >= mtu and c <= max(mtu, vec)
        assert t == 1 or c >= 64, (t, c)
        assert t == WARP or t * SEG >= mtu
    assert team(4096, 16) == (32, 128) and team(256, 16) == (2, 128)
    assert team(64, 16) == (1, 64)


@pytest.mark.parametrize("mtu", MTUS)
def test_scheme_matches_zlib_oracle_pallas_and_plain_at_every_edge(mtu):
    """Every plen edge at each MTU, both load sizes where the MTU allows;
    the reference's oracle and Pallas kernel (interpret) and the port's
    plain version agree."""
    rng = np.random.default_rng(mtu)
    plen = np.array(_edges(mtu), np.int32)
    pay = rng.integers(0, 256, (len(plen), mtu), dtype=np.uint8)
    want = _zlib(pay, plen)
    for vec in (16, 8) if mtu % 16 == 0 else (8,):
        got, _ = _check(pay, plen, vec)
    np.testing.assert_array_equal(
        np.asarray(jref.crc32_ref(jnp.asarray(pay), jnp.asarray(plen))), want)
    np.testing.assert_array_equal(
        np.asarray(crc32_pallas(jnp.asarray(pay), jnp.asarray(plen))), want)
    np.testing.assert_array_equal(
        R.crc32_ref(torch.from_numpy(pay), torch.from_numpy(plen)).numpy(),
        want.astype(np.int64))


@pytest.mark.parametrize("mtu", MTUS)
def test_scheme_at_batches_around_a_warp_of_teams(mtu):
    """N of 1 and of one team below, at and above a warp's worth of teams,
    with random lengths (a third full)."""
    t, _ = team(mtu, _vec(0, mtu))
    per_warp = WARP // t
    for n in sorted({1, max(per_warp - 1, 1), per_warp, per_warp + 1}):
        rng = np.random.default_rng(n * 1000 + mtu)
        pay = rng.integers(0, 256, (n, mtu), dtype=np.uint8)
        plen = rng.integers(-1, mtu + 2, n).astype(np.int32)
        plen[::3] = mtu
        _check(pay, plen, _vec(0, mtu))
        np.testing.assert_array_equal(
            R.crc32_ref(torch.from_numpy(pay), torch.from_numpy(plen))
            .numpy(), _zlib(pay, plen).astype(np.int64))


@pytest.mark.parametrize("mtu", (64, 256, 4096))
def test_rows_off_a_16_byte_boundary_take_8_byte_loads(mtu):
    """A payload whose base is 8 B past a 16-byte boundary is read 8 bytes
    a load (the wrapper's choice), with the same CRCs."""
    assert _vec(8, mtu) == 8 and _vec(0, mtu) == 16
    rng = np.random.default_rng(mtu + 1)
    plen = np.array(_edges(mtu), np.int32)
    pay = rng.integers(0, 256, (len(plen), mtu), dtype=np.uint8)
    a, _ = _check(pay, plen, 8, base=8)
    b, _ = _check(pay, plen, 16)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mtu", (24, 136, 4096))
def test_bytes_past_plen_change_nothing(mtu):
    rng = np.random.default_rng(3)
    plen = np.array(_edges(mtu), np.int32)
    pay = rng.integers(0, 256, (len(plen), mtu), dtype=np.uint8)
    other = pay.copy()
    for i, n in enumerate(plen):
        other[i, max(n, 0):] = rng.integers(0, 256, mtu - max(min(n, mtu), 0))
    vec = _vec(0, mtu)
    np.testing.assert_array_equal(emulate(pay, plen, vec)[0],
                                  emulate(other, plen, vec)[0])


@pytest.mark.parametrize("mtu,vec", [(64, 16), (136, 8), (4096, 16),
                                     (8192, 8)])
def test_power_table_is_the_bitwise_product(mtu, vec):
    t, c = team(mtu, vec)
    table = powers(mtu, vec)
    assert table.dtype == U32 and table.shape == (t * c,)
    x8 = _mul_bitwise(0x80000000, 0x00800000)          # x^8 (bit 31 - 8)
    assert x8 == 0x00800000
    v = 0x80000000                                     # x^0
    for e in range(t * c):
        k, s = divmod(e, c)
        assert table[s * t + k] == v, (mtu, vec, e)
        v = _mul_bitwise(v, x8)


def test_product_is_the_bitwise_product():
    """clmul and the slice-by-4 reduction against a bit-at-a-time
    product, at random, zero, one (x^0) and all-ones operands."""
    rng = np.random.default_rng(11)
    a = np.concatenate([rng.integers(0, 2**32, 400, dtype=np.uint64),
                        [0, 0x80000000, 0xFFFFFFFF, 1]]).astype(U32)
    b = np.concatenate([rng.integers(0, 2**32, 400, dtype=np.uint64),
                        [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 1]]).astype(U32)
    shape = (-1, WARP)
    pad = (-len(a)) % WARP
    a2 = np.concatenate([a, np.zeros(pad, U32)]).reshape(shape)
    b2 = np.concatenate([b, np.zeros(pad, U32)]).reshape(shape)
    warp = Warp(a2.shape)
    got = _gf_mul(a2, b2, warp, np.ones(a2.shape, bool)).reshape(-1)
    want = [_mul_bitwise(int(x), int(y)) for x, y in zip(a, b)]
    np.testing.assert_array_equal(got[:len(a)], np.array(want, U32))
    assert warp.worst == 1
    for x, y in zip(a[:50], b[:50]):              # the carry-less product
        ref = 0
        for i in range(32):
            if (int(y) >> i) & 1:
                ref ^= int(x) << i
        assert int(_clmul(x, y)) == ref


def test_staged_copies_are_the_host_tables():
    """Copy l of T_k[b] sits at the byte offset the lane's permute forms:
    (b << 8) | (half << 7) | (l << 2) in the half of T3|T2 or T1|T0."""
    image = table_image()
    np.testing.assert_array_equal(image, R.CRC_TABLES8[[3, 2, 1, 0]])
    np.testing.assert_array_equal(R.CRC_TABLES8[0], jref.CRC_TABLE)
    for k, (half, second) in enumerate([(1, 1), (0, 1), (1, 0), (0, 0)]):
        for lane in (0, 17, 31):
            off = second * HALF_BYTES + (np.arange(256) << 8) \
                + (half << 7) + (lane << 2)
            np.testing.assert_array_equal(SMEM[off // 4], R.CRC_TABLES8[k])


@pytest.mark.parametrize("mtu", (64, 256, 4096, 8192))
def test_warp_lookups_count_what_the_warps_issue(mtu):
    """``warp_lookups`` (chip_smoke.py's design bound) counts the emulated
    warps' lookup instructions; a full 4 KiB packet takes 132: one a
    4-byte word of each lane's chunk, 4 for the multiply."""
    rng = np.random.default_rng(5)
    plen = np.array(_edges(mtu) + [mtu] * 5, np.int32)
    rng.shuffle(plen)
    pay = rng.integers(0, 256, (len(plen), mtu), dtype=np.uint8)
    _, warp = _check(pay, plen, 16)
    assert warp.instructions == warp_lookups(plen, mtu, 16)
    assert warp_lookups(np.array([4096]), 4096, 16) == 132
