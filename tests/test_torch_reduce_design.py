"""The lane, run and row mapping of the port's segmented-reduce kernel, on
the CPU.

``csrc/reduce.cu`` folds K rows with blocks of 128 threads; a thread owns
runs of 4 lanes (2 a pass in the vector mapping, 1 in the scalar one)
and loads the run of every row (K <= 8 at once, a larger K in batches of
8 rows) before its first add.  With the rows'
base, their stride and the output 16-byte aligned a run is 4
consecutive lanes read by one 16-byte load; otherwise (the ring's second
row starts 499,524 B in) a warp's 32 runs cover 128 consecutive lanes,
run r taking lanes c + l + 32 j (c = 128 (r // 32), l = r % 32), read by
coalesced 4-byte loads.  The grid strides over the runs.  The kernel
cannot run here, so this file emulates that mapping in numpy: every lane
of every row is read exactly once, each lane folds its rows in row
order, every vector load is aligned and every scalar load of a warp
coalesced; and the emulated fold is held bit for bit against the
reference's oracle (``reduce_fold_ref``) and its Pallas kernel
(interpret mode) on numpy-seeded float32 (NaN, +-inf, -0.0) and int32
(wrapping) rows.  tests/test_torch_cuda.py holds the kernel itself
against the plain version on the card at the same edges.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels.reduce import reduce_fold_pallas, reduce_fold_ref

THREADS, RUN, BATCH = 128, 4, 8               # reduce.cu's constants
WARP_LANES = 32 * RUN


def _vector(base_bytes: int, out_bytes: int, k: int, stride: int) -> bool:
    """reduce.cu's launch_op: the vector mapping when every row's start and
    the output are 16-byte aligned."""
    return base_bytes % 16 == 0 and out_bytes % 16 == 0 and \
        (k == 1 or stride % RUN == 0)


def _runs(vector: bool) -> int:
    """kRuns<kVec>: the runs a thread folds a pass."""
    return 2 if vector else 1


def _blocks(lanes: int, vector: bool) -> int:
    """The blocks the lanes need (the launch spreads them over passes of
    the resident grid, which only makes each thread stride further)."""
    runs = -(-lanes // WARP_LANES) * 32
    return -(-runs // (THREADS * _runs(vector)))


def _visits(lanes: int, grid: int, vector: bool) -> np.ndarray:
    """(n, kRuns) runs in the order the threads take them: thread t of
    block b, pass p, takes runs r0 + u * THREADS with r0 = b * THREADS *
    kRuns + t + p * grid * THREADS * kRuns < runs.  Rows are (b, t, p)."""
    nu = _runs(vector)
    runs = -(-lanes // WARP_LANES) * 32
    step = grid * THREADS * nu
    first = (np.arange(grid)[:, None] * THREADS * nu
             + np.arange(THREADS)[None, :]).reshape(-1)
    r0 = (first[:, None] + step * np.arange(-(-runs // step) + 1)[None, :])
    r0 = r0[r0 < runs]
    return r0[:, None] + THREADS * np.arange(nu)[None, :]


def _lanes_of(r: np.ndarray, vector: bool) -> np.ndarray:
    """The lanes of each run, ``lane_of`` of the kernel: (...) -> (..., 4)."""
    j = np.arange(RUN)
    r = r[..., None]
    if vector:
        return r * RUN + j
    return (r & ~31) * RUN + j * 32 + (r & 31)


def _emulate(flat: np.ndarray, k: int, lanes: int, stride: int,
             vector: bool, grid: int, add) -> np.ndarray:
    """The kernel's fold, run by run, over rows ``flat[i * stride:][:lanes]``:
    per batch of rows the loads first, then the adds in row order.
    Asserts that every lane of every row is read once."""
    runs = _visits(lanes, grid, vector).reshape(-1)
    idx = _lanes_of(runs, vector)                       # (runs, 4)
    live = idx < lanes
    reads = np.zeros((k, lanes), np.int64)
    kb = k if k <= BATCH else BATCH
    acc = None
    for b in range(0, k, kb):
        loads = []
        for i in range(b, min(b + kb, k)):
            row = flat[i * stride:i * stride + lanes]
            np.add.at(reads[i], idx[live], 1)
            loads.append(np.where(live, row[np.minimum(idx, lanes - 1)], 0))
        for v in loads:
            acc = v.copy() if acc is None else add(acc, v)
    assert (reads == 1).all(), "a lane read more or less than once"
    out = np.empty(lanes, flat.dtype)
    out[idx[live]] = acc[live]
    assert np.unique(idx[live]).size == lanes, "a lane written twice"
    return out


def _f32_add(a, b):
    """An IEEE float32 add of two bit patterns, by XLA as the oracle adds
    (so a NaN made from inf - inf has the oracle's sign bit)."""
    s = jnp.asarray(a.view(np.float32)) + jnp.asarray(b.view(np.float32))
    return np.asarray(s).view(a.dtype)


def _i32_add(a, b):
    return (a.view(np.uint32) + b.view(np.uint32)).view(a.dtype)


def _rows(rng, k, lanes, stride, dtype):
    """(k - 1) * stride + lanes words; the rows at stride, the words
    between them garbage that must not be read."""
    n = (k - 1) * stride + lanes
    if dtype == np.float32:
        flat = rng.standard_normal(n).astype(np.float32)
        special = np.array([np.nan, np.inf, -np.inf, -0.0, 3e38],
                           np.float32)
        flat[rng.integers(0, n, min(n, 8))] = rng.choice(special,
                                                         min(n, 8))
        return flat.view(np.int32)
    return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


LANES = [1, 3, 4, 977, 1024, 124_881]


@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["stride%4==0", "stride%4!=0"])
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("k", range(1, 10))
def test_fold_mapping_matches_the_reference(k, lanes, misaligned):
    """Every lane of every row read exactly once and folded in row order,
    at the grid the launch sizes and at a grid of 1 and 3 blocks (a
    capped grid strides further), bit for bit the reference's oracle and
    Pallas kernel."""
    stride = -(-lanes // RUN) * RUN + (1 if misaligned else 0)
    if k == 1 and misaligned:
        stride = lanes + 1
    vector = _vector(0, 0, k, stride)
    assert vector == (not misaligned or k == 1)
    rng = np.random.default_rng(k * 1_000_003 + lanes + misaligned)
    for dtype, add in ((np.float32, _f32_add), (np.int32, _i32_add)):
        flat = _rows(rng, k, lanes, stride, dtype)
        x = np.stack([flat[i * stride:i * stride + lanes] for i in range(k)])
        want = np.asarray(reduce_fold_ref(jnp.asarray(x.view(dtype))))
        for grid in sorted({_blocks(lanes, vector), 1, 3}):
            got = _emulate(flat, k, lanes, stride, vector, grid, add)
            np.testing.assert_array_equal(got, want.view(np.int32))
        pallas = np.asarray(reduce_fold_pallas(jnp.asarray(x.view(dtype))))
        np.testing.assert_array_equal(pallas.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("lanes", LANES)
def test_vector_loads_are_aligned_and_scalar_loads_coalesced(lanes):
    """A vector run's 16-byte load starts on a 16-byte boundary of its row
    whenever the row does; a scalar load instruction j of a warp (its 32
    runs, element j each) reads 32 consecutive lanes."""
    runs = _visits(lanes, _blocks(lanes, True), True)    # (threads', 2)
    vec = _lanes_of(runs, True)
    full = vec[..., -1] < lanes
    assert (vec[..., 0][full] * 4 % 16 == 0).all()
    # a block's threads in order: the 32 runs a warp takes in one
    # instruction are consecutive, and each scalar load covers 32 lanes
    first = _visits(lanes, _blocks(lanes, False), False)[:, 0]
    blocks = first[: first.size // THREADS * THREADS].reshape(-1, THREADS)
    for b in blocks[:64]:
        for w in b.reshape(-1, 32):
            assert (np.diff(w) == 1).all() and w[0] % 32 == 0
            lanes_w = _lanes_of(w, False)                  # (32, 4)
            for j in range(RUN):
                assert (np.diff(lanes_w[:, j]) == 1).all()
                assert lanes_w[0, j] % 32 == 0


def test_path_fold_shapes_take_their_mappings():
    """The ring's fold: (2, 124,881) words read in place from the (2,
    499,524)-byte payload, whose second row starts 4 bytes past a 16-byte
    boundary: the scalar mapping, as the offload's (3, 977) last packet of
    a chunk; its (3, 1,024) packets and phase 2's (4, 8,388,608) take the
    vector one."""
    lanes = -(-499_521 // 4)
    assert lanes == 124_881 and lanes * 4 % 16 == 4
    assert not _vector(0, 0, 2, lanes) and not _vector(0, 0, 3, 977)
    assert _vector(0, 0, 3, 1024) and _vector(0, 0, 4, 8 * 1024 * 1024)
    assert _blocks(1024, True) == 1 and _blocks(977, False) == 2
    assert _blocks(124_881, False) == 244
    assert _blocks(8 * 1024 * 1024, True) == 8192
