// Segmented payload reduction for Hopper (sm_90a): the strict left fold
// ((x0 + x1) + x2) + ... over K rows, per lane, in float32 or int32.
//
// Replaces the TPU kernel src/repro/kernels/reduce.py:reduce_fold_pallas
// (body _fold_kernel, reached through chunk_reduce).  That kernel pads
// the element axis to 512-lane VMEM tiles and runs the K-deep fold over
// each tile.
//
// The fold order is the contract of the collectives (ring, switch
// offload and oracle are bit-identical because each folds the same
// association), so there is no tree, no split over K and no atomics.
// Float adds are __fadd_rn (round to nearest, never contracted, no
// flush to zero: the build has no --use_fast_math), so NaN, +-inf and
// -0.0 come out as IEEE addition gives them.  int32 adds run on
// uint32_t: wrapping on overflow, as the reference's int32 arithmetic
// does (signed overflow is undefined in C++).  Both are folded as bit
// patterns in uint32_t registers.
//
// The rows are the collective's wire payloads, read in place: row k
// starts `row_stride` elements after row k-1 (the (K, nbytes) uint8
// payload matrix viewed as (K, nbytes / 4) words by the wrapper).
//
// Bound on the H100: bytes (K rows read once, one row written).  To
// stream at the memory's rate the card needs some 18 KB in flight per
// SM, so every thread issues all its loads before its first add:
//   * A thread owns runs of kRun = 4 lanes and loads the run of every
//     row (K <= 8 a template parameter; a larger K in batches of kBatch
//     rows, in order) before it adds.
//   * Vector mapping, when the rows' base, their stride and the output
//     are 16-byte aligned: run r is lanes 4r..4r+3, one 16-byte load a
//     row.  Scalar mapping otherwise (the ring's second row starts
//     499,524 B in, 4 B past a 16-byte boundary): the 32 runs of a warp
//     cover 128 consecutive lanes, run r taking lanes c + l, c + 32 + l,
//     c + 64 + l and c + 96 + l (c = 128 * (r / 32), l = r % 32): four
//     coalesced 4-byte loads a row, all in flight together.
//   * A thread takes kRuns<kVec> runs a pass: 2 in the vector mapping
//     (K x 32 B in flight), 1 in the scalar one, whose launches are the
//     collectives' small folds (a packet, a ring chunk of 0.5 MB), bound
//     by their latency: 4 K loads a thread, not 8 K.
//   * Loads take the read-only path (ld.global.nc) and carry no
//     evict-first hint.  With .cs loads, on an H100 at (4, 8,388,608), a
//     launch after one of its own took 0.058 ms and one after torch.sum
//     0.049 (chip_smoke.py's turns); without the hint both take about
//     0.0555.  Likely the evict-first input lines leave the output's
//     dirty lines in the L2 for the next launch to write back.
//   * Lane indices are 32-bit (the wrapper takes L < 2^31).
//   * Blocks of 128 threads; the grid is the blocks the lanes need, on
//     at most the resident grid in passes of equal work
//     (grid.cuh:capped_blocks).  A ragged tail (L not a multiple of the
//     run) is masked lane by lane.
#include <cstdint>
#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 4;            // lanes a run
template <bool kVec>
constexpr int kRuns = kVec ? 2 : 1;   // runs a thread folds each pass
constexpr int kBatch = 8;          // rows in flight at once when K > 8
constexpr uint32_t kWarpLanes = 32 * kRun;

struct AddF32 {
  __device__ static uint32_t add(uint32_t a, uint32_t b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
};

struct AddI32 {
  __device__ static uint32_t add(uint32_t a, uint32_t b) { return a + b; }
};

// The lane that element j of run r holds.
template <bool kVec>
__device__ __forceinline__ uint32_t lane_of(uint32_t r, int j) {
  return kVec ? r * kRun + j : (r & ~31u) * kRun + j * 32 + (r & 31u);
}

template <bool kVec>
__device__ __forceinline__ void load_run(uint32_t (&v)[kRun],
                                         const uint32_t* __restrict__ row,
                                         uint32_t r, uint32_t lanes) {
  if (kVec && r * kRun + kRun <= lanes) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(row) + r);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const uint32_t i = lane_of<kVec>(r, j);
    v[j] = i < lanes ? __ldg(row + i) : 0u;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_run(uint32_t* __restrict__ out,
                                          const uint32_t (&v)[kRun],
                                          uint32_t r, uint32_t lanes) {
  if (kVec && r * kRun + kRun <= lanes) {
    reinterpret_cast<uint4*>(out)[r] = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const uint32_t i = lane_of<kVec>(r, j);
    if (i < lanes) out[i] = v[j];
  }
}

// K > 0: exactly K rows, one batch.  K == 0: `k` rows in batches of
// kBatch.  Either way row r is added after rows 0..r-1.
template <class Op, int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
reduce_fold_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   int k, uint32_t lanes, unsigned long long row_stride) {
  constexpr int kb = K > 0 ? K : kBatch;
  constexpr int nu = kRuns<kVec>;
  const int rows = K > 0 ? K : k;
  // runs cover whole warps' 128 lanes, so the scalar mapping reaches
  // every lane
  const uint32_t runs = (lanes + kWarpLanes - 1) / kWarpLanes * 32;
  const uint32_t pass = gridDim.x * kThreads * nu;
  for (uint32_t r0 = blockIdx.x * kThreads * nu + threadIdx.x; r0 < runs;
       r0 += pass) {
    uint32_t acc[nu][kRun];
    for (int b = 0; b < rows; b += kb) {
      uint32_t v[kb][nu][kRun];
#pragma unroll
      for (int i = 0; i < kb; ++i) {
        if (K == 0 && b + i >= rows) break;
        const uint32_t* row = x + (unsigned long long)(b + i) * row_stride;
#pragma unroll
        for (int u = 0; u < nu; ++u)
          load_run<kVec>(v[i][u], row, r0 + u * kThreads, lanes);
      }
#pragma unroll
      for (int i = 0; i < kb; ++i) {
        if (K == 0 && b + i >= rows) break;
#pragma unroll
        for (int u = 0; u < nu; ++u)
#pragma unroll
          for (int j = 0; j < kRun; ++j)
            acc[u][j] = b + i == 0 ? v[i][u][j]
                                   : Op::add(acc[u][j], v[i][u][j]);
      }
    }
#pragma unroll
    for (int u = 0; u < nu; ++u)
      store_run<kVec>(out, acc[u], r0 + u * kThreads, lanes);
  }
}

template <class Op, int K, bool kVec>
int launch(const void* x, void* out, int k, uint32_t lanes,
           unsigned long long row_stride, cudaStream_t stream) {
  constexpr long long per_block = kThreads * kRuns<kVec>;
  const long long runs = ((long long)lanes + kWarpLanes - 1) / kWarpLanes * 32;
  long long blocks = 0;
  cudaError_t err = grid::capped_blocks(reduce_fold_kernel<Op, K, kVec>,
                                        kThreads,
                                        (runs + per_block - 1) / per_block,
                                        &blocks);
  if (err != cudaSuccess) return (int)err;
  reduce_fold_kernel<Op, K, kVec><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const uint32_t*)x, (uint32_t*)out, k, lanes, row_stride);
  return (int)cudaGetLastError();
}

template <class Op, bool kVec>
int launch_k(const void* x, void* out, int k, uint32_t lanes,
             unsigned long long row_stride, cudaStream_t s) {
  switch (k) {
    case 1: return launch<Op, 1, kVec>(x, out, k, lanes, row_stride, s);
    case 2: return launch<Op, 2, kVec>(x, out, k, lanes, row_stride, s);
    case 3: return launch<Op, 3, kVec>(x, out, k, lanes, row_stride, s);
    case 4: return launch<Op, 4, kVec>(x, out, k, lanes, row_stride, s);
    case 5: return launch<Op, 5, kVec>(x, out, k, lanes, row_stride, s);
    case 6: return launch<Op, 6, kVec>(x, out, k, lanes, row_stride, s);
    case 7: return launch<Op, 7, kVec>(x, out, k, lanes, row_stride, s);
    case 8: return launch<Op, 8, kVec>(x, out, k, lanes, row_stride, s);
    default: return launch<Op, 0, kVec>(x, out, k, lanes, row_stride, s);
  }
}

template <class Op>
int launch_op(const void* x, void* out, int k, uint32_t lanes,
              unsigned long long row_stride, cudaStream_t s) {
  const bool vec = (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                   (k == 1 || row_stride % kRun == 0);
  return vec ? launch_k<Op, true>(x, out, k, lanes, row_stride, s)
             : launch_k<Op, false>(x, out, k, lanes, row_stride, s);
}

}  // namespace

extern "C" {

// x: k rows of `lanes` elements, row k at x + k * row_stride.  out:
// lanes elements.  dtype 0: float32, 1: int32.  0 < lanes < 2^31.
int reduce_fold_launch(const void* x, void* out, int k, long long lanes,
                       long long row_stride, int dtype, void* stream) {
  if (lanes <= 0 || k <= 0) return 0;
  if (lanes >= (1LL << 31) || row_stride < 0)
    return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_op<AddF32>(x, out, k, (uint32_t)lanes, row_stride, s);
  if (dtype == 1)
    return launch_op<AddI32>(x, out, k, (uint32_t)lanes, row_stride, s);
  return (int)cudaErrorInvalidValue;
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
