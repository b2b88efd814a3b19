// Segmented payload reduction for Hopper (sm_90a): the strict left fold
// ((x0 + x1) + x2) + ... over K rows, per lane, in float32 or int32.
//
// Replaces the TPU kernel src/repro/kernels/reduce.py:reduce_fold_pallas
// (body _fold_kernel, reached through chunk_reduce).  That kernel pads
// the element axis to 512-lane VMEM tiles and runs the K-deep fold over
// each tile.  Here one thread owns one lane: it reads the lane of row 0,
// adds the lanes of rows 1..K-1 in order, and writes the sum once.
//
// The fold order is the contract of the collectives (ring, switch
// offload and oracle are bit-identical because each folds the same
// association), so there is no tree, no split over K and no atomics.
// Float adds are __fadd_rn (round to nearest, never contracted, no
// flush to zero: the build has no --use_fast_math), so NaN, +-inf and
// -0.0 come out as IEEE addition gives them.  int32 adds run on
// uint32_t and are cast back: wrapping on overflow, as the reference's
// int32 arithmetic does (signed overflow is undefined in C++).
//
// The rows are the collective's wire payloads, read in place: row k
// starts `row_stride` elements after row k-1 (the (K, nbytes) uint8
// payload matrix viewed as (K, nbytes / 4) words by the wrapper).
//
// Bound on the H100: bytes (K rows read once, one row written).  Lanes
// map to consecutive threads, so every row read is coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_fold_kernel(const T* __restrict__ x, T* __restrict__ out, int k,
                   long long lanes, long long row_stride) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < lanes; i += (long long)gridDim.x * blockDim.x) {
    T acc = x[i];
    for (int r = 1; r < k; ++r) acc = add(acc, x[r * row_stride + i]);
    out[i] = acc;
  }
}

template <typename T>
int launch(const void* x, void* out, int k, long long lanes,
           long long row_stride, void* stream) {
  if (lanes <= 0 || k <= 0) return 0;
  long long blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond
  reduce_fold_kernel<T><<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, k, lanes, row_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: k rows of `lanes` elements, row k at x + k * row_stride.  out:
// lanes elements.  dtype 0: float32, 1: int32.
int reduce_fold_launch(const void* x, void* out, int k, long long lanes,
                       long long row_stride, int dtype, void* stream) {
  if (dtype == 0) return launch<float>(x, out, k, lanes, row_stride, stream);
  if (dtype == 1)
    return launch<int32_t>(x, out, k, lanes, row_stride, stream);
  return (int)cudaErrorInvalidValue;
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
