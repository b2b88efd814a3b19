// DLRM preprocessing (paper §8.1) for Hopper (sm_90a): Neg2Zero -> Log
// on the dense columns, Modulus on the sparse ones, in one pass.
//
// Replaces the TPU kernel src/repro/kernels/preproc.py:preproc_pallas
// (body _preproc_kernel, also reached through preproc_tile).  That
// kernel pads the record matrix to 512-row VMEM tiles and rewrites a
// tile at a time.  Here each word is read once and written once, as the
// float32 bits of log1p(max(x, 0)) or as the floor-mod of x.  No
// padding: the grid covers the words there are, and a ragged end masks
// itself.
//
// The input may be a packet-strided view: `rows` rows of `row_words`
// words each (a whole number of records), consecutive rows
// `in_row_stride` words apart.  That is how a fragment tile arrives
// (26 records of 39 words at the head of each 1024-word packet), so the
// tile decoder hands the kernel the packet matrix as it lies and no
// gather copy runs first.  The output is the dense (rows * row_words)
// record matrix.  Rows that lie back to back are one row.
//
// Bound on the H100: bytes (each word read once and written once), once
// the words' instructions are few enough.  What the design does for that:
//   * A thread moves V words at once: 16-byte accesses on a contiguous
//     batch, 8-byte ones on packet rows whose words are even but not a
//     multiple of 4 (1,014).  A launch of at most kSmallWords is bound by
//     its latency, not its bytes, so there a thread takes one word
//     (V = 1): a tile's 2,028 words are 4 blocks of 507 threads, each
//     thread's chain of work one word long.
//   * Each word computes both rewrites and keeps one (a select, no
//     branch): the words of a warp are mixed dense and sparse anyway, and
//     without branches a thread's V words overlap.
//   * No per-word division for the column.  A block has rec_w x G
//     threads (507 = 39 x 13 for DLRM records), so vector q of a row
//     and the vectors the same thread takes next, blockDim.x apart, start
//     at the same column: (V * q) % rec_w = (V * threadIdx.x) % rec_w.
//     A thread works out which of its V words are dense once, before its
//     loop (a bit mask).
//   * Floor-mod by the launch's modulus m without a division: |x| mod |m|
//     by Granlund and Montgomery's multiply-high with a magic number the
//     host computes once (kernels/preproc.py:floor_mod_magic), the sign
//     of x put back (a truncated remainder), then r += m when r != 0 and
//     r and m differ in sign (floor semantics, as jnp.remainder and
//     torch.remainder).  Unsigned throughout, so INT32_MIN and m == -1
//     need no case of their own.
//   * Loads take the read-only path (ld.global.nc), as in reduce.cu
//     (which says why not the evict-first hint).
//   * Indices are 32-bit within a row (the wrapper takes fewer than 2^31
//     words); rows stride over blockIdx.y, a row's vectors over
//     blockIdx.x, capped at the resident grid.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr long long kSmallWords = 1 << 16;   // one word a thread up to here

// Floor-mod by m: a = |m|, and |x| / a = (t + ((|x| - t) >> sh1)) >> sh2
// with t = mulhi(magic, |x|).
struct FloorMod {
  int32_t m;
  uint32_t a, magic;
  uint32_t sh1, sh2;
};

__device__ __forceinline__ int32_t floor_mod(int32_t x, const FloorMod& f) {
  const uint32_t n = x < 0 ? 0u - (uint32_t)x : (uint32_t)x;
  const uint32_t t = __umulhi(f.magic, n);
  const uint32_t q = (t + ((n - t) >> f.sh1)) >> f.sh2;
  const uint32_t u = n - q * f.a;                      // |x| mod |m|
  int32_t r = x < 0 ? -(int32_t)u : (int32_t)u;        // truncated
  if (r != 0 && (r ^ f.m) < 0) r += f.m;               // floored
  return r;
}

__device__ __forceinline__ int32_t rewrite(int32_t x, bool dense,
                                           const FloorMod& f) {
  const int32_t d = __float_as_int(log1pf(fmaxf((float)x, 0.0f)));
  const int32_t s = floor_mod(x, f);
  return dense ? d : s;
}

// Bit j: word j of a vector whose first word lies in column `col` is
// dense.
template <int V>
__device__ __forceinline__ uint32_t dense_bits(uint32_t col, uint32_t rec_w,
                                               uint32_t n_dense) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    bits |= (uint32_t)(col < n_dense) << j;
    col = col + 1 == rec_w ? 0 : col + 1;
  }
  return bits;
}

template <int V> struct Vec;
template <> struct Vec<4> { using T = int4; };
template <> struct Vec<2> { using T = int2; };
template <> struct Vec<1> { using T = int; };

template <int V>
__device__ __forceinline__ void load_vec(int32_t (&v)[V],
                                         const int32_t* __restrict__ row,
                                         uint32_t q, uint32_t words) {
  if (q * V + V <= words) {
    using T = typename Vec<V>::T;
    const T w = __ldg(reinterpret_cast<const T*>(row) + q);
    memcpy(v, &w, sizeof w);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    v[j] = q * V + j < words ? __ldg(row + q * V + j) : 0;
}

template <int V>
__device__ __forceinline__ void store_vec(int32_t* __restrict__ row,
                                          const int32_t (&v)[V], uint32_t q,
                                          uint32_t words) {
  if (q * V + V <= words) {
    using T = typename Vec<V>::T;
    T w;
    memcpy(&w, v, sizeof w);
    reinterpret_cast<T*>(row)[q] = w;
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (q * V + j < words) row[q * V + j] = v[j];
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
preproc_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
               uint32_t rows, uint32_t row_words,
               unsigned long long in_row_stride, uint32_t rec_w,
               uint32_t n_dense, FloorMod f) {
  const uint32_t nvec = (row_words + V - 1) / V;
  const uint32_t pass = gridDim.x * blockDim.x;
  // the same columns at every vector of this thread, unless a record is
  // wider than a block (rec_w > kMaxThreads): then found per vector
  const bool fixed = blockDim.x % rec_w == 0;
  const uint32_t mine = dense_bits<V>(V * threadIdx.x % rec_w, rec_w,
                                      n_dense);
  for (uint32_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int32_t* src = in + row * in_row_stride;
    int32_t* dst = out + (unsigned long long)row * row_words;
    for (uint32_t q = blockIdx.x * blockDim.x + threadIdx.x; q < nvec;
         q += pass) {
      int32_t v[V];
      load_vec<V>(v, src, q, row_words);
      const uint32_t dense =
          fixed ? mine : dense_bits<V>(V * q % rec_w, rec_w, n_dense);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = rewrite(v[j], dense >> j & 1u, f);
      store_vec<V>(dst, v, q, row_words);
    }
  }
}

template <int V>
int launch(const void* in, void* out, uint32_t rows, uint32_t row_words,
           unsigned long long in_row_stride, uint32_t rec_w,
           uint32_t n_dense, const FloorMod& f, cudaStream_t stream) {
  const int threads = rec_w <= (uint32_t)kMaxThreads
                          ? (int)(kMaxThreads / rec_w * rec_w) : kMaxThreads;
  const long long nvec = ((long long)row_words + V - 1) / V;
  const unsigned gy = rows < 65535u ? rows : 65535u;
  long long gx = 0;
  cudaError_t err = grid::capped_blocks(
      preproc_kernel<V>, threads, (nvec + threads - 1) / threads, &gx);
  if (err != cudaSuccess) return (int)err;
  preproc_kernel<V><<<dim3((unsigned)gx, gy), threads, 0, stream>>>(
      (const int32_t*)in, (int32_t*)out, rows, row_words, in_row_stride,
      rec_w, n_dense, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in: int32 words, rows x row_words with row stride in_row_stride
// (words).  out: rows * row_words int32, contiguous.  row_words % rec_w
// == 0; rows * row_words < 2^31; modulus != 0, with a = |modulus| and
// (magic, sh1, sh2) its Granlund-Montgomery divisor
// (kernels/preproc.py:floor_mod_magic).
int preproc_launch(const void* in, void* out, long long rows, int row_words,
                   long long in_row_stride, int rec_w, int n_dense,
                   int modulus, unsigned magic, int sh1, int sh2,
                   void* stream) {
  const long long n = rows * row_words;
  if (n <= 0) return 0;
  if (n >= (1LL << 31) || rec_w <= 0 || row_words % rec_w || n_dense < 0 ||
      in_row_stride < 0 || modulus == 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 1 || in_row_stride == row_words) {     // one contiguous row
    row_words = (int)n;
    rows = 1;
  }
  const FloorMod f{modulus,
                   modulus < 0 ? 0u - (uint32_t)modulus : (uint32_t)modulus,
                   magic, (uint32_t)sh1, (uint32_t)sh2};
  // the widest access that every row's start, in and out, allows
  auto fits = [&](int v) {
    return (uintptr_t)in % (4 * v) == 0 && (uintptr_t)out % (4 * v) == 0 &&
           (rows == 1 || (row_words % v == 0 && in_row_stride % v == 0));
  };
  const auto s = (cudaStream_t)stream;
  const uint32_t r = (uint32_t)rows, w = (uint32_t)row_words;
  const auto stride = (unsigned long long)in_row_stride;
  if (n <= kSmallWords)
    return launch<1>(in, out, r, w, stride, rec_w, n_dense, f, s);
  if (fits(4))
    return launch<4>(in, out, r, w, stride, rec_w, n_dense, f, s);
  if (fits(2))
    return launch<2>(in, out, r, w, stride, rec_w, n_dense, f, s);
  return launch<1>(in, out, r, w, stride, rec_w, n_dense, f, s);
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
