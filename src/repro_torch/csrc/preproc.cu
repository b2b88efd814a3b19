// DLRM preprocessing (paper §8.1) for Hopper (sm_90a): Neg2Zero -> Log
// on the dense columns, Modulus on the sparse ones, in one pass.
//
// Replaces the TPU kernel src/repro/kernels/preproc.py:preproc_pallas
// (body _preproc_kernel, also reached through preproc_tile).  That
// kernel pads the record matrix to 512-row VMEM tiles and rewrites a
// tile at a time.  Here one thread owns one int32 word: it reads the
// word once, computes its column within the record, and writes either
// the float32 bits of log1p(max(x, 0)) or the floor-mod of x.  No
// padding: the grid covers exactly the words there are, and a ragged
// last block masks itself.
//
// The input may be a packet-strided view: `rows` rows of `row_words`
// words each (a whole number of records), consecutive rows
// `in_row_stride` words apart.  That is how a fragment tile arrives
// (26 records of 39 words at the head of each 1024-word packet), so the
// tile decoder hands the kernel the packet matrix as it lies and no
// gather copy runs first.  The output is the dense (rows * row_words)
// record matrix.
//
// Floor-mod: C++ `%` truncates toward zero, jnp.remainder (and
// torch.remainder) floor, so the sign of a non-zero remainder follows
// the divisor: r += m when r != 0 and r and m differ in sign.
// m == -1 is taken apart because INT32_MIN % -1 overflows.
//
// Bound on the H100: bytes (each word read once and written once).
// One scalar 4-byte access per thread, neighbouring threads on
// neighbouring words, is coalesced; the integer division that finds a
// word's column costs issue slots, not bandwidth.  At the tile shape
// (52 records) the launch itself dominates.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
preproc_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
               long long rows, int row_words, long long in_row_stride,
               int rec_w, int n_dense, int modulus) {
  const long long n = rows * row_words;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / row_words;
    const int c = (int)(i - r * row_words);
    const int x = in[r * in_row_stride + c];
    int y;
    if (c % rec_w < n_dense) {
      y = __float_as_int(log1pf(fmaxf((float)x, 0.0f)));
    } else if (modulus == -1) {
      y = 0;
    } else {
      int m = x % modulus;
      if (m != 0 && ((m ^ modulus) < 0)) m += modulus;
      y = m;
    }
    out[i] = y;
  }
}

}  // namespace

extern "C" {

// in: int32 words, rows x row_words with row stride in_row_stride
// (words).  out: rows * row_words int32, contiguous.  row_words % rec_w
// == 0; modulus != 0.
int preproc_launch(const void* in, void* out, long long rows, int row_words,
                   long long in_row_stride, int rec_w, int n_dense,
                   int modulus, void* stream) {
  const long long n = rows * row_words;
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond
  preproc_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, rows, row_words, in_row_stride,
      rec_w, n_dense, modulus);
  return (int)cudaGetLastError();
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
