// AES-128-ECB for Hopper (sm_90a), encrypt and decrypt.
//
// Replaces the TPU kernel src/repro/kernels/aes_ecb.py:aes_ecb_pallas
// (bodies _encrypt_kernel / _decrypt_kernel).  That kernel widens every
// byte to an int32 lane because the TPU's vector unit has no 8-bit
// lanes; here bytes stay bytes: one thread owns one 16-byte block,
// loaded and stored as one uint4, and keeps the state as four 32-bit
// column words in registers (byte r of column c at bits 8r of word c,
// which is exactly the little-endian layout of the uint4).  The rounds
// are aes_round.cuh's: one T-table a direction, replicated across the
// 32 banks of shared memory so that no lookup conflicts, whatever the
// data.
//
// Bound on the H100: the bytes (32 a block, each read once and written
// once).  This design's floor is higher, its shared-memory lookups
// (aes_round.cuh), about twice the bytes' time.  So the grid is
// persistent, two blocks of 16 warps an SM at most (as many as fit, from
// the occupancy the runtime reports), and each block stages the 64 KB of
// table copies once for all the blocks it walks over; each lane keeps two
// blocks in flight, so that two round chains overlap.  The work goes out
// in runs of 32 blocks, one a warp, dealt across the blocks of the grid
// before a block's next warp gets one, so that a launch of a few thousand
// blocks still spreads over every SM.
#include <cstdint>
#include <cuda_runtime.h>

#include "aes_round.cuh"
#include "grid.cuh"

namespace {

constexpr int kThreads = 512;
// dynamic shared memory: the schedule (44 words), then the table copies
constexpr int kTab = aes::kRkWords;
static_assert(kTab % 4 == 0, "the copies must be 16-byte aligned");
constexpr int kSmemBytes = (kTab + aes::kTableWords) * 4;   // 65,712

template <bool kDecrypt>
__global__ void __launch_bounds__(kThreads, 2)
aes_ecb_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
               const uint32_t* __restrict__ round_keys,
               const uint32_t* __restrict__ image, long long n) {
  extern __shared__ __align__(16) uint32_t sm[];
  aes::stage_round_keys<kDecrypt>(sm, round_keys, threadIdx.x, blockDim.x);
  aes::stage_tables<kThreads / 32>(sm + kTab, image, threadIdx.x, kThreads);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const aes::Tables tb(sm + kTab, lane);

  // runs of 32 blocks, run u to warp u / grid of block u % grid: runs u
  // and u + stride together, then on by 2 x stride; a warp whose second
  // run is past the end decrypts its one run alone
  const long long stride = (long long)gridDim.x * (kThreads / 32);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long u = (long long)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
       32 * u < n; u += 2 * stride) {
    const long long b0 = 32 * u + lane, b1 = 32 * (u + stride) + lane;
    if (32 * (u + stride) < n) {
      uint4 v[2] = {b0 < n ? in[b0] : zero, b1 < n ? in[b1] : zero};
      aes::crypt<kDecrypt, 2>(v, tb, sm);
      if (b0 < n) out[b0] = v[0];
      if (b1 < n) out[b1] = v[1];
    } else {
      uint4 v[1] = {b0 < n ? in[b0] : zero};
      aes::crypt<kDecrypt, 1>(v, tb, sm);
      if (b0 < n) out[b0] = v[0];
    }
  }
}

// Resident blocks an SM of the encrypt or decrypt kernel.
cudaError_t per_sm(int decrypt, int* blocks) {
  return decrypt ? grid::blocks_per_sm(aes_ecb_kernel<true>, kThreads,
                                       kSmemBytes, kSmemBytes, blocks)
                 : grid::blocks_per_sm(aes_ecb_kernel<false>, kThreads,
                                       kSmemBytes, kSmemBytes, blocks);
}

}  // namespace

extern "C" {

// in/out: n blocks of 16 bytes, 16-byte aligned.  round_keys: the (11, 16)
// uint8 schedule, 4-byte aligned, read on the card at every launch.
// image: aes::kImageWords uint32 of the direction (kernels/aes_ecb.py:
// table_image).  The resident blocks are looked up once per device.
int aes_ecb_launch(const void* in, void* out, const void* round_keys,
                   const void* image, long long n, int decrypt,
                   void* stream) {
  static int resident[grid::kMaxDevices][2] = {};  // 0: not looked up yet
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = grid::current_device(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  decrypt = decrypt ? 1 : 0;
  int& res = resident[dev][decrypt];
  if (res == 0) {
    int blocks = 0;
    err = per_sm(decrypt, &blocks);
    if (err != cudaSuccess) return (int)err;
    res = blocks * sms;
  }
  // a block a run of 32 up to one an SM, so that an SM stages the tables
  // once; one block an SM until each of its warps has two runs in flight;
  // past that, the resident blocks
  const long long runs = (n + 31) / 32;
  const long long blocks = runs <= sms ? runs
                           : runs <= 2LL * sms * (kThreads / 32) ? sms
                                                                  : res;
  const uint4* src = (const uint4*)in;
  const uint32_t* rk = (const uint32_t*)round_keys;
  const uint32_t* tab = (const uint32_t*)image;
  if (decrypt)
    aes_ecb_kernel<true><<<(unsigned)blocks, kThreads, kSmemBytes,
                           (cudaStream_t)stream>>>(src, (uint4*)out, rk, tab,
                                                   n);
  else
    aes_ecb_kernel<false><<<(unsigned)blocks, kThreads, kSmemBytes,
                            (cudaStream_t)stream>>>(src, (uint4*)out, rk,
                                                    tab, n);
  return (int)cudaGetLastError();
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
