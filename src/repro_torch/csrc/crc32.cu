// CRC32 (reflected polynomial 0xEDB88320, the Ethernet / RoCE ICRC) over
// payload[:plen] of every packet, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/crc32.py:crc32_pallas (body
// _crc_kernel).  That kernel walks the whole MTU for every packet of a
// tile, slice-by-8, and masks the bytes past plen out of a byte
// recurrence at every step.  Here one thread owns one packet: it folds
// eight bytes per step with the 8x256 slice-by-8 tables held in shared
// memory (8 KiB), stops at the last full word below plen and finishes
// the ragged tail byte by byte.  Nothing past plen is read.
//
// Bound on the H100: bytes (the payload bytes below plen, read once,
// plus 4 B written per packet).  A thread-per-packet walk is latency
// bound well before that: each step depends on the previous CRC, and an
// 8192-packet batch is only 64 warps on 132 SMs.  Splitting a packet
// across a warp and combining the partial CRCs is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
crc32_kernel(const uint8_t* __restrict__ payload, const int* __restrict__ plen,
             const uint32_t* __restrict__ tables, uint32_t* __restrict__ out,
             long long n, int mtu) {
  __shared__ uint32_t t[8][256];
  for (int i = threadIdx.x; i < 8 * 256; i += blockDim.x)
    t[i >> 8][i & 255] = tables[i];
  __syncthreads();

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int len = min(max(plen[p], 0), mtu);
  const uint8_t* row = payload + p * (long long)mtu;
  const uint2* words = reinterpret_cast<const uint2*>(row);
  uint32_t crc = 0xffffffffu;
  const int n_words = len >> 3;
  for (int k = 0; k < n_words; ++k) {
    const uint2 v = words[k];
    const uint32_t lo = crc ^ v.x;
    const uint32_t hi = v.y;
    crc = t[7][lo & 0xff] ^ t[6][(lo >> 8) & 0xff] ^
          t[5][(lo >> 16) & 0xff] ^ t[4][lo >> 24] ^
          t[3][hi & 0xff] ^ t[2][(hi >> 8) & 0xff] ^
          t[1][(hi >> 16) & 0xff] ^ t[0][hi >> 24];
  }
  for (int i = n_words << 3; i < len; ++i)
    crc = (crc >> 8) ^ t[0][(crc ^ row[i]) & 0xff];
  out[p] = crc ^ 0xffffffffu;
}

}  // namespace

extern "C" {

// payload: (n, mtu) uint8, 8-byte aligned, mtu % 8 == 0.  plen: (n,)
// int32.  tables: (8, 256) uint32.  out: (n,) uint32.
int crc32_launch(const void* payload, const void* plen, const void* tables,
                 void* out, long long n, int mtu, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  crc32_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int*)plen, (const uint32_t*)tables,
      (uint32_t*)out, n, mtu);
  return (int)cudaGetLastError();
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
