// AES-128-ECB for Hopper (sm_90a), encrypt and decrypt.
//
// Replaces the TPU kernel src/repro/kernels/aes_ecb.py:aes_ecb_pallas
// (bodies _encrypt_kernel / _decrypt_kernel).  That kernel widens every
// byte to an int32 lane because the TPU's vector unit has no 8-bit
// lanes; here bytes stay bytes: one thread owns one 16-byte block,
// loaded and stored as one uint4, and keeps the state as four 32-bit
// column words in registers (byte r of column c at bits 8r of word c,
// which is exactly the little-endian layout of the uint4).
//
// Per round: SubBytes+ShiftRows as 16 S-box lookups from shared memory
// (the byte of row r comes from column c+r, or c-r when decrypting),
// MixColumns on packed words (xtime on four bytes at once, rotations by
// __funnelshift_r), and the round-key XOR from shared memory.
// InvMixColumns is MixColumns after the standard pre-multiplication
// u = xtime(xtime(a ^ rot16(a))), a ^= u.
//
// Bound on the H100: bytes.  The kernel reads each block once and writes
// it once (32 B per 16-byte block); 10 rounds of table lookups are about
// 200 integer operations per block, far under the card's integer rate
// for the bytes it moves, so the design goal is full-width coalesced
// 16-byte accesses and no spills.  The S-box lookups are shared-memory
// gathers with data-dependent bank conflicts; T-tables or a bitsliced
// S-box are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t xt4(uint32_t x) {
  // GF(2^8) xtime on the four bytes of x independently
  return ((x & 0x7f7f7f7fu) << 1) ^ (((x >> 7) & 0x01010101u) * 0x1bu);
}

// byte r of the result is byte (r + k/8) % 4 of x
__device__ __forceinline__ uint32_t rot(uint32_t x, int k) {
  return __funnelshift_r(x, x, k);
}

__device__ __forceinline__ uint32_t mix(uint32_t a) {
  // b_r = 2a_r ^ 3a_{r+1} ^ a_{r+2} ^ a_{r+3}
  const uint32_t a1 = rot(a, 8);
  return xt4(a ^ a1) ^ a1 ^ rot(a, 16) ^ rot(a, 24);
}

__device__ __forceinline__ uint32_t inv_mix(uint32_t a) {
  const uint32_t u = xt4(xt4(a ^ rot(a, 16)));
  return mix(a ^ u);
}

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int r) {
  return (w >> (8 * r)) & 0xffu;
}

// SubBytes + ShiftRows (forward: row r of column c comes from column
// c + r; inverse: from column c - r)
template <bool kInverse>
__device__ __forceinline__ void sub_shift(const uint32_t* s_box,
                                          const uint32_t (&w)[4],
                                          uint32_t (&o)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int c1 = kInverse ? (c + 3) & 3 : (c + 1) & 3;
    const int c2 = (c + 2) & 3;
    const int c3 = kInverse ? (c + 1) & 3 : (c + 3) & 3;
    o[c] = s_box[byte_of(w[c], 0)] |
           (s_box[byte_of(w[c1], 1)] << 8) |
           (s_box[byte_of(w[c2], 2)] << 16) |
           (s_box[byte_of(w[c3], 3)] << 24);
  }
}

__global__ void __launch_bounds__(kThreads)
aes_ecb_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
               const uint8_t* __restrict__ round_keys,
               const uint8_t* __restrict__ sbox, long long n, int decrypt) {
  __shared__ uint32_t s_box[256];
  __shared__ uint32_t s_rk[44];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_box[i] = sbox[i];
  for (int i = threadIdx.x; i < 44; i += blockDim.x) {
    const uint8_t* k = round_keys + 4 * i;
    s_rk[i] = uint32_t(k[0]) | (uint32_t(k[1]) << 8) |
              (uint32_t(k[2]) << 16) | (uint32_t(k[3]) << 24);
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < n;
       b += stride) {
    const uint4 v = in[b];
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t t[4];
    if (!decrypt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] ^= s_rk[c];
#pragma unroll
      for (int r = 1; r < 10; ++r) {
        sub_shift<false>(s_box, w, t);
#pragma unroll
        for (int c = 0; c < 4; ++c) w[c] = mix(t[c]) ^ s_rk[4 * r + c];
      }
      sub_shift<false>(s_box, w, t);
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = t[c] ^ s_rk[40 + c];
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] ^= s_rk[40 + c];
#pragma unroll
      for (int r = 9; r > 0; --r) {
        sub_shift<true>(s_box, w, t);
#pragma unroll
        for (int c = 0; c < 4; ++c) w[c] = inv_mix(t[c] ^ s_rk[4 * r + c]);
      }
      sub_shift<true>(s_box, w, t);
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = t[c] ^ s_rk[c];
    }
    out[b] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

}  // namespace

extern "C" {

// in/out: n blocks of 16 bytes, 16-byte aligned.  round_keys: (11, 16)
// uint8.  sbox: 256 uint8 (the inverse S-box when decrypting).
int aes_ecb_launch(const void* in, void* out, const void* round_keys,
                   const void* sbox, long long n, int decrypt, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;   // grid-stride beyond
  aes_ecb_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, (const uint8_t*)round_keys,
      (const uint8_t*)sbox, n, decrypt);
  return (int)cudaGetLastError();
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
