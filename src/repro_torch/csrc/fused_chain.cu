// Fused receive chain for Hopper (sm_90a): AES-128-ECB decrypt, then the
// ternary DPI MLP (64 -> 128 -> 64 -> 1, ReLU) on the decrypted bytes, in
// one pass.  Returns the plaintext and, per packet, the MAX score over
// every 64-byte beat of the MTU (not masked by a packet length).
//
// Replaces the TPU kernel src/repro/kernels/fused_chain.py:
// fused_decrypt_dpi_pallas (body _fused_kernel), which decrypts a
// 16-packet VMEM tile with whole-tile gathers and runs the three layers
// as MXU dots on it.  Here a persistent block (two per SM) stages the
// inverse S-box, the round keys and the DPI weights (pre-scaled to
// float32, as dpi_mlp.cu does) in shared memory once, then walks over
// packets.  Each packet goes through in chunks of 64 beats (4 KiB, the
// whole packet at the 4096-byte MTU):
//   1. AES: 256 threads, one 16-byte block each, the round structure of
//      aes_ecb.cu (state as four 32-bit column words in registers).  The
//      plaintext is stored to device memory once and kept in shared
//      memory for the MLP: the bytes never make a second trip.
//   2. Layer 1: a 64 x 128 output tile, each thread 4 beats x 8 hidden
//      units in registers (32 accumulators), x = byte/128 - 1 formed on
//      the fly from the shared plaintext, weights read as float4.  h1
//      goes to shared memory beat-minor ([unit][beat]).
//   3. Layers 2 and 3: each thread 4 beats x 4 units of h2 (16
//      accumulators), ReLU, times w3, summed across the 16 threads of a
//      half-warp by shuffles; then the block's max over valid beats.
// No thread holds a whole beat's 64 inputs and 64 outputs at once, as
// dpi_mlp.cu's one-thread-per-beat layout does (255 registers and a
// spill there): the register tile here is 32 floats, and the AES state
// is dead before the MLP starts.
//
// Bound on the H100: operations.  2 x 16,448 FLOP per beat in float32
// FMA on the CUDA cores (67 TFLOP/s) against 64 B read + 64 B written per
// beat (+4 B per packet): about 257 FLOP per byte, above the card's
// balance point.  No tensor cores: TF32 would give up the precision the
// scores are held to (1e-5 against the float32 plain version).
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkBeats = 64;                  // 4 KiB of payload
constexpr int kChunkBlocks = kChunkBeats * 4;    // 16-byte AES blocks
constexpr int kIn = 64, kH1 = 128, kH2 = 64;
constexpr int kBlocksPerSm = 2;

// dynamic shared memory layout, in floats / words
constexpr int kW1 = 0;                           // [k][u] = w1[k][u] * s1
constexpr int kW2 = kW1 + kIn * kH1;             // [k][u] = w2[k][u] * s2
constexpr int kH1T = kW2 + kH1 * kH2;            // [u][beat] layer-1 out
constexpr int kW3 = kH1T + kH1 * kChunkBeats;    // [u] = w3[u][0] * s3
constexpr int kB1 = kW3 + kH2;
constexpr int kB2 = kB1 + kH1;
constexpr int kBox = kB2 + kH2;                  // inverse S-box, 256 u32
constexpr int kRk = kBox + 256;                  // round keys, 44 u32
constexpr int kWmax = kRk + 44;                  // per-warp maxima, 8
constexpr int kPt = kWmax + 12;                  // plaintext chunk, 4 KiB
constexpr int kSmemBytes = (kPt + kChunkBlocks * 4) * 4;
static_assert(kPt % 4 == 0, "the plaintext chunk must be 16-byte aligned");

__device__ __forceinline__ uint32_t xt4(uint32_t x) {
  // GF(2^8) xtime on the four bytes of x independently
  return ((x & 0x7f7f7f7fu) << 1) ^ (((x >> 7) & 0x01010101u) * 0x1bu);
}

// byte r of the result is byte (r + k/8) % 4 of x
__device__ __forceinline__ uint32_t rot(uint32_t x, int k) {
  return __funnelshift_r(x, x, k);
}

__device__ __forceinline__ uint32_t mix(uint32_t a) {
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

// InvSubBytes + InvShiftRows: row r of column c comes from column c - r
__device__ __forceinline__ void inv_sub_shift(const uint32_t* s_box,
                                              const uint32_t (&w)[4],
                                              uint32_t (&o)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    o[c] = s_box[byte_of(w[c], 0)] |
           (s_box[byte_of(w[(c + 3) & 3], 1)] << 8) |
           (s_box[byte_of(w[(c + 2) & 3], 2)] << 16) |
           (s_box[byte_of(w[(c + 1) & 3], 3)] << 24);
  }
}

__device__ __forceinline__ uint4 aes_decrypt_block(uint4 v,
                                                   const uint32_t* s_box,
                                                   const uint32_t* s_rk) {
  uint32_t w[4] = {v.x ^ s_rk[40], v.y ^ s_rk[41], v.z ^ s_rk[42],
                   v.w ^ s_rk[43]};
  uint32_t t[4];
#pragma unroll
  for (int r = 9; r > 0; --r) {
    inv_sub_shift(s_box, w, t);
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = inv_mix(t[c] ^ s_rk[4 * r + c]);
  }
  inv_sub_shift(s_box, w, t);
  return make_uint4(t[0] ^ s_rk[0], t[1] ^ s_rk[1], t[2] ^ s_rk[2],
                    t[3] ^ s_rk[3]);
}

// x = byte / 128 - 1, exactly the plain version's value
__device__ __forceinline__ float beat_input(uint32_t word, int r) {
  return fmaf(float(byte_of(word, r)), 0.0078125f, -1.0f);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fused_chain_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                   float* __restrict__ scores,
                   const uint8_t* __restrict__ round_keys,
                   const uint8_t* __restrict__ inv_sbox,
                   const int8_t* __restrict__ w1, const float* __restrict__ b1,
                   const int8_t* __restrict__ w2, const float* __restrict__ b2,
                   const int8_t* __restrict__ w3,
                   const float* __restrict__ s1p,
                   const float* __restrict__ s2p,
                   const float* __restrict__ s3p, long long n_pkts,
                   int mtu) {
  extern __shared__ __align__(16) float sm[];
  float* w1s = sm + kW1;
  float* w2s = sm + kW2;
  float* h1t = sm + kH1T;
  float* w3s = sm + kW3;
  float* b1s = sm + kB1;
  float* b2s = sm + kB2;
  uint32_t* s_box = reinterpret_cast<uint32_t*>(sm + kBox);
  uint32_t* s_rk = reinterpret_cast<uint32_t*>(sm + kRk);
  float* wmax = sm + kWmax;
  uint4* pt4 = reinterpret_cast<uint4*>(sm + kPt);
  const uint32_t* pt32 = reinterpret_cast<const uint32_t*>(sm + kPt);

  const int tid = threadIdx.x;
  {
    const float s1 = *s1p, s2 = *s2p, s3 = *s3p;
    for (int i = tid; i < kIn * kH1; i += kThreads) {
      w1s[i] = float(w1[i]) * s1;                // w1 is (64, 128)
      w2s[i] = float(w2[i]) * s2;                // w2 is (128, 64)
    }
    for (int i = tid; i < kH1; i += kThreads) b1s[i] = b1[i];
    for (int i = tid; i < kH2; i += kThreads) {
      b2s[i] = b2[i];
      w3s[i] = float(w3[i]) * s3;
    }
    for (int i = tid; i < 256; i += kThreads) s_box[i] = inv_sbox[i];
    for (int i = tid; i < 44; i += kThreads) {
      const uint8_t* k = round_keys + 4 * i;
      s_rk[i] = uint32_t(k[0]) | (uint32_t(k[1]) << 8) |
                (uint32_t(k[2]) << 16) | (uint32_t(k[3]) << 24);
    }
  }
  __syncthreads();

  const int bg = tid >> 4;            // beat group: beats 4bg .. 4bg+3
  const int ug = tid & 15;            // unit group
  const int lane = tid & 31, warp = tid >> 5;
  const int beats = mtu / 64;
  const long long blocks_per_pkt = mtu / 16;
  const float4* w1s4 = reinterpret_cast<const float4*>(w1s);
  const float4* w2s4 = reinterpret_cast<const float4*>(w2s);
  const float4* h1t4 = reinterpret_cast<const float4*>(h1t);

  for (long long pkt = blockIdx.x; pkt < n_pkts; pkt += gridDim.x) {
    float run_max = -CUDART_INF_F;                 // read by thread 0
    for (int beat0 = 0; beat0 < beats; beat0 += kChunkBeats) {
      const int nb = min(kChunkBeats, beats - beat0);
      // ---- 1. AES decrypt: one 16-byte block per thread ------------------
      if (tid < 4 * nb) {
        const long long blk = pkt * blocks_per_pkt + 4LL * beat0 + tid;
        const uint4 p = aes_decrypt_block(in[blk], s_box, s_rk);
        out[blk] = p;
        pt4[tid] = p;
      }
      __syncthreads();

      // ---- 2. layer 1: 4 beats x 8 units per thread ----------------------
      // units ug*4 .. ug*4+3 and 64 + ug*4 .. 64 + ug*4+3, so that the
      // 16 threads of a half-warp read 16 consecutive float4s
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      for (int k4 = 0; k4 < kIn / 4; ++k4) {
        uint32_t xw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xw[i] = pt32[(4 * bg + i) * 16 + k4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = 4 * k4 + kk;
          const float4 wa = w1s4[k * (kH1 / 4) + ug];
          const float4 wb = w1s4[k * (kH1 / 4) + 16 + ug];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = beat_input(xw[i], kk);
            acc[i][0] = fmaf(x, wa.x, acc[i][0]);
            acc[i][1] = fmaf(x, wa.y, acc[i][1]);
            acc[i][2] = fmaf(x, wa.z, acc[i][2]);
            acc[i][3] = fmaf(x, wa.w, acc[i][3]);
            acc[i][4] = fmaf(x, wb.x, acc[i][4]);
            acc[i][5] = fmaf(x, wb.y, acc[i][5]);
            acc[i][6] = fmaf(x, wb.z, acc[i][6]);
            acc[i][7] = fmaf(x, wb.w, acc[i][7]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = (j < 4) ? 4 * ug + j : 64 + 4 * ug + (j - 4);
        const float b = b1s[u];
        reinterpret_cast<float4*>(h1t + u * kChunkBeats)[bg] = make_float4(
            fmaxf(acc[0][j] + b, 0.0f), fmaxf(acc[1][j] + b, 0.0f),
            fmaxf(acc[2][j] + b, 0.0f), fmaxf(acc[3][j] + b, 0.0f));
      }
      __syncthreads();

      // ---- 3. layers 2 and 3: 4 beats x 4 units per thread ---------------
      float acc2[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc2[i][j] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < kH1; ++k) {
        const float4 h = h1t4[k * (kChunkBeats / 4) + bg];
        const float4 w = w2s4[k * (kH2 / 4) + ug];
        const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc2[i][0] = fmaf(hv[i], w.x, acc2[i][0]);
          acc2[i][1] = fmaf(hv[i], w.y, acc2[i][1]);
          acc2[i][2] = fmaf(hv[i], w.z, acc2[i][2]);
          acc2[i][3] = fmaf(hv[i], w.w, acc2[i][3]);
        }
      }
      float y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = 4 * ug + j;
          y[i] = fmaf(fmaxf(acc2[i][j] + b2s[u], 0.0f), w3s[u], y[i]);
        }
        // sum over the 16 unit groups of this half-warp (same beats)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          y[i] += __shfl_xor_sync(0xffffffffu, y[i], off);
      }
      float m = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * bg + i < nb) m = fmaxf(m, y[i]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      if (lane == 0) wmax[warp] = m;
      __syncthreads();
      if (tid == 0) {
#pragma unroll
        for (int q = 0; q < kThreads / 32; ++q) run_max = fmaxf(run_max, wmax[q]);
      }
    }
    if (tid == 0) scores[pkt] = run_max;
  }
}

}  // namespace

extern "C" {

// in/out: n_pkts x mtu bytes, 16-byte aligned, mtu % 64 == 0.  scores:
// (n_pkts,) float32.  round_keys (11, 16) uint8; inv_sbox 256 uint8.  w1
// (64,128), w2 (128,64), w3 (64,1) int8; b1 (128,), b2 (64,) float32; s1,
// s2, s3 one float32 each.  The shared-memory opt-in and the SM count are
// looked up once per device, not on every launch.
int fused_chain_launch(const void* in, void* out, void* scores,
                       const void* round_keys, const void* inv_sbox,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* w3, const void* s1,
                       const void* s2, const void* s3, long long n_pkts,
                       int mtu, void* stream) {
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {0};          // 0: not configured yet
  if (n_pkts <= 0) return 0;
  if (mtu <= 0 || mtu % 64) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    err = cudaFuncSetAttribute(fused_chain_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev] = sms;
  }
  long long blocks = n_pkts;
  const long long resident = (long long)kBlocksPerSm * sms_of[dev];
  if (blocks > resident) blocks = resident;        // persistent grid
  fused_chain_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                       (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, (float*)scores,
      (const uint8_t*)round_keys, (const uint8_t*)inv_sbox,
      (const int8_t*)w1, (const float*)b1, (const int8_t*)w2,
      (const float*)b2, (const int8_t*)w3, (const float*)s1,
      (const float*)s2, (const float*)s3, n_pkts, mtu);
  return (int)cudaGetLastError();
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
