// Fused receive chain for Hopper (sm_90a): AES-128-ECB decrypt, then the
// ternary DPI MLP (64 -> 128 -> 64 -> 1, ReLU) on the decrypted bytes, in
// one pass.  Returns the plaintext and, per packet, the MAX score over
// every 64-byte beat of the MTU (not masked by a packet length).
//
// Replaces the TPU kernel src/repro/kernels/fused_chain.py:
// fused_decrypt_dpi_pallas (body _fused_kernel), which decrypts a
// 16-packet VMEM tile with whole-tile gathers and runs the three layers
// as MXU dots on it.  Here the payload is a flat run of beats cut into
// 16-beat tiles, whatever the MTU (64 to 8192 B and beyond), so a
// packet's beats spread over warps and blocks.  A block stages the
// inverse S-box, the round keys and the MLP's weights (dpi_mma.cuh) in
// shared memory once, by bulk copies (the S-box as 256 words and the
// weights as dpi_mma.cuh's image, both built by the host); then per tile:
//   1. AES: the tile's 64 16-byte blocks (its ciphertext double-buffered
//      by cp.async), the round structure of aes_ecb.cu (state as four
//      32-bit column words in registers).  The plaintext is stored to
//      device memory once and kept in shared memory for the MLP: the
//      bytes never make a second trip.  The S-box lookups keep
//      aes_ecb.cu's bank conflicts; they go with that kernel's redesign.
//   2. The MLP of dpi_mma.cuh on the tensor cores: the same device code
//      as dpi_mlp.cu, so a beat scores the same bits in both kernels.
//   3. The max per packet over the tile's rows, then one atomic max per
//      packet and tile into scores.  Max is exact, so the result does not
//      depend on which warp gets there first.
// A large launch gives each warp whole tiles (four warps a block, up to
// four blocks an SM).  A small one, such as the 2-packet tile of the
// secure ingest (8 tiles), gives each tile a pair of warps in a block of
// its own: each decrypts 32 of the blocks and computes half of layer 2,
// and rank 1 hands its half of layer 3 to rank 0 through shared memory.
//
// Bound on the H100: operations.  Per beat the MLP's 16,384 int8 ops
// (1,979 TOP/s) + 3 x 16,384 bf16 FLOP (989 TFLOP/s) + 128 fp32 FLOP
// against 64 B read + 64 B written per beat (+4 B per packet): 0.031 ms
// of operations against 0.020 ms of bytes at 8192 x 4 KiB.  AES's integer
// work is not in that figure; it has no data-sheet peak.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dpi_mma.cuh"

namespace {

// dynamic shared memory layout, in 32-bit words after the staged weights
constexpr int kBox = dpi::kWeightWords;          // inverse S-box, 256 u32
constexpr int kRk = kBox + 256;                  // round keys, 44 u32
constexpr int kPt = kRk + 44;                    // then per warp: a plaintext
static_assert(kPt % 4 == 0, "the tiles must be 16-byte aligned");
constexpr int kCtBytes = 2 * 32 * 16;            // and 2 x its lanes' blocks
constexpr int kWarpBytes = dpi::kTileBytes + 2 * kCtBytes;

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

// scores[pkt] = max(scores[pkt], v), exact, so the order of the atomics
// from different warps does not change the bits.  The launch fills scores
// with 0xff bytes (a negative NaN), which both branches replace: as an
// int it is -1, below any non-negative float; as an unsigned it is the
// largest, above any negative float.
__device__ __forceinline__ void atomic_max_score(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// The max of each packet over the rows of the tile at beat tb0, one
// atomic each; all 32 lanes of the warp that holds the scores y call it.
__device__ __forceinline__ void max_per_packet(float* scores, float2 y,
                                               long long tb0,
                                               long long n_beats, int beats,
                                               int lane) {
  const long long pkt0 = tb0 / beats;
  const long long last = min(tb0 + dpi::kRows, n_beats) - 1;
  if ((last / beats) == pkt0) {                  // one packet: a warp max
    const long long row = tb0 + (lane >> 2);     // rows g and g + 8
    float m = fmaxf(row <= last ? y.x : -CUDART_INF_F,
                    row + 8 <= last ? y.y : -CUDART_INF_F);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomic_max_score(scores + pkt0, m);
    return;
  }
  // packets end inside the tile: lane 0 walks the rows
  long long pkt = pkt0;
  int in_pkt = int(tb0 - pkt0 * beats);
  float m = -CUDART_INF_F;
#pragma unroll
  for (int r = 0; r < dpi::kRows; ++r) {
    const float v = __shfl_sync(0xffffffffu, r < 8 ? y.x : y.y, (r & 7) * 4);
    if (lane == 0 && tb0 + r <= last) {
      m = fmaxf(m, v);
      if (++in_pkt == beats || tb0 + r == last) {
        atomic_max_score(scores + pkt, m);
        m = -CUDART_INF_F;
        in_pkt = 0;
        ++pkt;
      }
    }
  }
}

// the two warps of a pair meet (named barrier 1 + pair; 0 is
// __syncthreads)
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

__global__ void __launch_bounds__(dpi::kWarps * 32, dpi::kBlocksPerSm)
fused_chain_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                   float* __restrict__ scores,
                   const uint32_t* __restrict__ round_keys,
                   const uint32_t* __restrict__ inv_sbox,
                   const uint8_t* __restrict__ image, long long n_pkts,
                   int mtu, int paired) {
  extern __shared__ __align__(16) uint32_t sm[];
  const uint32_t* s_box = sm + kBox;
  const uint32_t* s_rk = sm + kRk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  // paired: two warps a tile (rank 0 and 1), each decrypting half of it
  // and computing half of layer 2; else one warp a tile, rank 0
  const int per_tile = paired ? 2 : 1, rank = paired ? warp & 1 : 0;
  uint8_t* pts = reinterpret_cast<uint8_t*>(sm + kPt);
  uint8_t* pt = pts + (warp - rank) * dpi::kTileBytes;
  // a pair's second plaintext slot carries rank 1's half of layer 3
  float2* share = reinterpret_cast<float2*>(pt + dpi::kTileBytes);
  uint4* ct = reinterpret_cast<uint4*>(pts + warps * dpi::kTileBytes +
                                       warp * 2 * kCtBytes);

  const int beats = mtu / 64;                    // per packet
  const long long n_beats = n_pkts * beats;
  const long long n_tiles = (n_beats + dpi::kRows - 1) / dpi::kRows;
  const long long stride = (long long)gridDim.x * warps / per_tile;
  // a lane's 16-byte blocks of tile t: lane + 32 (h + rank), h < n_mine,
  // into stage st of its ciphertext buffer (zero past the end); the next
  // tile's come in while this one is decrypted and scored
  const int n_mine = 2 / per_tile;
  auto load = [&](long long t, int st) {
    for (int h = 0; h < n_mine; ++h) {
      const long long blk = 4 * t * dpi::kRows + lane + 32 * (h + rank);
      const bool valid = blk < 4 * n_beats;
      dpi::cp_async16(ct + st * 64 + 32 * h + lane, valid ? in + blk : in,
                      valid);
    }
  };
  long long t = ((long long)blockIdx.x * warps + warp) / per_tile;
  if (t < n_tiles) load(t, 0);                   // in flight while staging
  dpi::cp_async_commit();
  dpi::Copies c(sm);
  if (tid == 0) {
    c.start(dpi::kImageBytes + 256 * 4 + 44 * 4);
    c.copy(sm, image, dpi::kImageBytes);
    c.copy(sm + kBox, inv_sbox, 256 * 4);
    c.copy(sm + kRk, round_keys, 44 * 4);
  }
  __syncthreads();                               // the mbarrier is set up
  c.wait();
  const dpi::Weights w = dpi::weights_at(sm);

  for (int st = 0; t < n_tiles; t += stride, st ^= 1) {
    const long long beat0 = t * dpi::kRows;
    if (t + stride < n_tiles) load(t + stride, st ^ 1);
    dpi::cp_async_commit();
    dpi::cp_async_wait<1>();                     // this tile's blocks are in
    // ---- AES decrypt, both of a lane's blocks before either is stored, so
    // that the two round chains overlap
    uint4 p[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < n_mine)
        p[h] = aes_decrypt_block(ct[st * 64 + 32 * h + lane], s_box, s_rk);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h >= n_mine) break;
      const int c = lane + 32 * (h + rank), row = c >> 2;
      if (beat0 + row < n_beats) out[4 * beat0 + c] = p[h];
      else p[h] = make_uint4(0u, 0u, 0u, 0u);    // rows past the end: zero
      *reinterpret_cast<uint4*>(pt + row * dpi::kRowBytes + (c & 3) * 16) =
          p[h];
    }
    if (paired) pair_sync(warp >> 1); else __syncwarp();
    // ---- the MLP on the plaintext -----------------------------------------
    float2 y;
    if (!paired) {
      y = dpi::tile_scores(pt, w, lane);
    } else {
      float2 half[1];
      if (rank == 0) {
        dpi::tile_halves<0, 1>(pt, w, lane, half);
      } else {
        dpi::tile_halves<1, 1>(pt, w, lane, half);
        share[lane] = half[0];
      }
      pair_sync(warp >> 1);
      const float2 other = share[lane];          // used by rank 0 only
      y = make_float2(half[0].x + other.x, half[0].y + other.y);
    }
    // ---- rank 0: the max of each packet over this tile's rows
    if (rank == 0) max_per_packet(scores, y, beat0, n_beats, beats, lane);
    if (paired) pair_sync(warp >> 1); else __syncwarp();  // slots free again
  }
}

}  // namespace

extern "C" {

// in/out: n_pkts x mtu bytes, mtu % 64 == 0.  scores: (n_pkts,) float32.
// round_keys: the (11, 16) uint8 schedule, read as 44 words; inv_sbox:
// the inverse S-box as 256 uint32; image: the weight image
// (dpi::kImageBytes, see dpi_mma.cuh).  Every array 16-byte aligned.  The
// SM count is looked up once per device, not on every launch.
int fused_chain_launch(const void* in, void* out, void* scores,
                       const void* round_keys, const void* inv_sbox,
                       const void* image, long long n_pkts, int mtu,
                       void* stream) {
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {0};          // 0: not looked up yet
  if (n_pkts <= 0) return 0;
  if (mtu <= 0 || mtu % 64) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev] = sms;
  }
  // the identity of atomic_max_score
  err = cudaMemsetAsync(scores, 0xff, n_pkts * sizeof(float),
                        (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  // A launch too small to give every SM's tensor cores a tile of their own
  // (a 2-packet tile is 8 tiles) pairs the warps: two a tile, one pair a
  // block, so that each warp decrypts and scores half as much and the
  // blocks spread over as many SMs.
  const long long n_tiles =
      (n_pkts * (mtu / 64) + dpi::kRows - 1) / dpi::kRows;
  const int paired = 2 * n_tiles <= (long long)dpi::kWarps * sms_of[dev];
  const int warps = paired ? 2 : dpi::kWarps;
  const long long blocks =
      dpi::grid_blocks(n_tiles * (paired ? 2 : 1), warps, sms_of[dev]);
  fused_chain_kernel<<<(unsigned)blocks, warps * 32,
                       kPt * 4 + warps * kWarpBytes, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, (float*)scores,
      (const uint32_t*)round_keys, (const uint32_t*)inv_sbox,
      (const uint8_t*)image, n_pkts, mtu, paired);
  return (int)cudaGetLastError();
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
