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
// packet's beats spread over warps and blocks.  A block stages the MLP's
// weights (dpi_mma.cuh's image, built by the host) by one bulk copy, and
// while it comes in, the AES decrypt schedule and 32 copies of the inverse
// T-table and InvS-box (aes_round.cuh, from the image the host builds);
// then per tile:
//   1. AES: the tile's 64 16-byte blocks (its ciphertext double-buffered
//      by cp.async), decrypted by aes_round.cuh's rounds, the same device
//      code as aes_ecb.cu: table lookups free of bank conflicts.  The
//      plaintext is stored to device memory once and kept in shared
//      memory for the MLP: the bytes never make a second trip.
//   2. The MLP of dpi_mma.cuh on the tensor cores: the same device code
//      as dpi_mlp.cu, so a beat scores the same bits in both kernels.
//   3. The max per packet over the tile's rows, then one atomic max per
//      packet and tile into scores.  Max is exact, so the result does not
//      depend on which warp gets there first.
// A block is 16 warps, one an SM (the 64 KB of table copies serve the
// block; ~120 registers a thread allow no more warps).  A large launch
// gives each warp whole tiles.  A launch whose tiles the grid's warps
// could take two at a time, such as the 2-packet tile of the secure
// ingest (8 tiles), gives each tile a pair of warps instead: each decrypts
// 32 of the blocks and computes half of layer 2, and rank 1 hands its half
// of layer 3 to rank 0 through shared memory.  Tiles are dealt across the
// blocks of the grid before a block's next warp (pair) gets one, and the
// grid is a block a tile up to one an SM, so a launch of a few hundred
// tiles spreads over every SM.
//
// Bound on the H100: operations, the MLP's on the tensor cores.  Per beat
// 16,384 int8 ops (1,979 TOP/s) + 3 x 16,384 bf16 FLOP (989 TFLOP/s), and
// 128 fp32 FLOP on the CUDA cores, against 64 B read + 64 B written per
// beat (+4 B per packet): 0.030 ms of MLP against 0.020 ms of bytes at
// 8192 x 4 KiB.  This design's AES adds 4 x 160 table lookups a beat (one
// 32-lane shared-memory wavefront an SM a cycle), 0.040 ms, on a pipe of
// their own: the design's floor is the larger, 0.040 ms.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "aes_round.cuh"
#include "dpi_mma.cuh"
#include "grid.cuh"

namespace {

// dynamic shared memory layout, in 32-bit words after the staged weights
constexpr int kRk = dpi::kWeightWords;           // the decrypt schedule, 44
constexpr int kTab = kRk + aes::kRkWords;        // the tables' copies
static_assert(kTab % 4 == 0, "the copies must be 16-byte aligned");
constexpr int kPt = kTab + aes::kTableWords;     // then per warp: a plaintext
constexpr int kCtBytes = 2 * 32 * 16;            // and 2 x its lanes' blocks
constexpr int kWarpBytes = dpi::kTileBytes + 2 * kCtBytes;
constexpr int kWarps = 16;                       // a block, one an SM
constexpr int kSmemBytes = kPt * 4 + kWarps * kWarpBytes;   // 144,592
static_assert(kSmemBytes + 1024 <= 233472,
              "a block fits in an SM's 228 KB of shared memory");

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

__global__ void __launch_bounds__(kWarps * 32, 1)
fused_chain_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                   float* __restrict__ scores,
                   const uint32_t* __restrict__ round_keys,
                   const uint32_t* __restrict__ aes_image,
                   const uint8_t* __restrict__ image, long long n_pkts,
                   int mtu, int paired) {
  extern __shared__ __align__(16) uint32_t sm[];
  const uint32_t* s_rk = sm + kRk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // paired: two warps a tile (rank 0 and 1), each decrypting half of it
  // and computing half of layer 2; else one warp a tile, rank 0
  const int per_tile = paired ? 2 : 1, rank = paired ? warp & 1 : 0;
  uint8_t* pts = reinterpret_cast<uint8_t*>(sm + kPt);
  uint8_t* pt = pts + (warp - rank) * dpi::kTileBytes;
  // a pair's second plaintext slot carries rank 1's half of layer 3
  float2* share = reinterpret_cast<float2*>(pt + dpi::kTileBytes);
  uint4* ct = reinterpret_cast<uint4*>(pts + kWarps * dpi::kTileBytes +
                                       warp * 2 * kCtBytes);

  const int beats = mtu / 64;                    // per packet
  const long long n_beats = n_pkts * beats;
  const long long n_tiles = (n_beats + dpi::kRows - 1) / dpi::kRows;
  const long long stride = (long long)gridDim.x * (kWarps / per_tile);
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
  // the warp's (pair's) first tile: its slot in the block x grid + block
  long long t = (long long)(warp / per_tile) * gridDim.x + blockIdx.x;
  if (t < n_tiles) load(t, 0);                   // in flight while staging
  dpi::cp_async_commit();
  dpi::Copies c(sm);
  if (tid == 0) {
    c.start(dpi::kImageBytes);
    c.copy(sm, image, dpi::kImageBytes);
  }
  // the AES tables and schedule while the weights come in
  aes::stage_round_keys<true>(sm + kRk, round_keys, tid, blockDim.x);
  aes::stage_tables<kWarps>(sm + kTab, aes_image, tid, kWarps * 32);
  __syncthreads();                               // and the mbarrier is set up
  c.wait();
  const dpi::Weights w = dpi::weights_at(sm);
  const aes::Tables tb(sm + kTab, lane);

  for (int st = 0; t < n_tiles; t += stride, st ^= 1) {
    const long long beat0 = t * dpi::kRows;
    if (t + stride < n_tiles) load(t + stride, st ^ 1);
    dpi::cp_async_commit();
    dpi::cp_async_wait<1>();                     // this tile's blocks are in
    // ---- AES decrypt, both of a lane's blocks before either is stored, so
    // that the two round chains overlap
    uint4 p[2];
    if (n_mine == 2) {
      p[0] = ct[st * 64 + lane];
      p[1] = ct[st * 64 + 32 + lane];
      aes::crypt<true, 2>(p, tb, s_rk);
    } else {
      uint4 q[1] = {ct[st * 64 + lane]};
      aes::crypt<true, 1>(q, tb, s_rk);
      p[0] = q[0];
    }
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
// round_keys: the (11, 16) uint8 schedule, read as 44 words on the card
// at every launch; aes_image: the decrypt direction's aes::kImageWords
// table words (kernels/aes_ecb.py:table_image); image: the weight image
// (dpi::kImageBytes, see dpi_mma.cuh).  Every array 16-byte aligned.  The
// SM count and the resident blocks are looked up once per device.
int fused_chain_launch(const void* in, void* out, void* scores,
                       const void* round_keys, const void* aes_image,
                       const void* image, long long n_pkts, int mtu,
                       void* stream) {
  static int per_sm[grid::kMaxDevices] = {};     // 0: not looked up yet
  if (n_pkts <= 0) return 0;
  if (mtu <= 0 || mtu % 64) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = grid::current_device(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm[dev] == 0) {
    err = grid::blocks_per_sm(fused_chain_kernel, kWarps * 32, kSmemBytes,
                              kSmemBytes, &per_sm[dev]);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  // the identity of atomic_max_score
  err = cudaMemsetAsync(scores, 0xff, n_pkts * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  // Pair the warps while the grid's warps can take every tile two at a
  // time, so that each warp decrypts and scores half as much.  A block a
  // tile up to one an SM; past the slots of one block an SM, the
  // resident blocks.
  const long long n_tiles =
      (n_pkts * (mtu / 64) + dpi::kRows - 1) / dpi::kRows;
  const int paired = 2 * n_tiles <= (long long)kWarps * sms;
  const long long slots = (long long)sms * (kWarps / (paired ? 2 : 1));
  const long long blocks = n_tiles <= sms ? n_tiles
                           : n_tiles <= slots ? sms
                                              : (long long)per_sm[dev] * sms;
  fused_chain_kernel<<<(unsigned)blocks, kWarps * 32, kSmemBytes, s>>>(
      (const uint4*)in, (uint4*)out, (float*)scores,
      (const uint32_t*)round_keys, (const uint32_t*)aes_image,
      (const uint8_t*)image, n_pkts, mtu, paired);
  return (int)cudaGetLastError();
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
