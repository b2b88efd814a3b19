// The ternary DPI MLP (64 -> 128 -> 64 -> 1, ReLU) on Hopper's tensor
// cores, shared by dpi_mlp.cu and fused_chain.cu.
//
// One warp scores a tile of 16 beats (64-byte rows in shared memory,
// kRowBytes apart) with mma.sync, and every beat's score depends only on
// its own 64 bytes: whichever kernel, block, warp or tile row computes it,
// the bits are the same.
//
//   Layer 1, exact in int8.  x = byte/128 - 1, so 128*x = byte - 128: the
//   byte with its top bit flipped, read as s8.  With w1 ternary (any s8
//   works) m16n8k32 s8 x s8 -> s32 gives sum_k (byte_k - 128) * w1[k][u]
//   exactly (|sum| <= 8192), and h1 = max(float(sum) * (s1/128) + b1, 0)
//   rounds once: float(sum) and s1/128 are exact.
//   Layer 2, exact products in bf16.  w2 is ternary, so exact in bf16;
//   h1 (fp32, 24 significant bits) splits exactly into hi + mid + lo, three
//   bf16 values of 8 bits each (the two subtractions are exact in fp32).
//   Three m16n8k16 bf16 MMAs per tile accumulate hi*w2, mid*w2 and lo*w2 in
//   fp32: the products are exact, only the accumulation rounds.  Then
//   h2 = max(acc * s2 + b2, 0).  Not fp16 (its range is too narrow for h1)
//   and not fp8 (the split would no longer be exact).
//   Layer 3, fp32 FMA: for each half of h2's 64 columns a lane sums its 8
//   of them times w3 * s3, two xor shuffles add the four lanes of a row,
//   and the two halves are added last (see tile_halves).
//
// The layer-1 accumulator of n-tiles 2c and 2c+1 is, lane for lane, the
// A fragment of layer 2's k-chunk c, so h1 never leaves registers: per
// 16 hidden units, 4 int8 MMAs, the split, then 24 bf16 MMAs (8 n-tiles x
// 3 pieces) into 32 fp32 accumulators.
//
// The weights reach shared memory as one image of kImageBytes that the
// host builds once per weight set (kernels/dpi_mlp.py:weight_image): w1 as
// s8 (8 KiB) and w2 as bf16 (16 KiB), both in the order of the MMA's B
// fragments, each lane reading one 8-byte uint2 a fragment (conflict-
// free); then b1, b2 and w3 * s3 (the plain version's product) in fp32,
// s1 / 128 and s2.  A block copies it in with one bulk copy.  A beat row
// is 64 bytes padded to 80, so the A-fragment loads of a warp (8 rows x 4
// words) hit 32 distinct banks.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dpi {

constexpr int kH1 = 128, kH2 = 64;              // hidden widths; a beat is 64 B
constexpr int kRows = 16;                        // beats per warp tile
constexpr int kRowBytes = 80;                    // 64 B of beat + 16 B pad
constexpr int kTileBytes = kRows * kRowBytes;    // 1280
constexpr int kWarps = 4;                        // per block
constexpr int kBlocksPerSm = 4;

// the weight image, offsets in 32-bit words
constexpr int kW1 = 0;                           // [ks 2][j 16][lane 32][2] s8x4
constexpr int kW2 = kW1 + 2 * 16 * 32 * 2;       // [kc 8][n 8][lane 32][2] bf16x2
constexpr int kB1 = kW2 + 8 * 8 * 32 * 2;        // b1, 128 fp32
constexpr int kB2 = kB1 + kH1;                   // b2, 64 fp32
constexpr int kW3 = kB2 + kH2;                   // w3 * s3, 64 fp32
constexpr int kScales = kW3 + kH2;               // s1 / 128, s2, 0, 0
constexpr int kImageWords = kScales + 4;
constexpr uint32_t kImageBytes = kImageWords * 4;   // 25,616
constexpr int kBar = kImageWords;                // then the staging's mbarrier
constexpr int kWeightWords = kBar + 4;
constexpr int kWeightBytes = kWeightWords * 4;   // 25,632
static_assert(kWeightBytes % 16 == 0, "keeps what follows 16-byte aligned");

struct Weights {
  const uint2* w1;
  const uint2* w2;
  const float* b1;
  const float* b2;
  const float* w3;
  float s1q;                                     // s1 / 128
  float s2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the memory clobber keeps the compiler from reading the copied bytes
// before the wait
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One bulk copy engine request (TMA, no tensor map): bytes, a multiple of
// 16, from global to shared, both 16-byte aligned; completion is counted
// on the mbarrier bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The staging of a block: one thread starts bulk copies of everything the
// block needs (the weight image first), all at once, and every thread
// waits for them, so a block waits about one memory latency however few
// threads it has:
//   Copies c(sm);
//   if (tid == 0) { c.start(total_bytes); c.copy(...); ... }
//   __syncthreads();        // the mbarrier is initialised
//   c.wait();
struct Copies {
  uint64_t* bar;
  __device__ explicit Copies(uint32_t* sm)
      : bar(reinterpret_cast<uint64_t*>(sm + kBar)) {}
  __device__ void start(uint32_t total_bytes) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bar)),
        "r"(total_bytes)
        : "memory");
  }
  __device__ void copy(void* dst, const void* src, uint32_t n) {
    bulk_copy(dst, src, n, bar);
  }
  __device__ void wait() {
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(bar))
          : "memory");
  }
};

__device__ __forceinline__ Weights weights_at(const uint32_t* sm) {
  const float* f = reinterpret_cast<const float*>(sm);
  return Weights{reinterpret_cast<const uint2*>(sm + kW1),
                 reinterpret_cast<const uint2*>(sm + kW2), f + kB1, f + kB2,
                 f + kW3, f[kScales], f[kScales + 1]};
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + mid + lo exactly (and y likewise), as bf16x2 words
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = __fsub_rn(x, hf.x), ry = __fsub_rn(y, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(rx, mf.x), __fsub_rn(ry, mf.y));
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}

// The MLP on the 16 beats at rows (shared memory, kRowBytes apart), for
// the halves H0 .. H0 + NH - 1 of layer 2's output (half h: n-tiles 4h ..
// 4h + 3, 32 columns of h2); all 32 lanes of a warp call it.  y[i] is
// half H0 + i's share of layer 3, for rows g (.x) and g + 8 (.y) of lane
// 4g + t, summed over the four lanes of a row (they hold the same bits).
// A beat's score is y(half 0) + y(half 1), in that order, whether one warp
// computes both halves (tile_scores) or two warps one half each.
template <int H0, int NH>
__device__ __forceinline__ void tile_halves(const uint8_t* rows,
                                            const Weights& w, int lane,
                                            float2 (&y)[NH]) {
  constexpr int N0 = 4 * H0, NN = 4 * NH;
  const int g = lane >> 2, tig = lane & 3;
  // layer-1 A fragments (k-steps of 32 bytes), the sign bit flipped
  uint32_t a1[2][4];
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(rows + g * kRowBytes);
  const uint32_t* r8 =
      reinterpret_cast<const uint32_t*>(rows + (g + 8) * kRowBytes);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    a1[ks][0] = r0[8 * ks + tig] ^ 0x80808080u;
    a1[ks][1] = r8[8 * ks + tig] ^ 0x80808080u;
    a1[ks][2] = r0[8 * ks + 4 + tig] ^ 0x80808080u;
    a1[ks][3] = r8[8 * ks + 4 + tig] ^ 0x80808080u;
  }
  float acc2[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[n][e] = 0.0f;

#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    uint32_t ahi[4], amid[4], alo[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {                // layer-1 n-tile 2kc + h
      const int j = 2 * kc + h;
      int acc[4] = {0, 0, 0, 0};
      mma_s8(acc, a1[0], w.w1[j * 32 + lane]);
      mma_s8(acc, a1[1], w.w1[(16 + j) * 32 + lane]);
      const float2 b = *reinterpret_cast<const float2*>(w.b1 + 8 * j + 2 * tig);
      const float h00 = fmaxf(fmaf(float(acc[0]), w.s1q, b.x), 0.0f);
      const float h01 = fmaxf(fmaf(float(acc[1]), w.s1q, b.y), 0.0f);
      const float h80 = fmaxf(fmaf(float(acc[2]), w.s1q, b.x), 0.0f);
      const float h81 = fmaxf(fmaf(float(acc[3]), w.s1q, b.y), 0.0f);
      // row g -> A register 2h, row g + 8 -> 2h + 1
      split3(h00, h01, ahi[2 * h], amid[2 * h], alo[2 * h]);
      split3(h80, h81, ahi[2 * h + 1], amid[2 * h + 1], alo[2 * h + 1]);
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int nt = N0 + n;
      const uint2 b = w.w2[(kc * 8 + nt) * 32 + lane];
      mma_bf16(acc2[n], ahi, b);
      mma_bf16(acc2[n], amid, b);
      mma_bf16(acc2[n], alo, b);
    }
  }

#pragma unroll
  for (int i = 0; i < NH; ++i) {
    float y0 = 0.0f, y8 = 0.0f;
#pragma unroll
    for (int n = 4 * i; n < 4 * i + 4; ++n) {
      const int col = 8 * (N0 + n) + 2 * tig;
      const float2 b = *reinterpret_cast<const float2*>(w.b2 + col);
      const float2 v = *reinterpret_cast<const float2*>(w.w3 + col);
      y0 = fmaf(fmaxf(fmaf(acc2[n][0], w.s2, b.x), 0.0f), v.x, y0);
      y0 = fmaf(fmaxf(fmaf(acc2[n][1], w.s2, b.y), 0.0f), v.y, y0);
      y8 = fmaf(fmaxf(fmaf(acc2[n][2], w.s2, b.x), 0.0f), v.x, y8);
      y8 = fmaf(fmaxf(fmaf(acc2[n][3], w.s2, b.y), 0.0f), v.y, y8);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      y0 += __shfl_xor_sync(0xffffffffu, y0, off);
      y8 += __shfl_xor_sync(0xffffffffu, y8, off);
    }
    y[i] = make_float2(y0, y8);
  }
}

// The scores of the 16 beats at rows, by one warp: lane 4g + t returns
// rows g (.x) and g + 8 (.y).
__device__ __forceinline__ float2 tile_scores(const uint8_t* rows,
                                              const Weights& w, int lane) {
  float2 y[2];
  tile_halves<0, 2>(rows, w, lane, y);
  return make_float2(y[0].x + y[1].x, y[0].y + y[1].y);
}

// Blocks of `warps` warps for `units` warps' worth of work: one block per
// `warps` units, persistent beyond kBlocksPerSm blocks an SM.
inline long long grid_blocks(long long units, int warps, int sms) {
  const long long b = (units + warps - 1) / warps;
  const long long resident = (long long)kBlocksPerSm * sms;
  return b > resident ? resident : b;
}

}  // namespace dpi
