// AES-128 rounds for Hopper (sm_90a), shared by aes_ecb.cu and the AES
// half of fused_chain.cu, so that both encrypt and decrypt the same way.
//
// A lane owns one 16-byte block as four 32-bit column words (byte r of
// column c at bits 8r of word c: the little-endian layout of the block's
// uint4).  A full round is the T-table form of SubBytes, ShiftRows and
// MixColumns: output column c is
//   T[s0] ^ rotl8(T[s1]) ^ rotl16(T[s2]) ^ rotl24(T[s3]) ^ k[c],
// where s_r is byte r of input column c + r (c - r when decrypting) and T
// is one table a direction:
//   Te0[x] = MixColumns of the column (S[x], 0, 0, 0) = (2S, S, S, 3S),
//   Td0[x] = InvMixColumns of (InvS[x], 0, 0, 0) = (14, 9, 13, 11) InvS.
// Both matrices are circulant, so the tables of rows 1-3 are Te0/Td0
// rotated by one, two and three bytes (one funnel shift each) instead of
// three more tables.  The last round has no MixColumns: it reads the
// plain S-box (InvS-box) and joins four bytes by two byte permutes.
// Decryption is FIPS-197's equivalent inverse cipher: the same round
// shape with round keys 1-9 passed through InvMixColumns, which a block
// computes from the key schedule when it stages it (stage_round_keys), on
// the card, so a schedule rewritten in place between launches is read
// anew.
//
// Lookups are data-dependent gathers from shared memory.  One table read
// by 32 lanes with random bytes lands up to ~3.5 deep in one of the 32
// banks, and the lookups then cost ~3.5x their wavefronts.  So the tables
// are replicated across the banks, in rows of 256 bytes, one row an entry
// e: 32 copies of T[e], then 32 copies of S[e] (the byte in the low 8
// bits).  Lane l reads copy l, so every lane reads its own bank, whatever
// the data, and one byte permute forms a lookup's whole offset,
// (byte << 8) | (lane << 2); the last round reads S at a fixed 128 bytes
// further.  The host builds the image of one direction once per device
// (kImageWords words: T, then S; kernels/aes_ecb.py:table_image), and a
// block writes the copies from it into shared memory (stage_tables): 2 KB
// read, 64 KB written, 16 bytes a store.
//
// Cost on the H100: 160 lookups a block, one 32-lane wavefront an SM a
// cycle, against 32 bytes of device memory a block: twice the bytes'
// time.  That is this design's floor, not the function's (a bitsliced
// AES makes no lookups).  A lookup costs two instructions (a permute and
// the load), plus a rotation on three rows of four and the XOR, so the
// issue rate stays near the lookups' rate.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace aes {

constexpr int kCopies = 32;                      // one a bank
constexpr int kImageWords = 2 * 256;             // T, then S
constexpr int kRkWords = 44;                     // 11 round keys x 4 words
// 32-bit words of shared memory the copies of the tables take (64 KB)
constexpr int kTableWords = 256 * 2 * kCopies;

__device__ __forceinline__ uint32_t xt4(uint32_t x) {
  // GF(2^8) xtime on the four bytes of x independently
  return ((x & 0x7f7f7f7fu) << 1) ^ (((x >> 7) & 0x01010101u) * 0x1bu);
}

// byte r of the result is byte r - k/8 of x (mod 4)
__device__ __forceinline__ uint32_t rotl(uint32_t x, int k) {
  return __funnelshift_l(x, x, k);
}

__device__ __forceinline__ uint32_t inv_mix(uint32_t a) {
  // InvMixColumns of one column: MixColumns after the pre-multiplication
  // a ^= xtime(xtime(a ^ rot16(a)))
  a ^= xt4(xt4(a ^ rotl(a, 16)));
  const uint32_t a1 = rotl(a, 24);
  return xt4(a ^ a1) ^ a1 ^ rotl(a, 16) ^ rotl(a, 8);
}

// The 44 words of the key schedule (round_keys: the (11, 16) uint8 bytes,
// 4-byte aligned) into s_rk; decrypting, words 4-39 through InvMixColumns.
template <bool kDecrypt>
__device__ __forceinline__ void stage_round_keys(
    uint32_t* s_rk, const uint32_t* __restrict__ round_keys, int tid,
    int threads) {
  for (int i = tid; i < kRkWords; i += threads) {
    const uint32_t k = __ldg(round_keys + i);
    s_rk[i] = (kDecrypt && i >= 4 && i < 40) ? inv_mix(k) : k;
  }
}

// The copies of the image (kImageWords words in device memory) into
// s_tab (kTableWords words, 16-byte aligned), by a block of at least
// kMinWarps warps.  Each warp loads 32 entries of the image a time, one a
// lane, all of its chunks at once, and hands them to its lanes by
// shuffles: a warp's 16-byte store writes 4 rows' copies of one part (T
// or S).
template <int kMinWarps>
__device__ __forceinline__ void stage_tables(uint32_t* s_tab,
                                             const uint32_t* __restrict__ image,
                                             int tid, int threads) {
  constexpr int kChunks = kImageWords / 32;      // 16
  constexpr int kMine = (kChunks + kMinWarps - 1) / kMinWarps;
  constexpr int kLanesARow = kCopies / 4;        // 16-byte stores a part
  constexpr int kRowsAStore = 32 / kLanesARow;
  const int lane = tid & 31, warp = tid >> 5, warps = threads >> 5;
  uint32_t v[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i)
    if (warp + i * warps < kChunks)
      v[i] = __ldg(image + (warp + i * warps) * 32 + lane);
  uint4* dst = reinterpret_cast<uint4*>(s_tab);
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int chunk = warp + i * warps;
    if (chunk >= kChunks) break;
    const int part = chunk >= kChunks / 2;       // 0: T, 1: S
    const int e0 = (chunk % (kChunks / 2)) * 32; // its first entry
#pragma unroll
    for (int k = 0; k < 32; k += kRowsAStore) {
      const int src = k + lane / kLanesARow;     // the lane holding it
      const uint32_t x = __shfl_sync(0xffffffffu, v[i], src);
      dst[((e0 + src) * 2 * kCopies + part * kCopies) / 4 +
          lane % kLanesARow] = make_uint4(x, x, x, x);
    }
  }
}

// A lane's view of the staged tables: the byte offset of its copies.
struct Tables {
  const char* base;                              // the tables, in shared
  uint32_t lane4;                                // 4 x lane
  __device__ __forceinline__ Tables(const uint32_t* s_tab, int lane)
      : base(reinterpret_cast<const char*>(s_tab)), lane4(lane * 4) {}
  // the byte offset of this lane's copy of row (byte r of w): byte 0
  // lane4, byte 1 byte r of w, then 0
  __device__ __forceinline__ uint32_t at(uint32_t w, int r) const {
    return __byte_perm(w, lane4, 0x5504u | (r << 4));
  }
  __device__ __forceinline__ uint32_t T(uint32_t w, int r) const {
    return *reinterpret_cast<const uint32_t*>(base + at(w, r));
  }
  __device__ __forceinline__ uint32_t S(uint32_t w, int r) const {
    return *reinterpret_cast<const uint32_t*>(base + at(w, r) +
                                              4 * kCopies);
  }
};

// the column that row r of output column c comes from
template <bool kDecrypt>
__device__ __forceinline__ int src(int c, int r) {
  return (kDecrypt ? c - r : c + r) & 3;
}

// N blocks, one round at a time for all of them, so that their lookups
// are in flight together.  s_rk: the staged schedule, 16-byte aligned.
template <bool kDecrypt, int N>
__device__ __forceinline__ void crypt(uint4 (&v)[N], const Tables& tb,
                                      const uint32_t* s_rk) {
  const uint4* rk = reinterpret_cast<const uint4*>(s_rk);
  uint32_t w[N][4], o[N][4];
  uint4 k = rk[kDecrypt ? 10 : 0];
#pragma unroll
  for (int b = 0; b < N; ++b) {
    w[b][0] = v[b].x ^ k.x;
    w[b][1] = v[b].y ^ k.y;
    w[b][2] = v[b].z ^ k.z;
    w[b][3] = v[b].w ^ k.w;
  }
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    k = rk[kDecrypt ? 10 - r : r];
    const uint32_t kc[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
    for (int b = 0; b < N; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[b][c] = tb.T(w[b][c], 0) ^
                  rotl(tb.T(w[b][src<kDecrypt>(c, 1)], 1), 8) ^
                  rotl(tb.T(w[b][src<kDecrypt>(c, 2)], 2), 16) ^
                  rotl(tb.T(w[b][src<kDecrypt>(c, 3)], 3), 24) ^ kc[c];
#pragma unroll
    for (int b = 0; b < N; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) w[b][c] = o[b][c];
  }
  // the last round: four S bytes into one word by two permutes
  k = rk[kDecrypt ? 0 : 10];
  const uint32_t kc[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
  for (int b = 0; b < N; ++b) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t s01 = __byte_perm(tb.S(w[b][c], 0),
                                       tb.S(w[b][src<kDecrypt>(c, 1)], 1),
                                       0x1140u);   // S0, S1, 0, 0
      const uint32_t s23 = __byte_perm(tb.S(w[b][src<kDecrypt>(c, 2)], 2),
                                       tb.S(w[b][src<kDecrypt>(c, 3)], 3),
                                       0x4011u);   // 0, 0, S2, S3
      o[b][c] = (s01 | s23) ^ kc[c];
    }
    v[b] = make_uint4(o[b][0], o[b][1], o[b][2], o[b][3]);
  }
}

}  // namespace aes
