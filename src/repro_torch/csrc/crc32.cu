// CRC32 (reflected polynomial 0xEDB88320, the Ethernet / RoCE ICRC) over
// payload[:plen] of every packet, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/crc32.py:crc32_pallas (body
// _crc_kernel).  That kernel walks the whole MTU of 64 packets a tile,
// slice-by-8, and at every step also runs a byte recurrence masked by
// plen.  A walk of one packet by one thread is bound by its latency: 512
// dependent steps for 4 KiB, whatever the batch.  Here a packet is split
// across a team of lanes and their partial CRCs are combined in GF(2).
//
// Notation: a CRC register is reflected (bit j the coefficient of
// x^(31-j)); Z(c) = c x^8 mod P advances it over one zero byte, and the
// raw CRC R(M) (initial value 0, no final XOR) is linear:
//   R(A || B) = Z^|B|(R(A)) ^ R(B),  Z^t(c) = c (x) x^(8t)   mod P.
//
// 1. A team a packet.  A team is T lanes, the fewest (a power of two, at
//    most a warp) that hold the row at 128 bytes a lane; lane l folds the
//    contiguous chunk [l C, (l + 1) C) with C = MTU / T rounded up to
//    whole loads (kernels/crc32.py:team): at MTU 4096 a warp a packet and
//    128 B a lane; at MTU 256 two lanes of 128 B and 16 packets a warp; at
//    MTU 64 one lane a packet.  The loads: a lane loading its own chunk
//    touches a different 128-byte line per lane, 32 lines for each 512 B
//    a warp instruction moves, 256 L1 wavefronts a 4 KiB packet beside
//    its 132 lookups; a first design that did so was slower at every
//    batch size (PERF.md section 6).  So a warp copies its
//    chunks' 128-byte pieces (one a
//    lane, a segment of each chunk at a time) into a buffer of its own in
//    shared memory with cp.async, whole pieces per instruction (4 lines
//    of 16-byte loads when base and MTU are 16-byte aligned, else 2 of
//    8-byte loads: MTU % 16 == 8, or a base 8 B past a boundary), the
//    16-byte columns of piece P swizzled to c ^ (P % 8) so that neither
//    the copies' stores nor a lane's 16-byte reads of its own piece
//    conflict.  A lane takes its piece into registers, the warp issues
//    the next segment's copies, then the lanes fold: one segment's copy
//    is in flight while the last one folds.  A copy is issued only if it
//    starts below its piece owner's plen, and chunks and MTU are whole
//    loads, so nothing past the row is read; bytes past plen in the last
//    load, and stale bytes of the buffer, are never folded.
// 2. The combine.  Lane l folds its min(C, plen - l C) bytes (never
//    negative) slice-by-4 from 0, except lane 0, which starts from
//    0xFFFFFFFF: the initial value is then carried by lane 0's term
//    through the same product and needs no fix-up of its own.  Let
//    q = plen / C and s = plen % C: lanes l < q hold full chunks followed
//    by t = (q - 1 - l) C + s bytes, lane q the ragged end (its last <= 3
//    bytes by the byte recurrence), lanes past q nothing (0).  Lanes l < q
//    multiply their CRC by x^(8t), read from a table the host builds per
//    (MTU, load size), laid out [s][k] so that a team's lanes read
//    consecutive words (kernels/crc32.py:powers).  The product is
//    carry-less: 16 integer products of operands masked to every fourth
//    bit (no carry crosses the three-bit holes), then the 63-bit result
//    shifted left by one is hi:lo with hi the reduced low part and lo
//    worth lo x^32 = Z^4(lo), one slice-by-4 step.  An XOR across the
//    team (__shfl_xor_sync) sums the terms; the final XOR ends it.
// 3. Lookups that never conflict.  Slice-by-4 tables T0..T3 (T_k[b] =
//    Z^(k+1)(b)), 32 copies each, one a bank, in rows of 256 bytes: row b
//    of the first 64 KB holds 32 copies of T3[b] then 32 of T2[b], of the
//    second T1[b] then T0[b].  Lane l reads copy l, so a warp's lookup is
//    one wavefront whatever the data, and one byte permute forms a
//    lookup's offset, (byte << 8) | (half << 7) | (lane << 2).  Slice-by-8
//    in 32 copies would take 256 KB, more than a block may hold; in 16
//    copies lanes l and l + 16 share a bank and a lookup takes about two
//    wavefronts.  One lookup a byte, plus four a multiply.
// 4. Tables staged once a block.  A block is 512 threads (16 warps), one
//    an SM beside its 128 KB of copies and 16 x 4 KB of buffers; the grid
//    is persistent, at most the resident blocks in passes of equal work
//    (grid.cuh:capped_blocks), so an 8192-packet batch stages 128 blocks x
//    128 KB from a 4 KB image, against 32 MiB of payload.
//
// Bound on the H100: bytes (the payload bytes below plen read once, 4 B of
// plen and 4 B of CRC a packet) at 3.35 TB/s; for phase 2 of
// chip_smoke.py (8192 x 4096, a quarter ragged) about 0.0088 ms.  The
// design's lookups (kernels/crc32.py:warp_lookups: 132 warp instructions
// a full 4 KiB packet, one wavefront each) at one wavefront an SM a cycle
// take about half of that, so the lookups stay under the bytes; the
// buffer's copies and reads add 64 wavefronts a packet.
#include <cstdint>
#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCopies = 32;                        // one a bank
constexpr int kSeg = 128;                          // bytes of a piece
constexpr int kSegWords = kSeg / 4;
constexpr int kHalfBytes = 256 * 2 * kCopies * 4;  // T3|T2 rows, then T1|T0
constexpr int kTableBytes = 2 * kHalfBytes;        // 128 KB
constexpr int kBufBytes = 32 * kSeg;               // a warp's 32 pieces
constexpr int kSmemBytes = kTableBytes + kWarps * kBufBytes;   // 192 KB
constexpr int kStores = (kTableBytes / 16 + kThreads - 1) / kThreads;

// A lane's view of the staged tables: the byte offsets of its copies.
struct Tables {
  const char* base;
  uint32_t lo, hi;    // its copy in a row's first and second half
  __device__ __forceinline__ Tables(const uint32_t* s, int lane)
      : base(reinterpret_cast<const char*>(s)), lo(4u * lane),
        hi(4u * kCopies + 4u * lane) {}
  __device__ __forceinline__ uint32_t at(uint32_t off) const {
    return *reinterpret_cast<const uint32_t*>(base + off);
  }
  // Z^4(c) = c x^32 mod P: T3[c0] ^ T2[c1] ^ T1[c2] ^ T0[c3].  Selector
  // 0x55r4: byte 0 the lane's offset, byte 1 byte r of c, then zeros
  __device__ __forceinline__ uint32_t fold4(uint32_t c) const {
    return at(__byte_perm(c, lo, 0x5504u)) ^ at(__byte_perm(c, hi, 0x5514u)) ^
           at(kHalfBytes + __byte_perm(c, lo, 0x5524u)) ^
           at(kHalfBytes + __byte_perm(c, hi, 0x5534u));
  }
  // one byte b (in the low byte) into crc: (crc >> 8) ^ T0[(crc ^ b) & 0xff]
  __device__ __forceinline__ uint32_t byte(uint32_t crc, uint32_t b) const {
    return (crc >> 8) ^ at(kHalfBytes + __byte_perm(crc ^ b, hi, 0x5504u));
  }
};

// The copies of image (T3, T2, T1, T0: 4 x 256 words) into s: word w of s
// is copy w % 32 of table 2 (w >> 14) + ((w >> 5) & 1), entry (w >> 6) %
// 256.  All of a thread's loads are in flight before its first store; a
// warp's store writes 512 contiguous bytes.
__device__ __forceinline__ void stage(uint32_t* s,
                                      const uint32_t* __restrict__ image) {
  constexpr int kQuads = kTableBytes / 16;
  uint32_t v[kStores];
#pragma unroll
  for (int j = 0; j < kStores; ++j) {
    const int w = 4 * min((int)threadIdx.x + j * kThreads, kQuads - 1);
    v[j] = __ldg(image + (2 * (w >> 14) + ((w >> 5) & 1)) * 256 +
                 ((w >> 6) & 255));
  }
  uint4* dst = reinterpret_cast<uint4*>(s);
#pragma unroll
  for (int j = 0; j < kStores; ++j)
    if ((int)threadIdx.x + j * kThreads < kQuads)
      dst[threadIdx.x + j * kThreads] = make_uint4(v[j], v[j], v[j], v[j]);
}

// The carry-less product of x and y: bit i the XOR of x_a y_b over
// a + b = i.  Operands masked to every fourth bit have at most 8 bits, so
// each bit of an integer product sums at most 8 pairs and no carry
// reaches the next bit of the same residue mod 4.
__device__ __forceinline__ unsigned long long clmul(uint32_t x, uint32_t y) {
  uint32_t xs[4], ys[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    xs[a] = x & (0x11111111u << a);
    ys[a] = y & (0x11111111u << a);
  }
  unsigned long long z[4] = {0, 0, 0, 0};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      z[(a + b) & 3] ^= (unsigned long long)xs[a] * ys[b];
  constexpr unsigned long long m = 0x1111111111111111ull;
  return (z[0] & m) | (z[1] & (m << 1)) | (z[2] & (m << 2)) |
         (z[3] & (m << 3));
}

// r (x) k mod P, both reflected.  clmul's bit i is the coefficient of
// x^(62-i); shifted left by one, its high word is the product's terms of
// degree < 32 and its low word lo stands for lo x^32 = Z^4(lo).
__device__ __forceinline__ uint32_t gf_mul(uint32_t r, uint32_t k,
                                           const Tables& tb) {
  const unsigned long long p = clmul(r, k) << 1;
  return (uint32_t)(p >> 32) ^ tb.fold4((uint32_t)p);
}

// A lane's share of the packet its team folds in group g (the packets
// g 32/T .. g 32/T + 32/T - 1 of a warp).
struct Share {
  long long p;       // the packet
  int len;           // its plen clamped to [0, mtu]; 0 past the batch
  int mine;          // the bytes of the lane's chunk below plen
};

__device__ __forceinline__ Share share_of(long long g, int lane, int shift,
                                          const int* __restrict__ plen,
                                          long long n, int mtu, int chunk) {
  Share s;
  s.p = (g << (5 - shift)) + (lane >> shift);
  s.len = s.p < n ? min(max(__ldg(plen + s.p), 0), mtu) : 0;
  s.mine = min(max(s.len - (lane & ((1 << shift) - 1)) * chunk, 0), chunk);
  return s;
}

// Segment sg (bytes sg kSeg ..) of every lane's chunk in group g, copied
// asynchronously into the warp's buffer at buf (shared space): piece P
// (lane P's) at P kSeg, its 16-byte column c at c ^ (P % 8), so that
// neither these stores nor a lane's reads of its own piece conflict.
// Each instruction copies whole pieces, kSeg / kVec lanes a piece, so a
// warp's loads read 4 (2) whole lines, not a sliver of 32; only loads
// that start below the piece owner's plen are issued.
template <int kVec>
__device__ __forceinline__ void issue(uint32_t buf,
                                      const uint8_t* __restrict__ payload,
                                      long long g, int sg, int mine, int lane,
                                      int shift, int mtu, int chunk) {
  constexpr int kLoads = kSeg / kVec;         // loads a piece: 8 or 16
  constexpr int kPieces = 32 / kLoads;        // pieces an instruction
  const int b = lane % kLoads;
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int P = k * kPieces + lane / kLoads;
    const int m = __shfl_sync(0xffffffffu, mine, P) - sg * kSeg;
    if (b * kVec < m) {
      const uint8_t* src =
          payload + ((g << (5 - shift)) + (P >> shift)) * mtu +
          (P & ((1 << shift) - 1)) * chunk + sg * kSeg + b * kVec;
      const uint32_t col = kVec == 16 ? b : b >> 1;
      const uint32_t dst = buf + P * kSeg + ((col ^ (P & 7)) << 4) +
                           (kVec == 16 ? 0 : (b & 1) << 3);
      if constexpr (kVec == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(src) : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                     "l"(src) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// crc folded over the first m (<= kSeg) bytes of w: whole words
// slice-by-4, the last m % 4 bytes one at a time.  The lanes of a warp
// step together, up to the most words any of them folds, each keeping its
// crc past its own bytes, so that a ragged lane does not run its steps
// apart from the others'.
__device__ __forceinline__ uint32_t fold_seg(const uint32_t (&w)[kSegWords],
                                             int m, uint32_t crc,
                                             const Tables& tb) {
  if (__all_sync(0xffffffffu, m == kSeg)) {
#pragma unroll
    for (int j = 0; j < kSegWords; ++j) crc = tb.fold4(crc ^ w[j]);
    return crc;
  }
  const int words = m >> 2;
  const int steps = __reduce_max_sync(0xffffffffu, (m + 3) >> 2);
  uint32_t tail = 0;
#pragma unroll
  for (int j = 0; j < kSegWords; ++j) {
    if (j >= steps) break;
    const uint32_t f = tb.fold4(crc ^ w[j]);
    crc = j < words ? f : crc;
    tail = j == words ? w[j] : tail;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint32_t f = tb.byte(crc, tail >> (8 * i));
    crc = i < (m & 3) ? f : crc;
  }
  return crc;
}

// powers: (chunk, team) words, [s][k] = x^(8 (k chunk + s)) mod P.  A
// warp walks its groups segment by segment: it waits for the segment in
// its buffer, each lane takes its piece into registers, the warp issues
// the next segment's copies into the buffer, and only then do the lanes
// fold, so a segment's copy is in flight while the one before it folds.
template <int kVec>
__global__ void __launch_bounds__(kThreads, 1)
crc32_kernel(const uint8_t* __restrict__ payload, const int* __restrict__ plen,
             const uint32_t* __restrict__ image,
             const uint32_t* __restrict__ powers, uint32_t* __restrict__ out,
             long long n, int mtu, int team, int chunk) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int shift = __ffs(team) - 1;         // team = 1 << shift
  const int l = lane & (team - 1);           // the lane's place in its team
  const uint32_t init = l == 0 ? 0xffffffffu : 0u;
  const long long groups = (n + (32 >> shift) - 1) >> (5 - shift);
  const long long stride = (long long)gridDim.x * kWarps;
  const int segs = (chunk + kSeg - 1) / kSeg;
  const uint32_t buf = (uint32_t)__cvta_generic_to_shared(sm) + kTableBytes +
                       warp * kBufBytes;
  const uint4* piece = reinterpret_cast<const uint4*>(
      reinterpret_cast<const char*>(sm) + kTableBytes + warp * kBufBytes +
      lane * kSeg);
  // the first segment's copies are in flight while the block stages the
  // tables
  long long g = (long long)blockIdx.x * kWarps + warp;
  Share cur{}, next{};
  if (g < groups) {
    cur = next = share_of(g, lane, shift, plen, n, mtu, chunk);
    issue<kVec>(buf, payload, g, 0, cur.mine, lane, shift, mtu, chunk);
  }
  stage(sm, image);
  __syncthreads();
  if (g >= groups) return;
  const Tables tb(sm, lane);
  uint32_t crc = init;
  for (int sg = 0;;) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    uint32_t w[kSegWords];
#pragma unroll
    for (int c = 0; c < kSeg / 16; ++c) {
      const uint4 v = piece[c ^ (lane & 7)];
      w[4 * c] = v.x; w[4 * c + 1] = v.y; w[4 * c + 2] = v.z;
      w[4 * c + 3] = v.w;
    }
    __syncwarp();
    long long g2 = g;
    int sg2 = sg + 1;
    if (sg2 == segs) {
      sg2 = 0;
      g2 += stride;
    }
    const bool more = g2 < groups;
    if (more) {
      if (sg2 == 0) next = share_of(g2, lane, shift, plen, n, mtu, chunk);
      issue<kVec>(buf, payload, g2, sg2, sg2 == 0 ? next.mine : cur.mine,
                  lane, shift, mtu, chunk);
    }
    crc = fold_seg(w, min(max(cur.mine - sg * kSeg, 0), kSeg), crc, tb);
    if (sg == segs - 1) {
      // lane l < q: its chunk is followed by (q - 1 - l) chunk + s bytes
      const int q = cur.len / chunk, s = cur.len - q * chunk;
      if (l < q) crc = gf_mul(crc, __ldg(powers + s * team + (q - 1 - l)), tb);
      for (int d = team >> 1; d > 0; d >>= 1)
        crc ^= __shfl_xor_sync(0xffffffffu, crc, d);
      if (cur.p < n && l == 0) out[cur.p] = crc ^ 0xffffffffu;
      crc = init;
      cur = next;
    }
    if (!more) break;
    g = g2;
    sg = sg2;
  }
}

template <int kVec>
int launch(const void* payload, const void* plen, const void* image,
           const void* powers, void* out, long long n, int mtu, int team,
           int chunk, cudaStream_t stream) {
  const long long groups = (n + 32 / team - 1) / (32 / team);
  long long blocks = 0;
  cudaError_t err = grid::capped_blocks(crc32_kernel<kVec>, kThreads,
                                        (groups + kWarps - 1) / kWarps,
                                        &blocks, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  crc32_kernel<kVec><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      (const uint8_t*)payload, (const int*)plen, (const uint32_t*)image,
      (const uint32_t*)powers, (uint32_t*)out, n, mtu, team, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// payload: (n, mtu) uint8, contiguous, mtu % 8 == 0, aligned to vec (16
// or 8) bytes, and to 16 only if mtu % 16 == 0.  plen: (n,) int32.
// image: (4, 256) uint32, T3..T0.  powers: (chunk, team) uint32.  out: (n,)
// uint32.  team a power of two up to 32; chunk a positive multiple of vec.
int crc32_launch(const void* payload, const void* plen, const void* image,
                 const void* powers, void* out, long long n, int mtu,
                 int team, int chunk, int vec, void* stream) {
  if (n <= 0) return 0;
  const bool team_ok = team >= 1 && team <= 32 && (team & (team - 1)) == 0;
  if (!team_ok || mtu < 0 || mtu % 8 || (vec != 8 && vec != 16) ||
      chunk <= 0 || chunk % vec || (long long)team * chunk < mtu ||
      (uintptr_t)payload % vec || mtu % vec)
    return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  return vec == 16 ? launch<16>(payload, plen, image, powers, out, n, mtu,
                                team, chunk, s)
                   : launch<8>(payload, plen, image, powers, out, n, mtu,
                               team, chunk, s);
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
