// The fused epoch core for Hopper (sm_90a): a whole epoch of simulator
// ticks over one packed int32 "blob", in the oracle's exact event order.
//
// Replaces src/repro/core/fused.py:714 make_epoch_fn: a jitted
// lax.while_loop over the tick, NOT a pl.pallas_call.  The reference
// writes the tick as nested lax.fori_loops with lax.cond / lax.switch at
// every step and runs each loop to its static bound under a mask (the
// WCAP wire slots, PC plan rows twice an ACK, F x PC timer rows, B
// packets three times a batch).
//
// Bound on the H100: latency, not bytes or operations.  An epoch reads
// and writes the blob once as its bound by bytes (tens of KB, well under a
// microsecond at 3.35 TB/s), but every event of every tick runs after the
// one before it, and the tick's scans (the due and free wire slots, the
// timer rows, the ACK's release masks, the idle and watermark tests) touch
// every slot and row of the world.  So the design keeps each dependent
// access short and spreads each scan over a warp:
//   * one block of one warp.  The blob lives in dynamic shared memory for
//     the whole epoch (cp.async 16-byte copies in at launch, 16-byte stores
//     back at exit, the scratch after it): a dependent access is a
//     shared-memory round trip, not an L2 one.  A blob whose words and
//     scratch exceed the block's opt-in limit runs the same body on the
//     blob in device memory (the second instantiation, kResident = false);
//     the wrapper picks one by size alone (kernels/fused_epoch.py);
//   * all 32 lanes run the tick in warp-uniform control flow (the lane
//     abstraction below).  Lane 0 alone makes each store whose order the
//     oracle fixes (send, the wire push, the ring enqueue, the bump, the RX
//     header FSM, the counters); each scan is a step of 32 lanes, one slot
//     or row a lane, one __ballot_sync a predicate a chunk of 32, four
//     chunks' loads in flight at once;
//   * the scans skip what cannot match: the wire's below wire_hi (just
//     past the last slot that holds a packet), the free-slot search from
//     free_lo (every slot below it taken), the timer rows only when a held
//     row may be due (now >= next_due, a lower bound of their deadlines),
//     and on p2p links one scan of the wire a tick, each link then taking
//     its still-due slots from that list;
//   * the globals every step touches (NOW, ABORT, ACC_CTR, the chaos
//     counters, ...) live in registers for the epoch, the same in every
//     lane, and go back to the blob at exit;
//   * the field offsets, sizes, DEL, LDST and the loss / ECN / jitter /
//     reorder / watermark switches come as one __grid_constant__ Params
//     (kernels/fused_epoch.py:params), so one build serves every shape
//     key.
//
// Arithmetic is the reference's int32, wrapping: sums go through
// uint32_t (signed overflow is undefined in C++), PSN arithmetic is
// masked to 24 bits, the chaos hash (repro/core/fused.py:95, the twin of
// core/chaos.py:hash32) and its thresholds are uint32_t, and
// 32 - clz(sack) is taken on the uint32_t bits.  rx_decide is the port's
// core/pipeline.py:_rx_decide (the reference's repro/core/pipeline.py:
// 106) on one packet.
//
// The epoch body (everything above the #ifdef __CUDACC__ block) is also
// plain C++: compiled for the host, the lane abstraction evaluates the 32
// lanes in a loop and builds the same masks, so the host build runs the
// card's chunking, masks and ordering against the plain version without a
// card, through both residencies (epoch_body).
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FE_DEV __device__ __forceinline__
#define FE_HD __host__ __device__ inline
#else
#define FE_DEV inline
#define FE_HD inline
#endif

namespace {

// every blob field, in the order of kernels/fused_epoch.py:FIELDS
enum Field {
  NOW, STEPS, IDLE, ABORT, ACC_CTR, WM_HIT, MAX_TICKS, IDLE_DONE, F_SND,
  F_SQ, F_RCV, F_RQ, F_SR, F_WINDOW, F_GAP_LAG, F_TIMEOUT, F_BASE,
  F_PLAN_LEN, F_NCHUNKS, F_CURSOR, F_NEXT, F_BUDGET, F_OUT, F_TPASSED_D,
  F_LAST_NAK, F_LAST_NAK_W, F_LAST_GAP, F_LAST_GAP_W, F_LAST_CNP,
  F_LAST_CNP_W, F_WM, F_WM_ARMED, F_WM_THRESH, F_MAXCRED, F_LASTGID, P_OP,
  P_PLEN, P_VADDR, P_DLEN, P_ACKREQ, P_RKEY, P_HELD, P_RETR, P_DL, P_ACC,
  P_ASEQ, P_AADDR, C_NP, RX_EPSN, RX_MSN, RX_BYTES, RX_CUR, RX_CRED, RX_RKEY,
  RX_RXBIT, RX_SRF, RX_ACC, RX_DUP, RX_OOO, RX_CDROP, RX_ECN, N_TX, N_RX,
  N_RETX, N_SACKED, N_CNPTX, N_CNPRX, W_VALID, W_ARR, W_SEQ, W_DST, W_FLOW,
  W_PIDX, W_KIND, W_AP, W_SACK, T_ORDER, CNP_ORD, SEQ, INJECTED_D, CSEED,
  LOSS_T, KMIN, KMAX, CSEND, CPOP, DELAY, RED_T, PT_ENQ, PT_DEL, PT_TDROP,
  PT_WDROP, PT_ECN, PT_MAXD, R_HEAD, R_LEN, R_FLOW, R_PIDX, R_KIND, R_AP,
  R_SACK, L_SEED, L_LOSS_T, L_REORDER_T, L_JITTER, L_LAT, L_SEQ, L_SENT_D,
  L_DROP_D, L_CIDX, F_LDATA, F_LCTRL,
  NUM_FIELDS
};

constexpr int kMaxG = 128;          // kernels/fused_epoch.py:MAX_G
constexpr int kHead = 17;           // header words of Params
constexpr uint32_t kMask = 0x00FFFFFFu;     // packet.PSN_MASK
constexpr uint32_t kHalf = kMask / 2;
constexpr int kMaxRetries = 16;     // RetransmissionBuffer.MAX_RETRIES
constexpr int kNakHoldoff = 8;      // RdmaNode.NAK_HOLDOFF
constexpr int kCnpHoldoff = 8;      // RdmaNode.CNP_HOLDOFF
constexpr int kSrWindow = 24;       // pipeline.SR_WINDOW
// chaos.py purpose tags (TAG_RED and TAG_JITTER are both 2)
constexpr uint32_t kTagLoss = 1, kTagRed = 2, kTagJitter = 2,
                   kTagReorder = 3, kTagRdelay = 4;
constexpr uint32_t kAll = 0xFFFFFFFFu;
constexpr int kQ = 4;               // chunks of 32 a scan call reads at once

struct Params {
  int star, N, P, L, G, F, PC, CC, WCAP, RCAP;
  int loss_on, ecn_on, jit_on, reo_on, wm_on, bmax, size;
  int off[NUM_FIELDS];
  int del[kMaxG];
  int ldst[kMaxG];
};

// packet.py opcode classes
FE_DEV bool payload_op(int op) {   // PAYLOAD_OPS
  return op == 0x06 || op == 0x07 || op == 0x08 || op == 0x0A ||
         op == 0x0D || op == 0x0E || op == 0x0F || op == 0x10;
}
FE_DEV bool reth_op(int op) {      // RETH_OPS
  return op == 0x06 || op == 0x0A || op == 0x0C || op == 0x0D ||
         op == 0x10;
}
FE_DEV bool last_op(int op) {      // WRITE_LAST/ONLY, READ_RESP_LAST/ONLY
  return op == 0x08 || op == 0x0A || op == 0x0F || op == 0x10;
}

FE_DEV int add32(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
FE_DEV int sub32(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }

FE_DEV uint32_t hash32(uint32_t seed, uint32_t tag, int tick, int idx) {
  uint32_t x = seed ^ (tag * 0x9E3779B1u) ^ ((uint32_t)tick * 0x85EBCA77u) ^
               ((uint32_t)idx * 0xC2B2AE3Du);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// ---- the lane abstraction ---------------------------------------------
// On the card: the warp's lanes, __ballot_sync and __syncwarp.  On the
// host: one thread that plays lane 0 for the stores and evaluates the 32
// lanes of a step in a loop, building the same mask.
#ifdef __CUDACC__
FE_DEV bool lead() { return threadIdx.x == 0; }
FE_DEV void wsync() { __syncwarp(); }
FE_DEV int popc32(uint32_t x) { return __popc(x); }
FE_DEV int clz32(uint32_t x) { return __clz((int)x); }
FE_DEV int ffs32(uint32_t x) { return __ffs((int)x); }
#else
inline bool lead() { return true; }
inline void wsync() {}
inline int popc32(uint32_t x) { return __builtin_popcount(x); }
inline int clz32(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline int ffs32(uint32_t x) { return __builtin_ffs((int)x); }
#endif

template <int K>
struct Masks {
  uint32_t m[K];
};

// fn(i) for each element i of Q chunks of 32 from base that lies below
// n, one element a lane; fn writes only element i's own words.
template <int Q, class Fn>
FE_DEV void lanes(int base, int n, Fn fn) {
#ifdef __CUDACC__
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (base + 32 * q >= n) break;
    const int i = base + 32 * q + (int)threadIdx.x;
    if (i < n) fn(i);
  }
#else
  for (int i = base; i < base + 32 * Q && i < n; ++i) fn(i);
#endif
}

// K predicates of each element of Q chunks of 32 from base (base < n):
// lane l of chunk q evaluates fn(base + 32 q + l), which returns
// predicate k in bit k, on element n - 1 for the lanes past n (so every
// load is unconditional and the loads of all Q chunks are in flight
// together); the ballot of predicate k over chunk q, masked to the
// elements below n, is mask q K + k.  fn only reads.
template <int Q, int K, class Fn>
FE_DEV Masks<Q * K> chunks(int base, int n, Fn fn) {
  Masks<Q * K> r;
#ifdef __CUDACC__
  uint32_t fl[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = base + 32 * q + (int)threadIdx.x;
    const uint32_t v = (uint32_t)fn(i < n ? i : n - 1);
    fl[q] = i < n ? v : 0u;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int k = 0; k < K; ++k)
      r.m[q * K + k] = __ballot_sync(kAll, (fl[q] >> k) & 1u);
#else
  for (int q = 0; q < Q * K; ++q) r.m[q] = 0;
  for (int q = 0; q < Q; ++q)
    for (int l = 0; l < 32 && base + 32 * q + l < n; ++l) {
      const uint32_t fl = (uint32_t)fn(base + 32 * q + l);
      for (int k = 0; k < K; ++k) r.m[q * K + k] |= ((fl >> k) & 1u) << l;
    }
#endif
  return r;
}

// the element of each set bit of the Q masks from base, in order
template <int Q, class Fn>
FE_DEV void each_bit(const Masks<Q>& m, int base, Fn fn) {
  for (int q = 0; q < Q; ++q)
    for (uint32_t mq = m.m[q]; mq; mq &= mq - 1)
      fn(base + 32 * q + ffs32(mq) - 1);
}

template <int Q>
FE_DEV bool any_bit(const Masks<Q>& m) {
  uint32_t a = 0;
  for (int q = 0; q < Q; ++q) a |= m.m[q];
  return a != 0;
}

template <int Q>
FE_DEV int count_bits(const Masks<Q>& m) {
  int n = 0;
  for (int q = 0; q < Q; ++q) n += popc32(m.m[q]);
  return n;
}

// the least fn(i) over the Q chunks of 32 from base below n (INT_MAX
// where none): each lane's own, then a warp-wide min.  fn only reads.
template <int Q, class Fn>
FE_DEV int min_of(int base, int n, Fn fn) {
  int v = 0x7FFFFFFF;
#ifdef __CUDACC__
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = base + 32 * q + (int)threadIdx.x;
    const int x = fn(i < n ? i : n - 1);
    if (i < n && x < v) v = x;
  }
  return __reduce_min_sync(kAll, v);
#else
  for (int i = base; i < base + 32 * Q && i < n; ++i) {
    const int x = fn(i);
    if (x < v) v = x;
  }
  return v;
#endif
}

// n words from src to dst by the warp (16-byte copies where both are
// aligned), then a sync.  cp_async: dst is shared memory, src global.
FE_DEV void copy_words(int* dst, const int* src, int n, bool cp_async) {
#ifdef __CUDACC__
  const int lane = (int)threadIdx.x;
  int done = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const int nvec = n / 4;
    for (int v = lane; v < nvec; v += 32) {
      if (cp_async) {
        const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst + 4 * v);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                     "l"(src + 4 * v));
      } else {
        reinterpret_cast<int4*>(dst)[v] = reinterpret_cast<const int4*>(src)[v];
      }
    }
    if (cp_async) asm volatile("cp.async.wait_all;\n" ::);
    done = 4 * nvec;
  }
  for (int i = done + lane; i < n; i += 32) dst[i] = src[i];
  __syncwarp();
#else
  (void)cp_async;
  std::memcpy(dst, src, sizeof(int) * (size_t)n);
#endif
}

// ---- the epoch ----------------------------------------------------------
// How every lane keeps the same view of the blob:
//   * every lane reads any word directly (at, or a scan's own element);
//   * a word that more than lane 0 reads changes only between two
//     __syncwarp()s: put (one store by lane 0), solo (a group of lane 0's
//     stores) and step (each lane stores its own element's words).  So no
//     lane reads a word while it changes, and every lane reads it after;
//   * a tally (a counter or flag that no lane reads during the epoch:
//     N_TX, RX_ACC, F_LAST_GAP_W, ...) is read and written by lane 0 alone
//     (tally, mark), with no sync;
//   * a scan only reads.  Inside solo no lane-wide step may run.
// The host build checks the last two rules as it runs (faults()).
struct Epoch {
  int* b;
  const Params* p;
  // scratch: due wire slots (all, one link's, in pop order), one batch,
  // the batch's replies, per-flow CE tally
  int *due, *dlink, *ord, *bf, *bp, *bk, *ba, *bs, *be, *oack, *oap, *osk,
      *onak, *ecnf;
  // the globals, the same in every lane, in registers for the epoch
  int now, steps, idle, abort, acc, wm_hit, max_ticks, idle_done;
  int seq, injected, cseed, loss_t, kmin, kmax, csend, cpop;   // star
  int free_lo;       // every wire slot below it is taken (w_valid != 0)
  int wire_hi;       // no wire slot from it on holds a packet (w_valid > 0)
  int pc_shift;      // log2(PC) where PC is a power of two, else -1
  // no held plan row falls due before next_due (a lower bound of their
  // p_dl: every row made held or bumped lowers it, the timer scan sets it)
  int next_due;
  // p2p: due[0, ndue) are the wire's due slots of every link at the
  // tick's start, in slot order; late_due: a push of this tick arrives by
  // now, so a link's due slots are found by a scan of the wire instead
  int ndue;
  bool late_due;
#ifndef __CUDACC__
  mutable uint64_t read_[2], tallied_[2];
  mutable int solo_, faults_;
  void note(uint64_t* set, int f) const { set[f >> 6] |= 1ull << (f & 63); }
  void lanewide() const { faults_ += solo_ > 0; }
#else
  FE_DEV void lanewide() const {}
#endif

  FE_DEV int* fld(int f) const { return b + p->off[f]; }
  FE_DEV int at(int f, int i) const {
#ifndef __CUDACC__
    note(read_, f);
#endif
    return b[p->off[f] + i];
  }
  FE_DEV void put(int f, int i, int v) const {
    lanewide();
    wsync();
    if (lead()) b[p->off[f] + i] = v;
    wsync();
  }
  template <class Fn>
  FE_DEV void solo(Fn fn) const {
    lanewide();
    wsync();
#ifndef __CUDACC__
    ++solo_;
#endif
    if (lead()) fn();
#ifndef __CUDACC__
    --solo_;
#endif
    wsync();
  }
  FE_DEV void tally(int f, int i, int n = 1) const {
#ifndef __CUDACC__
    note(tallied_, f);
#endif
    if (lead()) b[p->off[f] + i] = add32(b[p->off[f] + i], n);
  }
  FE_DEV void mark(int f, int i, int v) const {
#ifndef __CUDACC__
    note(tallied_, f);
#endif
    if (lead()) b[p->off[f] + i] = v;
  }
  // a field's words for a scan's reads
  FE_DEV const int* rd(int f) const {
#ifndef __CUDACC__
    note(read_, f);
#endif
    return b + p->off[f];
  }
  // kQ chunks from base, K predicates each (see chunks); where the
  // elements left fit one chunk, only that chunk is read
  template <int K = 1, class Fn>
  FE_DEV Masks<kQ * K> scan(int base, int n, Fn fn) const {
    lanewide();
    if (n - base > 32) return chunks<kQ, K>(base, n, fn);
    const Masks<K> one = chunks<1, K>(base, n, fn);
    Masks<kQ * K> r = {};
    for (int k = 0; k < K; ++k) r.m[k] = one.m[k];
    return r;
  }
  template <class Fn>
  FE_DEV int least(int base, int n, Fn fn) const {
    lanewide();
    return min_of<kQ>(base, n, fn);
  }
  template <class Fn>
  FE_DEV void step(int base, int n, Fn fn) const {
    lanewide();
    wsync();
    lanes<kQ>(base, n, fn);
    wsync();
  }

  FE_DEV void init(int* blob, const Params* prm, int* smem) {
    b = blob;
    p = prm;
#ifndef __CUDACC__
    read_[0] = read_[1] = tallied_[0] = tallied_[1] = 0;
    solo_ = faults_ = 0;
#endif
    const int wcap = p->WCAP, bmax = p->bmax;
    due = smem;
    dlink = due + wcap;
    ord = dlink + wcap;
    bf = ord + wcap;
    bp = bf + bmax;
    bk = bp + bmax;
    ba = bk + bmax;
    bs = ba + bmax;
    be = bs + bmax;
    oack = be + bmax;
    oap = oack + bmax;
    osk = oap + bmax;
    onak = osk + bmax;
    ecnf = onak + bmax;
    now = at(NOW, 0); steps = at(STEPS, 0); idle = at(IDLE, 0);
    abort = at(ABORT, 0); acc = at(ACC_CTR, 0); wm_hit = at(WM_HIT, 0);
    max_ticks = at(MAX_TICKS, 0); idle_done = at(IDLE_DONE, 0);
    seq = injected = cseed = loss_t = kmin = kmax = csend = cpop = 0;
    if (p->star) {
      seq = at(SEQ, 0); injected = at(INJECTED_D, 0); cseed = at(CSEED, 0);
      loss_t = at(LOSS_T, 0); kmin = at(KMIN, 0); kmax = at(KMAX, 0);
      csend = at(CSEND, 0); cpop = at(CPOP, 0);
    }
    free_lo = 0;
    wire_hi = p->WCAP;
    next_due = -0x7FFFFFFF - 1;
    ndue = 0;
    late_due = false;
    pc_shift = (p->PC & (p->PC - 1)) == 0 ? ffs32((uint32_t)p->PC) - 1 : -1;
  }

  // flow index k of T_ORDER's flattened plan row j (j = k x PC + row)
  FE_DEV int flow_of(int j) const {
    return pc_shift >= 0 ? j >> pc_shift : j / p->PC;
  }

  // the globals back into the blob
  FE_DEV void finish() {
    solo([&] {
      int* g = b;
      const int* o = p->off;
      g[o[NOW]] = now; g[o[STEPS]] = steps; g[o[IDLE]] = idle;
      g[o[ABORT]] = abort; g[o[ACC_CTR]] = acc; g[o[WM_HIT]] = wm_hit;
      if (p->star) {
        g[o[SEQ]] = seq; g[o[INJECTED_D]] = injected;
        g[o[CSEND]] = csend; g[o[CPOP]] = cpop;
      }
    });
  }

#ifndef __CUDACC__
  // host build: rule breaks seen (a lane-wide step inside solo, a tally
  // also read as shared state)
  int faults() const {
    return faults_ + ((read_[0] & tallied_[0]) != 0) +
           ((read_[1] & tallied_[1]) != 0);
  }
#endif

  // ---- wire / ring ----------------------------------------------------
  // the first free slot (argmin of w_valid != 0): a ballot + ffs a chunk
  // of 32, from the chunk of free_lo; a full wire takes slot 0 (still
  // valid) and sets abort
  FE_DEV void wire_push(int arr, int loc, int seqv, int f, int kind,
                        int pidx, int ap, int sack) {
    const int wcap = p->WCAP;
    const int* wv = rd(W_VALID);
    int slot = -1;
    for (int c = free_lo & ~31; c < wcap && slot < 0; c += 32 * kQ) {
      const Masks<kQ> m = scan(c, wcap, [&](int s) { return wv[s] == 0; });
      for (int q = kQ - 1; q >= 0; --q)
        if (m.m[q]) slot = c + 32 * q + ffs32(m.m[q]) - 1;
    }
    if (slot < 0) {
      slot = 0;
      abort |= at(W_VALID, 0);
      free_lo = wcap;
    } else {
      free_lo = slot + 1;
    }
    late_due |= arr <= now;
    if (slot >= wire_hi) wire_hi = slot + 1;
    solo([&] {
      fld(W_VALID)[slot] = 1;
      fld(W_ARR)[slot] = arr;
      fld(W_SEQ)[slot] = seqv;
      fld(W_DST)[slot] = loc;
      fld(W_FLOW)[slot] = f;
      fld(W_PIDX)[slot] = pidx;
      fld(W_KIND)[slot] = kind;
      fld(W_AP)[slot] = ap;
      fld(W_SACK)[slot] = sack;
    });
  }

  // lane 0 alone (inside solo): the ring's order is the pops' order
  FE_DEV void ring_enq(int dst, int f, int kind, int pidx, int ap,
                       int sack) const {
    const int rcap = p->RCAP;
    const int depth = fld(R_LEN)[dst], head = fld(R_HEAD)[dst];
    const int enq0 = fld(PT_ENQ)[dst], maxd0 = fld(PT_MAXD)[dst];
    if (depth >= rcap) {
      fld(PT_TDROP)[dst] = add32(fld(PT_TDROP)[dst], 1);
      return;
    }
    const int i = dst * rcap + (head + depth) % rcap;
    fld(R_FLOW)[i] = f;
    fld(R_PIDX)[i] = pidx;
    fld(R_KIND)[i] = kind;
    fld(R_AP)[i] = ap;
    fld(R_SACK)[i] = sack;
    fld(R_LEN)[dst] = depth + 1;
    fld(PT_ENQ)[dst] = add32(enq0, 1);
    if (depth + 1 > maxd0) fld(PT_MAXD)[dst] = depth + 1;
  }

  // ---- transmit (net.send from RdmaNode._send) --------------------------
  FE_DEV void send(int src, int f, int kind, int pidx, int ap, int sack) {
    tally(N_TX, src);
    if (p->star) {
      const int dst = kind == 0 ? at(F_RCV, f) : at(F_SND, f);
      injected = add32(injected, 1);
      if (p->loss_on) {
        const uint32_t h = hash32((uint32_t)cseed, kTagLoss, now, csend);
        csend = add32(csend, 1);
        if (h < (uint32_t)loss_t) {
          tally(PT_WDROP, dst);
          return;
        }
      }
      seq = add32(seq, 1);
      wire_push(add32(now, at(DELAY, src)), dst, seq, f, kind, pidx, ap,
                sack);
      return;
    }
    const int link = kind == 0 ? at(F_LDATA, f) : at(F_LCTRL, f);
    tally(L_SENT_D, link);
    const int rank = at(L_CIDX, link);
    put(L_CIDX, link, add32(rank, 1));
    const uint32_t seed = (uint32_t)at(L_SEED, link);
    if (p->loss_on &&
        hash32(seed, kTagLoss, now, rank) < (uint32_t)at(L_LOSS_T, link)) {
      tally(L_DROP_D, link);
      return;
    }
    uint32_t delay = (uint32_t)at(L_LAT, link);
    if (p->jit_on)
      delay += hash32(seed, kTagJitter, now, rank) %
               ((uint32_t)at(L_JITTER, link) + 1u);
    if (p->reo_on && hash32(seed, kTagReorder, now, rank) <
                         (uint32_t)at(L_REORDER_T, link))
      delay += 1u + hash32(seed, kTagRdelay, now, rank) % 7u;
    const int seqv = add32(at(L_SEQ, link), 1);
    put(L_SEQ, link, seqv);
    wire_push((int)((uint32_t)now + delay), link, seqv, f, kind, pidx, ap,
              sack);
  }

  FE_DEV void send_data(int f, int row) { send(at(F_SND, f), f, 0, row, 0, 0); }
  FE_DEV void send_ctrl(int f, int kind, int ap, int sack) {
    send(at(F_RCV, f), f, kind, 0, ap, sack);
  }

  // ---- retransmit bump (retransmit._bump + rdma._send_retx) -------------
  // Writes, of the plan rows, only row's own P_RETR and P_DL: the scans
  // that pick the rows to bump (timers, gap, NAK) read P_HELD and P_DL of
  // the rows not yet bumped, so a mask taken before the first bump is the
  // one the oracle reads row by row.
  FE_DEV void bump_send(int f, int row) {
    const int i = f * p->PC + row;
    const int r = add32(at(P_RETR, i), 1);
    if (r > kMaxRetries) {
      put(P_RETR, i, r);
      abort |= 1;
      if (at(P_DL, i) < next_due) next_due = at(P_DL, i);
      return;
    }
    const uint32_t shift = r < 4 ? (uint32_t)r : 4u;
    const int dl = (int)((uint32_t)now + (uint32_t)at(F_TIMEOUT, f) * (1u << shift));
    solo([&] {
      fld(P_RETR)[i] = r;
      fld(P_DL)[i] = dl;
    });
    if (dl < next_due) next_due = dl;
    tally(N_RETX, at(F_SND, f));
    send_data(f, row);
  }

  // ---- control-plane handlers -------------------------------------------
  FE_DEV void on_ack(int f, int ap, int sack) {
    const int PC = p->PC, CC = p->CC, row0 = f * PC;
    const uint32_t base = (uint32_t)at(F_BASE, f);
    const uint32_t uap = (uint32_t)ap, usack = (uint32_t)sack;
    // a held row's release: 1 cumulative, 2 selective (bit j >= 1 of the
    // SACK -> ap+1+j), 0 none.  The released rows are counted first (n1,
    // n2); then each lane rewrites its rows' p_held (1 where held and not
    // released, else 0) and, if any row was released, clears the p_retr
    // of the rows still held
    const int* held = rd(P_HELD) + row0;
    auto release = [&](int row) {
      const uint32_t psn = (base + row) & kMask;
      const uint32_t off2 = (psn - uap - 1u) & kMask;
      if (((uap - psn) & kMask) <= kHalf) return 1;
      return sack != 0 && off2 >= 1 && off2 <= 31 && ((usack >> off2) & 1u)
                 ? 2 : 0;
    };
    int n1 = 0, n2 = 0, odd = 0;
    for (int c = 0; c < PC; c += 32 * kQ) {
      const Masks<3 * kQ> m = scan<3>(c, PC, [&](int row) {
        const int h = held[row], r = h > 0 ? release(row) : 0;
        return (uint32_t)(r == 1) | (uint32_t)(r == 2) << 1 |
               (uint32_t)((h != 0) & (h != 1)) << 2;
      });
      for (int q = 0; q < kQ; ++q) {
        n1 += popc32(m.m[3 * q]);
        n2 += popc32(m.m[3 * q + 1]);
        odd += popc32(m.m[3 * q + 2]);
      }
    }
    const bool released = n1 > 0 || n2 > 0;
    if (released || odd > 0)
      for (int c = 0; c < PC; c += 32 * kQ)
        step(c, PC, [&](int row) {
          int* h = fld(P_HELD) + row0 + row;
          const bool keep = *h > 0 && release(row) == 0;
          *h = keep;
          if (released && keep) fld(P_RETR)[row0 + row] = 0;
        });
    tally(N_SACKED, at(F_SND, f), n2);
    // SACK-driven gap resend (rdma._maybe_gap_resend): a ballot a chunk,
    // then its rows bumped in order (see bump_send)
    if (sack != 0 && !(sub32(now, at(F_LAST_GAP, f)) < kNakHoldoff)) {
      const uint32_t hi = (uap + (uint32_t)(32 - clz32(usack))) & kMask;
      const int gap_lag = at(F_GAP_LAG, f);
      bool any = false;
      for (int c = 0; c < PC; c += 32 * kQ) {
        const Masks<kQ> m = scan(c, PC, [&](int row) {
          const uint32_t psn = (base + row) & kMask;
          const uint32_t offg = (psn - uap) & kMask;
          const uint32_t lag = (hi - psn) & kMask;
          return (held[row] != 0) & (offg > 0) & (offg <= kHalf) &
                 (lag <= kHalf) & ((int)lag >= gap_lag);
        });
        each_bit(m, c, [&](int row) {
          if (!any) {
            any = true;
            put(F_LAST_GAP, f, now);
            mark(F_LAST_GAP_W, f, 1);
          }
          bump_send(f, row);
        });
      }
    }
    // ACK-clocked flow control (flow_control.ack + _drain + dispatch)
    const int rel = n1 + n2 > 1 ? n1 + n2 : 1;
    int out0 = sub32(at(F_OUT, f), rel);
    if (out0 < 0) out0 = 0;
    int bud = add32(at(F_BUDGET, f), rel);
    if (at(F_WINDOW, f) < bud) bud = at(F_WINDOW, f);
    const int cur0 = at(F_CURSOR, f), nch = at(F_NCHUNKS, f);
    int taken = 0, tot = 0;
    for (int k = 0; k < CC; ++k) {
      if (cur0 + k >= nch) break;
      const int need = at(C_NP, f * CC + (cur0 + k < CC - 1 ? cur0 + k : CC - 1));
      if (need > bud) break;
      bud = sub32(bud, need);
      ++taken;
      tot = add32(tot, need);
    }
    const int nxt0 = at(F_NEXT, f);
    solo([&] {
      fld(F_CURSOR)[f] = add32(cur0, taken);
      fld(F_NEXT)[f] = add32(nxt0, tot);
      fld(F_OUT)[f] = add32(out0, tot);
      fld(F_BUDGET)[f] = bud;
      fld(F_TPASSED_D)[f] = add32(fld(F_TPASSED_D)[f], taken);
    });
    const int lim = tot < PC ? tot : PC;
    const int dl = add32(now, at(F_TIMEOUT, f));
    for (int k = 0; k < lim; ++k) {
      const int row = nxt0 + k;
      if (row >= 0 && row < PC) {
        solo([&] {
          fld(P_HELD)[row0 + row] = 1;
          fld(P_RETR)[row0 + row] = 0;
          fld(P_DL)[row0 + row] = dl;
        });
        if (dl < next_due) next_due = dl;
      }
      send_data(f, row);
    }
  }

  FE_DEV void on_nak(int f, int ap) {
    const int PC = p->PC, row0 = f * PC;
    if (sub32(now, at(F_LAST_NAK, f)) < kNakHoldoff) return;
    put(F_LAST_NAK, f, now);
    mark(F_LAST_NAK_W, f, 1);
    const uint32_t expected = ((uint32_t)ap + 1u) & kMask;
    const uint32_t base = (uint32_t)at(F_BASE, f);
    const int* held = rd(P_HELD) + row0;
    for (int c = 0; c < PC; c += 32 * kQ) {
      const Masks<kQ> m = scan(c, PC, [&](int row) {
        const uint32_t psn = (base + row) & kMask;
        return (held[row] > 0) & (((psn - expected) & kMask) <= kHalf);
      });
      each_bit(m, c, [&](int row) { bump_send(f, row); });
    }
  }

  // ---- the RX header FSM on one data packet (pipeline._rx_decide) ---------
  // Reads flow f's RX row; returns the packet's outputs and the row's new
  // words, which the caller stores.
  struct Rx {
    bool accept, rkey_err, ecn_echo, send_ack, send_nak, dup, ooo, dropped;
    bool is_last, bytes_set;
    int dma_addr, ack_psn, sack, new_epsn, new_rxbit, plen, dlen, cred;
  };

  FE_DEV Rx rx_decide(int f, int pidx, int ecn) const {
    const int i = f * p->PC + pidx;
    const int op = at(P_OP, i), plen = at(P_PLEN, i);
    const int vaddr = at(P_VADDR, i), dlen = at(P_DLEN, i);
    const int ackreq = at(P_ACKREQ, i), rkey = at(P_RKEY, i);
    const uint32_t psn = ((uint32_t)at(F_BASE, f) + (uint32_t)pidx) & kMask;
    const int epsn = at(RX_EPSN, f), cred = at(RX_CRED, f);
    const int trk = at(RX_RKEY, f), rxbit = at(RX_RXBIT, f);
    const bool is_payload = payload_op(op), has_reth = reth_op(op);
    const bool is_last = last_op(op), sr = at(RX_SRF, f) > 0;
    const bool in_seq = (int)psn == epsn;
    const uint32_t d = (psn - (uint32_t)epsn) & kMask;
    const bool behind = d > kHalf, has_credit = cred > 0;
    // go-back-N
    const bool rkey_ok_g = !has_reth || trk == 0 || rkey == trk;
    const bool accept_g = is_payload && in_seq && has_credit && rkey_ok_g;
    const bool dropped_g = is_payload && in_seq && !has_credit && rkey_ok_g;
    const bool rkey_err_g = is_payload && in_seq && !rkey_ok_g;
    const int start_addr = has_reth ? vaddr : at(RX_CUR, f);
    const int new_epsn_g = accept_g ? (int)(((uint32_t)epsn + 1u) & kMask)
                                    : epsn;
    // selective repeat
    const bool in_win = !behind && d < (uint32_t)kSrWindow;
    const uint32_t bit =
        in_win ? 1u << (d < kSrWindow - 1 ? d : kSrWindow - 1) : 0u;
    const bool already = ((uint32_t)rxbit & bit) != 0;
    const bool fresh = in_win && !already;
    const bool rkey_ok_s = trk == 0 || rkey == trk;
    const bool accept_s = is_payload && fresh && has_credit && rkey_ok_s;
    const bool dropped_s = is_payload && fresh && !has_credit && rkey_ok_s;
    const bool rkey_err_s = is_payload && fresh && !rkey_ok_s;
    const bool dup_s = (behind || already) && is_payload;
    const bool ooo_s = !behind && !in_win && is_payload;
    const uint32_t bm = (uint32_t)rxbit | (accept_s ? bit : 0u);
    const uint32_t inv = ~bm;
    const int adv = popc32((inv & (0u - inv)) - 1u);
    const int new_epsn_s = (int)(((uint32_t)epsn + (uint32_t)adv) & kMask);
    const int new_rxbit_s = adv < 32 ? (int)(bm >> adv) : 0;
    // merge
    Rx o;
    if (sr) {
      o.accept = accept_s; o.dup = dup_s; o.ooo = ooo_s;
      o.dropped = dropped_s; o.rkey_err = rkey_err_s; o.dma_addr = vaddr;
      o.new_epsn = new_epsn_s; o.new_rxbit = new_rxbit_s;
    } else {
      o.accept = accept_g; o.dup = behind && is_payload;
      o.ooo = !in_seq && !behind && is_payload; o.dropped = dropped_g;
      o.rkey_err = rkey_err_g; o.dma_addr = start_addr;
      o.new_epsn = new_epsn_g; o.new_rxbit = rxbit;
    }
    o.is_last = is_last;
    o.bytes_set = has_reth || sr;
    o.plen = plen;
    o.dlen = dlen;
    o.cred = cred;
    o.ecn_echo = ecn > 0 && is_payload;
    o.ack_psn = (!sr && o.accept) ? (int)psn
                                  : (int)(((uint32_t)o.new_epsn - 1u) & kMask);
    o.send_ack = (o.accept && (is_last || ackreq > 0 ||
                               (sr && (d > 0 || adv > 1)))) || o.dup;
    o.send_nak = o.ooo;
    o.sack = sr ? new_rxbit_s : 0;
    return o;
  }

  // ---- one delivered batch of n packets through node dst --------------
  FE_DEV void process_batch(int grp, int dst, int n) {
    const int F = p->F, PC = p->PC;
    tally(N_RX, dst, n);
    bool anydata = false;
    for (int i = 0; i < n; ++i) {                // pass A: control packets
      const int f = bf[i], kind = bk[i];
      if (kind == 1) on_ack(f, ba[i], bs[i]);
      else if (kind == 2) on_nak(f, ba[i]);
      else if (kind == 3) tally(N_CNPRX, at(F_SND, f));
      anydata |= kind == 0;
    }
    if (anydata || p->ecn_on)                    // credit column, CE tally
      for (int c = 0; c < F; c += 32 * kQ)
        step(c, F, [&](int f) {
          if (anydata && at(F_RCV, f) == dst)
            fld(RX_CRED)[f] = at(F_MAXCRED, f);
          ecnf[f] = 0;                           // (read under ecn_on only)
        });
    for (int i = 0; i < n; ++i) {                // pass E: data packets
      if (bk[i] != 0) continue;                  // (pass D reads data's only)
      const int f = bf[i], pidx = bp[i];
      const Rx o = rx_decide(f, pidx, be[i]);
      abort |= (int)o.rkey_err;
      const int aseq = acc;
      if (o.accept) acc = add32(acc, 1);
      solo([&] {
        // every word read before the first store, so the loads issue
        // together (the compiler may not move a load past a store)
        const int k = f * PC + pidx;
        const int bytes0 = fld(RX_BYTES)[f], msn0 = fld(RX_MSN)[f];
        const int acc0 = fld(RX_ACC)[f], dup0 = fld(RX_DUP)[f];
        const int ooo0 = fld(RX_OOO)[f], cdrop0 = fld(RX_CDROP)[f];
        const int ecn0 = fld(RX_ECN)[f], ce0 = ecnf[f], wm0 = fld(F_WM)[f];
        const int wm = add32(o.dma_addr, fld(P_PLEN)[k]);
        const bool gbn = fld(RX_SRF)[f] <= 0;
        if (o.accept) {
          fld(RX_CUR)[f] = add32(o.dma_addr, o.plen);
          fld(RX_BYTES)[f] = o.bytes_set ? sub32(o.dlen, o.plen)
                                         : sub32(bytes0, o.plen);
          if (o.is_last) fld(RX_MSN)[f] = add32(msn0, 1);
          fld(RX_CRED)[f] = sub32(o.cred, 1);
        }
        fld(RX_EPSN)[f] = o.new_epsn;
        fld(RX_RXBIT)[f] = o.new_rxbit;
        fld(RX_ACC)[f] = add32(acc0, o.accept);
        fld(RX_DUP)[f] = add32(dup0, o.dup);
        fld(RX_OOO)[f] = add32(ooo0, o.ooo);
        fld(RX_CDROP)[f] = add32(cdrop0, o.dropped);
        fld(RX_ECN)[f] = add32(ecn0, o.ecn_echo);
        ecnf[f] = ce0 + o.ecn_echo;
        if (o.accept) {
          fld(P_ACC)[k] = 1;
          fld(P_ASEQ)[k] = aseq;
          fld(P_AADDR)[k] = o.dma_addr;
          if (gbn && wm > wm0) fld(F_WM)[f] = wm;
        }
        oack[i] = o.send_ack;
        onak[i] = o.send_nak;
        oap[i] = o.ack_psn;
        osk[i] = o.sack;
      });
    }
    if (p->ecn_on) {                             // CNPs, QPN-ascending
      const int* ord_f = rd(CNP_ORD) + grp * F;
      for (int c = 0; c < F; c += 32 * kQ) {
        const Masks<kQ> m = scan(c, F, [&](int k) {
          const int f = ord_f[k];
          return f >= 0 && ecnf[f] > 0;
        });
        each_bit(m, c, [&](int k) {
          const int f = ord_f[k];
          if (sub32(now, at(F_LAST_CNP, f)) < kCnpHoldoff) return;
          put(F_LAST_CNP, f, now);
          mark(F_LAST_CNP_W, f, 1);
          tally(N_CNPTX, dst);
          send_ctrl(f, 3, 0, 0);
        });
      }
    }
    for (int i = 0; i < n; ++i) {                // pass D: ACK / NAK
      if (bk[i] != 0) continue;
      if (oack[i]) send_ctrl(bf[i], 1, oap[i], osk[i]);
      if (onak[i]) send_ctrl(bf[i], 2, oap[i], 0);
    }
  }

  // Appends val(i) of each element i whose bit is set in the kQ masks m
  // of the chunks from c to out[n..), in element order; returns the new
  // count.
  template <class Val>
  FE_DEV int append(int* out, int n, int c, const Masks<kQ>& m, Val val) {
    int top = 0;                                 // chunks up to the last set
    for (int q = 0; q < kQ; ++q)
      if (m.m[q]) top = q + 1;
    if (top == 0) return n;
    step(c, c + 32 * top, [&](int i) {
      const int q = (i - c) >> 5;
      const uint32_t bit = 1u << ((i - c) & 31);
      if (!(m.m[q] & bit)) return;
      int before = popc32(m.m[q] & (bit - 1u));
      for (int r = 0; r < q; ++r) before += popc32(m.m[r]);
      out[n + before] = val(i);
    });
    return n + count_bits(m);
  }

  // the wire's due slots (of one link, or of all for link < 0) into
  // out[], in slot order: a ballot a chunk of 32 slots below wire_hi;
  // returns how many.  The scan of all links also lowers wire_hi to just
  // past the last slot that holds a packet.
  FE_DEV int scan_due(int link, int* out) {
    const int hi = wire_hi, t = now;
    const int *wv = rd(W_VALID), *arr = rd(W_ARR), *wd = rd(W_DST);
    int n = 0, last = 0;
    for (int c = 0; c < hi; c += 32 * kQ) {
      const Masks<2 * kQ> m = scan<2>(c, hi, [&](int s) {
        const bool v = wv[s] > 0;
        return (uint32_t)(v & (arr[s] <= t) & ((link < 0) | (wd[s] == link)))
               | (uint32_t)v << 1;
      });
      Masks<kQ> due_m;
      for (int q = 0; q < kQ; ++q) {
        due_m.m[q] = m.m[2 * q];
        if (m.m[2 * q + 1]) last = c + 32 * q + 32 - clz32(m.m[2 * q + 1]);
      }
      n = append(out, n, c, due_m, [](int s) { return s; });
    }
    if (link < 0) wire_hi = last;
    return n;
  }

  // The due wire slots (of one link, or all for link < 0) into ord[], in
  // pop order: (arrival, seq), then slot.  A link's are those of the
  // tick's due slots (due[], found once at its start) that are still due
  // and on that link, unless a push of this tick is due already
  // (late_due: then the wire is scanned again).
  // Each lane then ranks one slot against all (a stable sort by (arrival,
  // seq), as the oracle's insertion sort orders them).  Returns how many.
  FE_DEV int collect_due(int link) {
    const int *arr = rd(W_ARR), *seq_ = rd(W_SEQ), *wd = rd(W_DST);
    const int* wv = rd(W_VALID);
    const int t = now;
    int* sel = link < 0 ? due : dlink;
    int n = 0;
    if (link >= 0 && !late_due) {
      // (a slot an earlier link popped may hold a push of this tick since)
      for (int c = 0; c < ndue; c += 32 * kQ)
        n = append(sel, n, c, scan(c, ndue, [&](int j) {
          const int s = due[j];
          return (wv[s] > 0) & (arr[s] <= t) & (wd[s] == link);
        }), [&](int j) { return due[j]; });
    } else {
      n = scan_due(link, sel);
    }
    for (int c = 0; c < n; c += 32 * kQ)
      step(c, n, [&](int j) {
        const int sj = sel[j], aj = arr[sj], qj = seq_[sj];
        int rank = 0;
        for (int k = 0; k < n; ++k) {
          const int sk = sel[k], ak = arr[sk], qk = seq_[sk];
          rank += (ak < aj) | ((ak == aj) & ((qk < qj) | ((qk == qj) & (k < j))));
        }
        ord[rank] = sj;
      });
    return n;
  }

  // ---- one network tick (netsim.tick + rdma.step_network) ---------------
  FE_DEV void tick() {
    now = add32(now, 1);
    const int PC = p->PC, F = p->F, bmax = p->bmax;
    if (p->star) {
      const int rcap = p->RCAP;
      if (p->loss_on || p->ecn_on) {
        csend = 0;
        cpop = 0;
      }
      const int nd = collect_due(-1);            // due packets -> rings
      if (nd > 0) {
        solo([&] {
          for (int i = 0; i < nd; ++i) {
            const int s = ord[i];
            fld(W_VALID)[s] = 0;
            ring_enq(fld(W_DST)[s], fld(W_FLOW)[s], fld(W_KIND)[s],
                     fld(W_PIDX)[s], fld(W_AP)[s], fld(W_SACK)[s]);
          }
        });
        free_lo = 0;
      }
      for (int port = 0; port < p->P; ++port) {  // drain each port
        const int B = p->del[port];
        if (B == 0) continue;
        const int len0 = at(R_LEN, port), head0 = at(R_HEAD, port);
        int n_pop = B < len0 ? B : len0;
        if (n_pop > bmax) n_pop = bmax;
        if (n_pop == 0) {                        // an empty batch is a no-op
          if (head0 % rcap != head0) put(R_HEAD, port, head0 % rcap);
          continue;
        }
        // entry j pops at ring depth len0 - j with RED rank cpop + j
        const int* red_t = rd(RED_T);
        int marks = 0;
        for (int c = 0; c < n_pop; c += 32 * kQ) {
          Masks<kQ> m = {};
          if (p->ecn_on)
            m = scan(c, n_pop, [&](int j) {
              const int depth = len0 - j;
              const uint32_t h = hash32((uint32_t)cseed, kTagRed, now,
                                        add32(cpop, j));
              return depth >= kmax ||
                     (depth > kmin && h < (uint32_t)red_t[depth]);
            });
          marks += count_bits(m);
          step(c, n_pop, [&](int j) {
            const int k = port * rcap + (head0 + j) % rcap;
            bf[j] = at(R_FLOW, k);
            bp[j] = at(R_PIDX, k);
            bk[j] = at(R_KIND, k);
            ba[j] = at(R_AP, k);
            bs[j] = at(R_SACK, k);
            be[j] = (m.m[(j - c) >> 5] >> ((j - c) & 31)) & 1u;
          });
        }
        if (p->ecn_on) {
          cpop = add32(cpop, n_pop);
          tally(PT_ECN, port, marks);
        }
        solo([&] {
          fld(R_HEAD)[port] = (head0 + n_pop) % rcap;
          fld(R_LEN)[port] = len0 - n_pop;
        });
        tally(PT_DEL, port, n_pop);
        process_batch(port, port, n_pop);
      }
    } else {
      if (p->loss_on || p->jit_on || p->reo_on)
        for (int c = 0; c < p->L; c += 32 * kQ)
          step(c, p->L, [&](int l) { fld(L_CIDX)[l] = 0; });
      ndue = scan_due(-1, due);                  // every link's, once
      late_due = false;
      for (int li = 0; li < p->L; ++li) {        // deliver, link order
        if (p->del[li] == 0) continue;           // nothing pops: a no-op
        const int nd = collect_due(li);
        int n = nd < p->del[li] ? nd : p->del[li];
        if (n > bmax) n = bmax;
        if (n == 0) continue;
        for (int c = 0; c < n; c += 32 * kQ)
          step(c, n, [&](int j) {
            const int s = ord[j];
            fld(W_VALID)[s] = 0;
            bf[j] = at(W_FLOW, s);
            bp[j] = at(W_PIDX, s);
            bk[j] = at(W_KIND, s);
            ba[j] = at(W_AP, s);
            bs[j] = at(W_SACK, s);
            be[j] = 0;
          });
        free_lo = 0;
        process_batch(li, p->ldst[li], n);
      }
    }
    // retransmission timers (rdma.tick, node x QPN order), where a held
    // row may be due (now >= next_due): the F x PC rows flattened in
    // T_ORDER, a ballot a chunk of 32, its rows bumped in order (see
    // bump_send; T_ORDER is a permutation of the flows); next_due becomes
    // the least p_dl of the held rows after the bumps
    const int rows = F * PC;
    const int *held = rd(P_HELD), *dl = rd(P_DL), *tord = rd(T_ORDER);
    if (now >= next_due) {
      int later = 0x7FFFFFFF;                    // rows held, not due
      next_due = 0x7FFFFFFF;                     // rows bumped (bump_send)
      for (int c = 0; c < rows; c += 32 * kQ) {
        auto row_at = [&](int j) {
          const int k = flow_of(j);
          return tord[k] * PC + (j - k * PC);
        };
        const Masks<kQ> m = scan(c, rows, [&](int j) {
          const int i = row_at(j);
          return (held[i] > 0) & (now >= dl[i]);
        });
        const int lo = least(c, rows, [&](int j) {
          const int i = row_at(j);
          return (held[i] > 0) & (dl[i] > now) ? dl[i] : 0x7FFFFFFF;
        });
        if (lo < later) later = lo;
        each_bit(m, c, [&](int j) {
          const int k = flow_of(j);
          bump_send(tord[k], j - k * PC);
        });
      }
      if (later < next_due) next_due = later;
    }
    // idle / watermark accounting (rdma.run_network)
    const int* wv = rd(W_VALID);
    bool pending = false;
    for (int c = 0; c < wire_hi && !pending; c += 32 * kQ)
      pending = any_bit(scan(c, wire_hi, [&](int s) { return wv[s] > 0; }));
    for (int c = 0; c < rows && !pending; c += 32 * kQ)
      pending = any_bit(scan(c, rows, [&](int i) { return held[i] > 0; }));
    const int *cursor = rd(F_CURSOR), *nch = rd(F_NCHUNKS);
    for (int c = 0; c < F && !pending; c += 32 * kQ)
      pending = any_bit(scan(c, F, [&](int f) { return cursor[f] < nch[f]; }));
    if (p->star) {
      const int* rlen = rd(R_LEN);
      for (int c = 0; c < p->P && !pending; c += 32 * kQ)
        pending = any_bit(scan(c, p->P, [&](int q) { return rlen[q] > 0; }));
    }
    idle = pending ? 0 : add32(idle, 1);
    steps = add32(steps, 1);
    if (p->wm_on) {
      const int *armed = rd(F_WM_ARMED), *wm = rd(F_WM), *thr = rd(F_WM_THRESH);
      bool hit = false;
      for (int c = 0; c < F && !hit; c += 32 * kQ)
        hit = any_bit(scan(c, F, [&](int f) {
          return (armed[f] > 0) & (wm[f] >= thr[f]);
        }));
      wm_hit = hit;
    }
  }

  FE_DEV void run() {
    while (abort == 0 && wm_hit == 0 && idle < idle_done &&
           steps < max_ticks)
      tick();
  }
};

// Params from the wrapper's int32 words (kernels/fused_epoch.py:params);
// false if the word count is not the kernel's
inline bool read_params(Params* prm, const int* meta, int len) {
  if (len != kHead + NUM_FIELDS + 2 * kMaxG) return false;
  const int* m = meta;
  prm->star = m[0]; prm->N = m[1]; prm->P = m[2]; prm->L = m[3];
  prm->G = m[4]; prm->F = m[5]; prm->PC = m[6]; prm->CC = m[7];
  prm->WCAP = m[8]; prm->RCAP = m[9]; prm->loss_on = m[10];
  prm->ecn_on = m[11]; prm->jit_on = m[12]; prm->reo_on = m[13];
  prm->wm_on = m[14]; prm->bmax = m[15]; prm->size = m[16];
  std::memcpy(prm->off, meta + kHead, sizeof(prm->off));
  std::memcpy(prm->del, meta + kHead + NUM_FIELDS, sizeof(prm->del));
  std::memcpy(prm->ldst, meta + kHead + NUM_FIELDS + kMaxG,
              sizeof(prm->ldst));
  return prm->G <= kMaxG && prm->bmax >= 1;
}

// words of the blob's copy in shared memory (a whole number of 16 bytes)
FE_HD long blob_words(const Params& prm) { return (prm.size + 3L) & ~3L; }

// dynamic shared memory of a launch, in words: the resident blob, then
// the scratch (3 rows of wire slots, 10 batch rows, the CE tally)
FE_HD long smem_words(const Params& prm, bool resident) {
  return (resident ? blob_words(prm) : 0L) + 3L * prm.WCAP +
         10L * prm.bmax + prm.F;
}

// One epoch over `blob` with the dynamic shared memory `smem`: resident,
// the blob is copied into smem, run there and copied back; else the same
// body runs on the blob where it lies.  Returns the host build's rule
// breaks (0 on the card).
template <bool kResident>
FE_DEV int epoch_body(int* blob, const Params* prm, int* smem) {
  int* b = blob;
  if (kResident) {
    copy_words(smem, blob, prm->size, true);
    b = smem;
  }
  Epoch e;
  e.init(b, prm, smem + (kResident ? blob_words(*prm) : 0));
  e.run();
  e.finish();
  if (kResident) copy_words(blob, smem, prm->size, false);
#ifdef __CUDACC__
  return 0;
#else
  return e.faults();
#endif
}

}  // namespace

#ifdef __CUDACC__

namespace {

template <bool kResident>
__global__ void __launch_bounds__(32)
    fused_epoch_kernel(int* blob, const __grid_constant__ Params prm) {
  extern __shared__ int4 smem4[];
  epoch_body<kResident>(blob, &prm, reinterpret_cast<int*>(smem4));
}

}  // namespace

extern "C" {

// The dynamic shared memory a block of the current device may opt into
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), in bytes, or -1.
int fused_epoch_smem_optin(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

// One epoch on `stream`, in place on the device blob: the shared-memory
// instantiation if `resident`, else the device-memory one.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for parameters the
// kernel does not take, or a resident blob over the opt-in limit).
int fused_epoch_launch(void* blob, const int* meta, int len, int resident,
                       void* stream) {
  static_assert(sizeof(Params) <= 4096, "kernel parameters over 4 KB");
  Params prm;
  if (!read_params(&prm, meta, len)) return (int)cudaErrorInvalidValue;
  const long bytes = (long)sizeof(int) * smem_words(prm, resident != 0);
  const int optin = fused_epoch_smem_optin();
  if (optin < 0 || bytes > optin) return (int)cudaErrorInvalidValue;
  void (*kern)(int*, const Params) =
      resident ? fused_epoch_kernel<true> : fused_epoch_kernel<false>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<1, 32, (size_t)bytes, (cudaStream_t)stream>>>((int*)blob, prm);
  return (int)cudaGetLastError();
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

#endif  // __CUDACC__
