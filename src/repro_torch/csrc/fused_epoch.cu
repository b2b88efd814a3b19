// The fused epoch core for Hopper (sm_90a): a whole epoch of simulator
// ticks over one packed int32 "blob", in the oracle's exact event order.
//
// Replaces src/repro/core/fused.py:714 make_epoch_fn: a jitted
// lax.while_loop over the tick, NOT a pl.pallas_call.  The reference
// writes the tick as nested lax.fori_loops with lax.cond / lax.switch at
// every step and runs each loop to its static bound under a mask (the
// WCAP wire slots, PC plan rows twice an ACK, F x PC timer rows, B
// packets three times a batch); as torch operations that would be 10^4
// to 10^5 tiny launches a tick.  On a GPU it is one thread's sequential
// state machine, so here it is exactly that:
//   * one block of one warp; lane 0 runs epoch()'s loop over tick()
//     until abort, a watermark hit, idle >= idle_done or steps >=
//     max_ticks, with plain branches for the conds and switches and
//     loops over live entries only;
//   * the blob stays in device memory, updated in place (the reference
//     donates it) and read through L1; the field offsets, sizes, DEL,
//     LDST and the loss / ECN / jitter / reorder / watermark switches
//     come as launch parameters (Params, from
//     kernels/fused_epoch.py:params), so one build serves every shape
//     key;
//   * the due wire slots and one delivery batch live in dynamic shared
//     memory: WCAP + 10 x the largest batch + F words.
//
// Bound on the H100: one thread's chain of dependent steps (a load, a
// compare, a branch, a store, each waiting on the last), not bytes or
// operations: an epoch reads and writes the blob once as its bound by
// bytes (tens of KB, well under a microsecond at 3.35 TB/s), but every
// event of every tick runs after the one before it.  Later levers (not
// taken here): the blob in shared memory, warp-wide mask and selection
// steps, several worlds an SM.
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
// plain C++, so it can be compiled for the host against the plain
// version without a card.
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FE_DEV __device__ __forceinline__
#else
#define FE_DEV inline
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

#ifdef __CUDACC__
FE_DEV int popc32(uint32_t x) { return __popc(x); }
FE_DEV int clz32(uint32_t x) { return __clz((int)x); }
#else
inline int popc32(uint32_t x) { return __builtin_popcount(x); }
inline int clz32(uint32_t x) { return x ? __builtin_clz(x) : 32; }
#endif

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

struct Epoch {
  int* b;
  const Params* p;
  // shared-memory scratch: due wire slots, one batch, per-flow CE tally
  int *due, *bf, *bp, *bk, *ba, *bs, *be, *oack, *oap, *osk, *onak, *ecnf;

  FE_DEV void init(int* blob, const Params* prm, int* smem) {
    b = blob;
    p = prm;
    due = smem;
    int* q = smem + p->WCAP;
    int** rows[10] = {&bf, &bp, &bk, &ba, &bs, &be, &oack, &oap, &osk, &onak};
    for (int i = 0; i < 10; ++i) {
      *rows[i] = q;
      q += p->bmax;
    }
    ecnf = q;
  }

  FE_DEV int* fld(int f) const { return b + p->off[f]; }
  FE_DEV int& g(int f) const { return b[p->off[f]]; }
  FE_DEV void inc(int f, int i, int n = 1) const {
    int* a = fld(f);
    a[i] = add32(a[i], n);
  }

  // ---- wire / ring ----------------------------------------------------
  FE_DEV void wire_push(int arr, int loc, int seqv, int f, int kind,
                        int pidx, int ap, int sack) {
    int* wv = fld(W_VALID);
    int slot = 0;                  // argmin: the first free, else slot 0
    for (int s = 0; s < p->WCAP; ++s) {
      if (wv[s] == 0) {
        slot = s;
        break;
      }
    }
    g(ABORT) |= wv[slot];          // a full wire overwrites slot 0
    wv[slot] = 1;
    fld(W_ARR)[slot] = arr;
    fld(W_SEQ)[slot] = seqv;
    fld(W_DST)[slot] = loc;
    fld(W_FLOW)[slot] = f;
    fld(W_PIDX)[slot] = pidx;
    fld(W_KIND)[slot] = kind;
    fld(W_AP)[slot] = ap;
    fld(W_SACK)[slot] = sack;
  }

  FE_DEV void ring_enq(int dst, int f, int kind, int pidx, int ap,
                       int sack) {
    const int rcap = p->RCAP;
    int depth = fld(R_LEN)[dst];
    if (depth >= rcap) {
      inc(PT_TDROP, dst);
      return;
    }
    int slot = (fld(R_HEAD)[dst] + depth) % rcap;
    int i = dst * rcap + slot;
    fld(R_FLOW)[i] = f;
    fld(R_PIDX)[i] = pidx;
    fld(R_KIND)[i] = kind;
    fld(R_AP)[i] = ap;
    fld(R_SACK)[i] = sack;
    inc(R_LEN, dst);
    inc(PT_ENQ, dst);
    int* md = fld(PT_MAXD);
    if (depth + 1 > md[dst]) md[dst] = depth + 1;
  }

  // ---- transmit (net.send from RdmaNode._send) --------------------------
  FE_DEV void send(int src, int f, int kind, int pidx, int ap, int sack) {
    const int now = g(NOW);
    inc(N_TX, src);
    if (p->star) {
      int dst = kind == 0 ? fld(F_RCV)[f] : fld(F_SND)[f];
      g(INJECTED_D) = add32(g(INJECTED_D), 1);
      if (p->loss_on) {
        uint32_t h = hash32((uint32_t)g(CSEED), kTagLoss, now, g(CSEND));
        g(CSEND) = add32(g(CSEND), 1);
        if (h < (uint32_t)g(LOSS_T)) {
          inc(PT_WDROP, dst);
          return;
        }
      }
      int seqv = add32(g(SEQ), 1);
      g(SEQ) = seqv;
      wire_push(add32(now, fld(DELAY)[src]), dst, seqv, f, kind, pidx, ap,
                sack);
      return;
    }
    int link = kind == 0 ? fld(F_LDATA)[f] : fld(F_LCTRL)[f];
    inc(L_SENT_D, link);
    int rank = fld(L_CIDX)[link];
    inc(L_CIDX, link);
    uint32_t seed = (uint32_t)fld(L_SEED)[link];
    if (p->loss_on &&
        hash32(seed, kTagLoss, now, rank) < (uint32_t)fld(L_LOSS_T)[link]) {
      inc(L_DROP_D, link);
      return;
    }
    uint32_t delay = (uint32_t)fld(L_LAT)[link];
    if (p->jit_on)
      delay += hash32(seed, kTagJitter, now, rank) %
               ((uint32_t)fld(L_JITTER)[link] + 1u);
    if (p->reo_on && hash32(seed, kTagReorder, now, rank) <
                         (uint32_t)fld(L_REORDER_T)[link])
      delay += 1u + hash32(seed, kTagRdelay, now, rank) % 7u;
    int seqv = add32(fld(L_SEQ)[link], 1);
    fld(L_SEQ)[link] = seqv;
    wire_push((int)((uint32_t)now + delay), link, seqv, f, kind, pidx, ap,
              sack);
  }

  FE_DEV void send_data(int f, int row) {
    send(fld(F_SND)[f], f, 0, row, 0, 0);
  }
  FE_DEV void send_ctrl(int f, int kind, int ap, int sack) {
    send(fld(F_RCV)[f], f, kind, 0, ap, sack);
  }

  // ---- retransmit bump (retransmit._bump + rdma._send_retx) -------------
  FE_DEV void bump_send(int f, int row) {
    int i = f * p->PC + row;
    int r = add32(fld(P_RETR)[i], 1);
    fld(P_RETR)[i] = r;
    if (r > kMaxRetries) {
      g(ABORT) |= 1;
      return;
    }
    uint32_t shift = r < 4 ? (uint32_t)r : 4u;
    fld(P_DL)[i] = (int)((uint32_t)g(NOW) +
                         (uint32_t)fld(F_TIMEOUT)[f] * (1u << shift));
    inc(N_RETX, fld(F_SND)[f]);
    send_data(f, row);
  }

  // ---- control-plane handlers -------------------------------------------
  FE_DEV void on_ack(int f, int ap, int sack) {
    const int PC = p->PC, CC = p->CC, now = g(NOW);
    int* held = fld(P_HELD) + f * PC;
    int* retr = fld(P_RETR) + f * PC;
    const uint32_t base = (uint32_t)fld(F_BASE)[f];
    const uint32_t uap = (uint32_t)ap, usack = (uint32_t)sack;
    int n1 = 0, n2 = 0;
    // cumulative release, then selective release (bit j >= 1 -> ap+1+j)
    for (int row = 0; row < PC; ++row) {
      if (held[row] <= 0) {
        held[row] = 0;
        continue;
      }
      uint32_t psn = (base + row) & kMask;
      if (((uap - psn) & kMask) <= kHalf) {
        ++n1;
        held[row] = 0;
        continue;
      }
      uint32_t off2 = (psn - uap - 1u) & kMask;
      if (sack != 0 && off2 >= 1 && off2 <= 31 && ((usack >> off2) & 1u)) {
        ++n2;
        held[row] = 0;
        continue;
      }
      held[row] = 1;
    }
    if (n1 > 0 || n2 > 0)
      for (int row = 0; row < PC; ++row)
        if (held[row]) retr[row] = 0;
    inc(N_SACKED, fld(F_SND)[f], n2);
    // SACK-driven gap resend (rdma._maybe_gap_resend); bumps leave
    // p_held as it is, so the mask read row by row is the one taken
    // before the first bump
    if (sack != 0 && !(sub32(now, fld(F_LAST_GAP)[f]) < kNakHoldoff)) {
      const uint32_t hi = (uap + (uint32_t)(32 - clz32(usack))) & kMask;
      const int gap_lag = fld(F_GAP_LAG)[f];
      bool any = false;
      for (int row = 0; row < PC; ++row) {
        if (!held[row]) continue;
        uint32_t psn = (base + row) & kMask;
        uint32_t offg = (psn - uap) & kMask;
        uint32_t lag = (hi - psn) & kMask;
        if (offg > 0 && offg <= kHalf && lag <= kHalf &&
            (int)lag >= gap_lag) {
          if (!any) {
            any = true;
            fld(F_LAST_GAP)[f] = now;
            fld(F_LAST_GAP_W)[f] = 1;
          }
          bump_send(f, row);
        }
      }
    }
    // ACK-clocked flow control (flow_control.ack + _drain + dispatch)
    int rel = n1 + n2 > 1 ? n1 + n2 : 1;
    int out0 = sub32(fld(F_OUT)[f], rel);
    if (out0 < 0) out0 = 0;
    int bud = add32(fld(F_BUDGET)[f], rel);
    if (fld(F_WINDOW)[f] < bud) bud = fld(F_WINDOW)[f];
    const int cur0 = fld(F_CURSOR)[f], nch = fld(F_NCHUNKS)[f];
    const int* cnp = fld(C_NP) + f * CC;
    int taken = 0, tot = 0;
    for (int k = 0; k < CC; ++k) {
      if (cur0 + k >= nch) break;
      int idx = cur0 + k < CC - 1 ? cur0 + k : CC - 1;
      if (cnp[idx] > bud) break;
      bud = sub32(bud, cnp[idx]);
      ++taken;
      tot = add32(tot, cnp[idx]);
    }
    const int nxt0 = fld(F_NEXT)[f];
    inc(F_CURSOR, f, taken);
    inc(F_NEXT, f, tot);
    fld(F_OUT)[f] = add32(out0, tot);
    fld(F_BUDGET)[f] = bud;
    inc(F_TPASSED_D, f, taken);
    const int lim = tot < PC ? tot : PC;
    for (int k = 0; k < lim; ++k) {
      int row = nxt0 + k;
      if (row >= 0 && row < PC) {
        held[row] = 1;
        retr[row] = 0;
        fld(P_DL)[f * PC + row] = add32(now, fld(F_TIMEOUT)[f]);
      }
      send_data(f, row);
    }
  }

  FE_DEV void on_nak(int f, int ap) {
    const int PC = p->PC, now = g(NOW);
    if (sub32(now, fld(F_LAST_NAK)[f]) < kNakHoldoff) return;
    fld(F_LAST_NAK)[f] = now;
    fld(F_LAST_NAK_W)[f] = 1;
    const uint32_t expected = ((uint32_t)ap + 1u) & kMask;
    const uint32_t base = (uint32_t)fld(F_BASE)[f];
    const int* held = fld(P_HELD) + f * PC;
    for (int row = 0; row < PC; ++row) {
      uint32_t psn = (base + row) & kMask;
      if (held[row] > 0 && ((psn - expected) & kMask) <= kHalf)
        bump_send(f, row);
    }
  }

  // ---- the RX header FSM on one data packet (pipeline._rx_decide) ---------
  // Updates flow f's RX row; returns the packet's outputs.
  FE_DEV void rx_decide(int f, int pidx, int ecn, bool& accept,
                        bool& rkey_err, bool& ecn_echo, int& dma_addr,
                        bool& send_ack, bool& send_nak, int& ack_psn,
                        int& sack) {
    const int i = f * p->PC + pidx;
    const int op = fld(P_OP)[i], plen = fld(P_PLEN)[i];
    const int vaddr = fld(P_VADDR)[i], dlen = fld(P_DLEN)[i];
    const int ackreq = fld(P_ACKREQ)[i], rkey = fld(P_RKEY)[i];
    const uint32_t psn = ((uint32_t)fld(F_BASE)[f] + (uint32_t)pidx) & kMask;
    const int epsn = fld(RX_EPSN)[f], cred = fld(RX_CRED)[f];
    const int trk = fld(RX_RKEY)[f], rxbit = fld(RX_RXBIT)[f];
    const bool is_payload = payload_op(op), has_reth = reth_op(op);
    const bool is_last = last_op(op), sr = fld(RX_SRF)[f] > 0;
    const bool in_seq = (int)psn == epsn;
    const uint32_t d = (psn - (uint32_t)epsn) & kMask;
    const bool behind = d > kHalf, has_credit = cred > 0;
    // go-back-N
    const bool rkey_ok_g = !has_reth || trk == 0 || rkey == trk;
    const bool accept_g = is_payload && in_seq && has_credit && rkey_ok_g;
    const bool dropped_g = is_payload && in_seq && !has_credit && rkey_ok_g;
    const bool rkey_err_g = is_payload && in_seq && !rkey_ok_g;
    const int start_addr = has_reth ? vaddr : fld(RX_CUR)[f];
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
    bool dup, ooo, dropped;
    int new_epsn, new_rxbit;
    if (sr) {
      accept = accept_s; dup = dup_s; ooo = ooo_s; dropped = dropped_s;
      rkey_err = rkey_err_s; dma_addr = vaddr;
      new_epsn = new_epsn_s; new_rxbit = new_rxbit_s;
    } else {
      accept = accept_g; dup = behind && is_payload;
      ooo = !in_seq && !behind && is_payload; dropped = dropped_g;
      rkey_err = rkey_err_g; dma_addr = start_addr;
      new_epsn = new_epsn_g; new_rxbit = rxbit;
    }
    if (accept) {
      fld(RX_CUR)[f] = add32(dma_addr, plen);
      fld(RX_BYTES)[f] = (has_reth || sr) ? sub32(dlen, plen)
                                          : sub32(fld(RX_BYTES)[f], plen);
      if (is_last) inc(RX_MSN, f);
      fld(RX_CRED)[f] = sub32(cred, 1);
    }
    ecn_echo = ecn > 0 && is_payload;
    fld(RX_EPSN)[f] = new_epsn;
    fld(RX_RXBIT)[f] = new_rxbit;
    inc(RX_ACC, f, accept);
    inc(RX_DUP, f, dup);
    inc(RX_OOO, f, ooo);
    inc(RX_CDROP, f, dropped);
    inc(RX_ECN, f, ecn_echo);
    ack_psn = (!sr && accept) ? (int)psn
                              : (int)(((uint32_t)new_epsn - 1u) & kMask);
    send_ack = (accept && (is_last || ackreq > 0 ||
                           (sr && (d > 0 || adv > 1)))) || dup;
    send_nak = ooo;
    sack = sr ? new_rxbit_s : 0;
  }

  // ---- one delivered batch of n packets through node dst --------------
  FE_DEV void process_batch(int grp, int dst, int n) {
    const int F = p->F;
    inc(N_RX, dst, n);
    for (int i = 0; i < n; ++i) {                // pass A: control packets
      const int f = bf[i];
      if (bk[i] == 1) on_ack(f, ba[i], bs[i]);
      else if (bk[i] == 2) on_nak(f, ba[i]);
      else if (bk[i] == 3) inc(N_CNPRX, fld(F_SND)[f]);
    }
    bool anydata = false;                        // credit column reset
    for (int i = 0; i < n; ++i) anydata |= bk[i] == 0;
    if (anydata)
      for (int f = 0; f < F; ++f)
        if (fld(F_RCV)[f] == dst) fld(RX_CRED)[f] = fld(F_MAXCRED)[f];
    for (int f = 0; f < F; ++f) ecnf[f] = 0;
    for (int i = 0; i < n; ++i) {                // pass E: data packets
      oack[i] = onak[i] = 0;
      if (bk[i] != 0) continue;
      const int f = bf[i], pidx = bp[i];
      bool accept, rkey_err, ecn_echo, send_ack, send_nak;
      int dma_a, ack_psn, sack;
      rx_decide(f, pidx, be[i], accept, rkey_err, ecn_echo, dma_a, send_ack,
                send_nak, ack_psn, sack);
      g(ABORT) |= (int)rkey_err;
      ecnf[f] += ecn_echo;
      if (accept) {
        const int k = f * p->PC + pidx;
        const int aseq = g(ACC_CTR);
        g(ACC_CTR) = add32(aseq, 1);
        fld(P_ACC)[k] = 1;
        fld(P_ASEQ)[k] = aseq;
        fld(P_AADDR)[k] = dma_a;
        if (fld(RX_SRF)[f] <= 0) {
          int wm = add32(dma_a, fld(P_PLEN)[k]);
          if (wm > fld(F_WM)[f]) fld(F_WM)[f] = wm;
        }
      }
      oack[i] = send_ack;
      onak[i] = send_nak;
      oap[i] = ack_psn;
      osk[i] = sack;
    }
    if (p->ecn_on) {                             // CNPs, QPN-ascending
      const int now = g(NOW);
      const int* ord = fld(CNP_ORD) + grp * F;
      for (int k = 0; k < F; ++k) {
        const int f = ord[k];
        if (f < 0 || ecnf[f] <= 0) continue;
        if (sub32(now, fld(F_LAST_CNP)[f]) < kCnpHoldoff) continue;
        fld(F_LAST_CNP)[f] = now;
        fld(F_LAST_CNP_W)[f] = 1;
        inc(N_CNPTX, dst);
        send_ctrl(f, 3, 0, 0);
      }
    }
    for (int i = 0; i < n; ++i) {                // pass D: ACK / NAK
      if (bk[i] != 0) continue;
      if (oack[i]) send_ctrl(bf[i], 1, oap[i], osk[i]);
      if (onak[i]) send_ctrl(bf[i], 2, oap[i], 0);
    }
  }

  // due wire slots (of one link, or all for link < 0) into due[], in pop
  // order: (arrival, seq), then slot
  FE_DEV int collect_due(int link) {
    const int now = g(NOW);
    const int *wv = fld(W_VALID), *arr = fld(W_ARR), *seq = fld(W_SEQ);
    const int* wd = fld(W_DST);
    int n = 0;
    for (int s = 0; s < p->WCAP; ++s) {
      if (wv[s] <= 0 || arr[s] > now || (link >= 0 && wd[s] != link))
        continue;
      int j = n++;
      while (j > 0) {             // insertion sort: few slots fall due a tick
        int t = due[j - 1];
        if (arr[t] < arr[s] || (arr[t] == arr[s] && seq[t] <= seq[s])) break;
        due[j] = t;
        --j;
      }
      due[j] = s;
    }
    return n;
  }

  // ---- one network tick (netsim.tick + rdma.step_network) ---------------
  FE_DEV void tick() {
    const int now = add32(g(NOW), 1);
    g(NOW) = now;
    if (p->star) {
      const int rcap = p->RCAP;
      if (p->loss_on || p->ecn_on) {
        g(CSEND) = 0;
        g(CPOP) = 0;
      }
      const int nd = collect_due(-1);            // due packets -> rings
      for (int i = 0; i < nd; ++i) {
        const int s = due[i];
        fld(W_VALID)[s] = 0;
        ring_enq(fld(W_DST)[s], fld(W_FLOW)[s], fld(W_KIND)[s],
                 fld(W_PIDX)[s], fld(W_AP)[s], fld(W_SACK)[s]);
      }
      for (int port = 0; port < p->P; ++port) {  // drain each port
        const int B = p->del[port];
        if (B == 0) continue;
        const int len0 = fld(R_LEN)[port], head0 = fld(R_HEAD)[port];
        int n_pop = B < len0 ? B : len0;
        if (n_pop > p->bmax) n_pop = p->bmax;
        for (int j = 0; j < n_pop; ++j) {
          const int slot = (head0 + j) % rcap;
          const int k = port * rcap + slot;
          int mark = 0;
          if (p->ecn_on) {
            const int depth = len0 - j;
            const int rank = g(CPOP);
            g(CPOP) = add32(rank, 1);
            uint32_t h = hash32((uint32_t)g(CSEED), kTagRed, now, rank);
            mark = depth >= g(KMAX) ||
                   (depth > g(KMIN) && h < (uint32_t)fld(RED_T)[depth]);
            inc(PT_ECN, port, mark);
          }
          bf[j] = fld(R_FLOW)[k];
          bp[j] = fld(R_PIDX)[k];
          bk[j] = fld(R_KIND)[k];
          ba[j] = fld(R_AP)[k];
          bs[j] = fld(R_SACK)[k];
          be[j] = mark;
        }
        fld(R_HEAD)[port] = (head0 + n_pop) % rcap;
        inc(R_LEN, port, -n_pop);
        inc(PT_DEL, port, n_pop);
        process_batch(port, port, n_pop);
      }
    } else {
      if (p->loss_on || p->jit_on || p->reo_on)
        for (int l = 0; l < p->L; ++l) fld(L_CIDX)[l] = 0;
      for (int li = 0; li < p->L; ++li) {        // deliver, link order
        const int nd = collect_due(li);
        int n = nd < p->del[li] ? nd : p->del[li];
        if (n > p->bmax) n = p->bmax;
        for (int j = 0; j < n; ++j) {
          const int s = due[j];
          fld(W_VALID)[s] = 0;
          bf[j] = fld(W_FLOW)[s];
          bp[j] = fld(W_PIDX)[s];
          bk[j] = fld(W_KIND)[s];
          ba[j] = fld(W_AP)[s];
          bs[j] = fld(W_SACK)[s];
          be[j] = 0;
        }
        process_batch(li, p->ldst[li], n);
      }
    }
    // retransmission timers (rdma.tick, node x QPN order)
    const int PC = p->PC, F = p->F;
    for (int k = 0; k < F; ++k) {
      const int f = fld(T_ORDER)[k];
      for (int row = 0; row < PC; ++row) {
        const int i = f * PC + row;
        if (fld(P_HELD)[i] > 0 && now >= fld(P_DL)[i]) bump_send(f, row);
      }
    }
    // idle / watermark accounting (rdma.run_network)
    bool pending = false;
    for (int s = 0; s < p->WCAP && !pending; ++s)
      pending = fld(W_VALID)[s] > 0;
    for (int i = 0; i < F * PC && !pending; ++i)
      pending = fld(P_HELD)[i] > 0;
    for (int f = 0; f < F && !pending; ++f)
      pending = fld(F_CURSOR)[f] < fld(F_NCHUNKS)[f];
    if (p->star)
      for (int q = 0; q < p->P && !pending; ++q)
        pending = fld(R_LEN)[q] > 0;
    g(IDLE) = pending ? 0 : add32(g(IDLE), 1);
    g(STEPS) = add32(g(STEPS), 1);
    if (p->wm_on) {
      int hit = 0;
      for (int f = 0; f < F; ++f)
        hit |= fld(F_WM_ARMED)[f] > 0 && fld(F_WM)[f] >= fld(F_WM_THRESH)[f];
      g(WM_HIT) = hit;
    }
  }

  FE_DEV void run() {
    while (g(ABORT) == 0 && g(WM_HIT) == 0 && g(IDLE) < g(IDLE_DONE) &&
           g(STEPS) < g(MAX_TICKS))
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

inline long scratch_words(const Params& prm) {
  return (long)prm.WCAP + 10L * prm.bmax + prm.F;
}

}  // namespace

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(32)
    fused_epoch_kernel(int* blob, const __grid_constant__ Params prm) {
  extern __shared__ int smem[];
  if (threadIdx.x != 0) return;
  Epoch e;
  e.init(blob, &prm, smem);
  e.run();
}

}  // namespace

extern "C" {

// One epoch on `stream`, in place on the device blob.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for parameters the
// kernel does not take).
int fused_epoch_launch(void* blob, const int* meta, int len, void* stream) {
  static_assert(sizeof(Params) <= 4096, "kernel parameters over 4 KB");
  Params prm;
  if (!read_params(&prm, meta, len)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)scratch_words(prm);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_epoch_kernel<<<1, 32, smem, (cudaStream_t)stream>>>((int*)blob,
                                                             prm);
  return (int)cudaGetLastError();
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

#endif  // __CUDACC__
