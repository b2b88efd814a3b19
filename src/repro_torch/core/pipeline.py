"""Vectorized RoCE v2 packet-processing pipeline (paper §4.1, Fig. 2),
as PyTorch tensor programs.

The per-QP tables are int32 tensors on the node's device.  Two engines
implement the same RX semantics, exactly as in ``repro.core.pipeline``:

``rx_pipeline``         — the per-packet oracle: one decision step per
                          packet in arrival order.
``rx_pipeline_batched`` — the batched multi-QP engine: packets are
                          stable-sorted by QP, ranked within their QP
                          segment and processed in *waves*: wave ``t``
                          handles the ``t``-th packet of every QP at
                          once, so the sequential depth is the longest
                          per-QP segment, not the batch size.

Both share ``_rx_decide``, the pure header FSM, so they cannot drift
apart; the CPU tests hold both, in both RX modes, bit for bit against
the reference engines.

Where JAX is silent and torch is not:
  * out-of-range scatters are *dropped* and gathers *clamped* in JAX;
    torch raises (CPU) or asserts on the device, so every index here is
    in range by construction or masked explicitly;
  * JAX's ``population_count`` / ``shift_right_logical`` on int32 become
    a SWAR popcount and a logical shift done in int64;
  * the tables stay int32 (x64 is off in the reference), so PSN and
    address arithmetic wraps the same way;
  * the batched engine's wave loop is a Python loop whose trip count is
    read to the host once per batch.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import packet as pk
from repro_torch.device import DeviceLike, resolve_device

I32 = torch.int32

# Selective-repeat receive window (packets).  Bit k of ``rxbit`` marks
# PSN ``epsn + k`` as received-but-not-yet-cumulative, so the window must
# fit a non-negative int32.
SR_WINDOW = 24


class RxTables(NamedTuple):
    """Per-QP RX state.  Every column is (Q,) int32 (the reference's
    docstring says int64 for ``bytes_left``/``cur_vaddr``, but builds
    them int32 because x64 is off; the port follows what it builds)."""
    epsn: torch.Tensor
    msn: torch.Tensor
    bytes_left: torch.Tensor
    cur_vaddr: torch.Tensor
    credits: torch.Tensor      # downstream capacity (§4.3)
    rkey: torch.Tensor         # registered buffer's rkey (read-only)
    rxbit: torch.Tensor        # SR bitmap: bit k = epsn+k received
    sr: torch.Tensor           # 1 = selective-repeat RX mode
    # telemetry counters (monotonic, per QP), harvested at epoch
    # boundaries by RdmaNode.engine_counters
    acc_cnt: torch.Tensor
    dup_cnt: torch.Tensor
    ooo_cnt: torch.Tensor
    cdrop_cnt: torch.Tensor
    ecn_tot: torch.Tensor


class RxResult(NamedTuple):
    accept: torch.Tensor       # (N,) bool   payload forwarded to DMA
    dup: torch.Tensor          # (N,) bool   duplicate (re-ACK, no DMA)
    ooo: torch.Tensor          # (N,) bool   out-of-order (NAK)
    dropped_credit: torch.Tensor  # (N,) bool dropped for lack of credits
    rkey_err: torch.Tensor     # (N,) bool   RETH rkey mismatch (NAK_PROT)
    dma_addr: torch.Tensor     # (N,) int32  target address
    dma_len: torch.Tensor      # (N,) int32
    ack_psn: torch.Tensor      # (N,) int32  cumulative ack to send back
    ack_qpn: torch.Tensor      # (N,) int32
    send_ack: torch.Tensor     # (N,) bool
    send_nak: torch.Tensor     # (N,) bool
    sack: torch.Tensor         # (N,) int32  SR bitmap to ship with the ACK
    ecn_echo: torch.Tensor     # (N,) bool   CE-marked payload arrival
    ecn_cnt: torch.Tensor      # (Q,) int32  CE-marked arrivals per QP


@functools.lru_cache(maxsize=None)
def _opset(ops: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(ops, dtype=I32, device=device)


_LAST_OPS = (pk.WRITE_LAST, pk.WRITE_ONLY, pk.READ_RESP_LAST,
             pk.READ_RESP_ONLY)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of the low 32 bits (SWAR, in int64 so no shift is
    arithmetic)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _srl32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int32 lanes (torch's ``>>`` is arithmetic)."""
    return ((x.to(torch.int64) & 0xFFFFFFFF) >> s.to(torch.int64)).to(I32)


# ---------------------------------------------------------------------------
# Shared header FSM (used by both the scan oracle and the batched engine)
# ---------------------------------------------------------------------------

def _rx_decide(state: Dict[str, torch.Tensor], p: Dict[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The pure per-packet decision function of the RX header pipeline.

    ``state`` holds the packet's QP-table row (gathered); ``p`` the
    packet header fields; both (N,) int32 lanes.  Returns the updated
    row and the per-packet outputs."""
    opcode = p["opcode"]
    dev = opcode.device
    psn = p["psn"]
    plen = p["plen"].to(I32)
    epsn = state["epsn"]
    credits = state["credits"]

    is_payload = torch.isin(opcode, _opset(pk.PAYLOAD_OPS, dev))
    has_reth = torch.isin(opcode, _opset(pk.RETH_OPS, dev))
    is_last = torch.isin(opcode, _opset(_LAST_OPS, dev))

    valid = p["valid"] > 0
    sr = state["sr"] > 0

    in_seq = psn == epsn
    behind = (psn - epsn) % (pk.PSN_MASK + 1) > (pk.PSN_MASK // 2)
    has_credit = credits > 0

    # ---- go-back-N verdicts --------------------------------------------
    ooo_g = ~in_seq & ~behind
    # remote-access protection (§4.6); table rkey 0 = nothing registered
    rkey_ok_g = ~has_reth | (state["rkey"] == 0) | (p["rkey"] == state["rkey"])

    accept_g = is_payload & in_seq & has_credit & rkey_ok_g & valid
    dropped_g = is_payload & in_seq & ~has_credit & rkey_ok_g & valid
    rkey_err_g = is_payload & in_seq & ~rkey_ok_g & valid

    start_addr = torch.where(has_reth, p["vaddr"], state["cur_vaddr"])
    new_epsn_g = torch.where(accept_g, (epsn + 1) & pk.PSN_MASK, epsn)

    # ---- selective-repeat verdicts ---------------------------------------
    d = ((psn - epsn) % (pk.PSN_MASK + 1)).to(I32)
    in_win = ~behind & (d < SR_WINDOW)
    one = torch.ones_like(d)
    bit = torch.where(in_win, one << torch.clamp(d, max=SR_WINDOW - 1),
                      torch.zeros_like(d))
    already = (state["rxbit"] & bit) != 0
    fresh = in_win & ~already
    rkey_ok_s = (state["rkey"] == 0) | (p["rkey"] == state["rkey"])
    accept_s = is_payload & fresh & has_credit & rkey_ok_s & valid
    dropped_s = is_payload & fresh & ~has_credit & rkey_ok_s & valid
    rkey_err_s = is_payload & fresh & ~rkey_ok_s & valid
    dup_s = (behind | already) & is_payload
    ooo_s = ~behind & ~in_win & is_payload          # beyond the window

    # bitmap update + cumulative advance over the contiguous prefix:
    # ctz(~bm) = popcount((~bm & -~bm) - 1)
    bm = state["rxbit"] | torch.where(accept_s, bit, torch.zeros_like(bit))
    inv = ~bm
    adv = _popcount32((inv & -inv) - 1).to(I32)
    new_epsn_s = (epsn + adv) & pk.PSN_MASK
    new_rxbit_s = _srl32(bm, adv)

    # ---- merge the two FSMs (per-QP mode select) -------------------------
    accept = torch.where(sr, accept_s, accept_g)
    dup = torch.where(sr, dup_s, behind & is_payload)
    ooo = torch.where(sr, ooo_s, ooo_g & is_payload)
    dropped_credit = torch.where(sr, dropped_s, dropped_g)
    rkey_err = torch.where(sr, rkey_err_s, rkey_err_g)
    dma_addr = torch.where(sr, p["vaddr"], start_addr)
    new_epsn = torch.where(sr, new_epsn_s, new_epsn_g)
    new_rxbit = torch.where(sr, new_rxbit_s, state["rxbit"])

    new_cur = torch.where(accept, dma_addr + plen, state["cur_vaddr"])
    new_bytes = torch.where(
        (has_reth | sr) & accept, p["dma_len"].to(I32) - plen,
        torch.where(accept, state["bytes_left"] - plen, state["bytes_left"]))
    new_msn = torch.where(accept & is_last, state["msn"] + 1, state["msn"])
    new_credits = torch.where(accept, credits - 1, credits)
    ecn_echo = (p["ecn"] > 0) & is_payload & valid

    new_state = {
        "epsn": new_epsn.to(I32),
        "msn": new_msn.to(I32),
        "bytes_left": new_bytes.to(I32),
        "cur_vaddr": new_cur.to(I32),
        "credits": new_credits.to(I32),
        "rkey": state["rkey"],
        "rxbit": new_rxbit.to(I32),
        "sr": state["sr"],
        # dup/ooo need the explicit ``valid`` gate (padding lanes)
        "acc_cnt": state["acc_cnt"] + accept.to(I32),
        "dup_cnt": state["dup_cnt"] + (dup & valid).to(I32),
        "ooo_cnt": state["ooo_cnt"] + (ooo & valid).to(I32),
        "cdrop_cnt": state["cdrop_cnt"] + dropped_credit.to(I32),
        "ecn_tot": state["ecn_tot"] + ecn_echo.to(I32),
    }
    out = {
        "accept": accept, "dup": dup, "ooo": ooo,
        "dropped_credit": dropped_credit, "rkey_err": rkey_err,
        "dma_addr": dma_addr.to(I32),
        "dma_len": plen,
        # cumulative ACK: accepted in-order packets ack their own PSN
        "ack_psn": torch.where(~sr & accept, psn,
                               (new_epsn - 1) & pk.PSN_MASK).to(I32),
        "ack_qpn": p["qpn"].to(I32),
        "send_ack": (accept & (is_last | (p["ack_req"] > 0) |
                               (sr & ((d > 0) | (adv > 1))))) | dup,
        "send_nak": ooo,
        "sack": torch.where(sr, new_rxbit_s, torch.zeros_like(new_rxbit_s)
                            ).to(I32),
        "ecn_echo": ecn_echo,
    }
    return new_state, out


_PKT_FIELDS = ("qpn", "opcode", "psn", "plen", "vaddr", "dma_len", "ack_req",
               "ecn", "rkey", "valid")
_STATE_FIELDS = ("epsn", "msn", "bytes_left", "cur_vaddr", "credits", "rkey",
                 "rxbit", "sr",
                 "acc_cnt", "dup_cnt", "ooo_cnt", "cdrop_cnt", "ecn_tot")
# the counter subset, exposed for epoch-boundary harvesting
COUNTER_FIELDS = ("acc_cnt", "dup_cnt", "ooo_cnt", "cdrop_cnt", "ecn_tot")

_OUT_KEYS = ("accept", "dup", "ooo", "dropped_credit", "rkey_err",
             "dma_addr", "dma_len", "ack_psn", "ack_qpn", "send_ack",
             "send_nak", "sack", "ecn_echo")
_OUT_BOOL = ("accept", "dup", "ooo", "dropped_credit", "rkey_err",
             "send_ack", "send_nak", "ecn_echo")


def _header(batch: Dict[str, np.ndarray], device) -> torch.Tensor:
    """The header columns of a host batch (``packet.batch_from_packets``
    numpy columns) as one (fields, N) int32 matrix on ``device``, in one
    copy.  Batches built before the ECN / rkey-check eras lack those
    columns; they default to not-marked / key 0.  int64 columns
    (``vaddr``) wrap to int32 as the reference's x64-off conversion
    does."""
    n = len(batch["qpn"])
    rows = [np.asarray(batch[k]).astype(np.int32) if k in batch
            else np.zeros(n, np.int32) for k in _PKT_FIELDS]
    return torch.from_numpy(np.stack(rows)).to(device)


def rx_pipeline(tables: RxTables, batch: Dict[str, np.ndarray]
                ) -> Tuple[RxTables, RxResult]:
    """Per-packet oracle: the RX FSM over the batch in arrival order,
    one packet per step.  The reference semantics the batched engine
    must reproduce bit for bit; meant for tests, not the card's hot
    path.  Out-of-range QPNs read the last row and write nothing, as
    JAX's clamped gather and dropped scatter do."""
    dev = tables.epsn.device
    hdr = _header(batch, dev)
    n = hdr.shape[1]
    n_qps = tables.epsn.shape[0]
    cols = {f: getattr(tables, f).clone() for f in _STATE_FIELDS}
    outs = {k: [] for k in _OUT_KEYS}
    qpns = hdr[0].tolist()
    for i in range(n):
        q = min(max(qpns[i], 0), n_qps - 1)
        state = {f: cols[f][q:q + 1] for f in _STATE_FIELDS}
        p = {k: hdr[j, i:i + 1] for j, k in enumerate(_PKT_FIELDS)}
        new_state, out = _rx_decide(state, p)
        if 0 <= qpns[i] < n_qps:
            for f in _STATE_FIELDS:
                cols[f][q] = new_state[f][0]
        for k in _OUT_KEYS:
            outs[k].append(out[k])
    res = {k: (torch.cat(v) if v else
               torch.zeros(0, dtype=torch.bool if k in _OUT_BOOL else I32,
                           device=dev))
           for k, v in outs.items()}
    # per-QP CE tally; out-of-range QPNs are dropped
    qpn = hdr[0]
    ok = (qpn >= 0) & (qpn < n_qps)
    res["ecn_cnt"] = torch.zeros(n_qps, dtype=I32, device=dev).index_add_(
        0, torch.where(ok, qpn, torch.zeros_like(qpn)),
        (res["ecn_echo"] & ok).to(I32))
    return RxTables(**cols), RxResult(**{k: res[k] for k in RxResult._fields})


# ---------------------------------------------------------------------------
# Batched multi-QP engine
# ---------------------------------------------------------------------------

def rx_pipeline_batched(tables: RxTables, batch: Dict[str, np.ndarray]
                        ) -> Tuple[RxTables, RxResult]:
    """Batched multi-QP RX engine (paper §4.1 at scale).

      1. one stable sort by QP turns per-QP arrival order into
         contiguous segments; segment lengths come from a
         ``searchsorted`` over the sorted keys;
      2. each active QP gets a dense *slot*, ordered by descending
         segment length, so the QPs still alive in wave ``t`` are the
         slot prefix ``[0, m_t)`` of width ``W = min(Q, N)``;
      3. wave ``t`` gathers slot ``s``'s ``t``-th packet, runs one
         vectorized ``_rx_decide`` and writes its outputs as one block
         at column ``start[t]`` of a packed (rank, slot) output matrix.

    The trip count (the longest segment) is read to the host once per
    batch.  Bit-identical to ``rx_pipeline`` on valid lanes; invalid
    (padding) lanes yield all-zero outputs.  Returns new tables; the
    input tables are not modified."""
    dev = tables.epsn.device
    hdr = _header(batch, dev)
    n = hdr.shape[1]
    n_qps = tables.epsn.shape[0]
    w = min(n_qps, n)                           # wave width
    qpn_row = hdr[_PKT_FIELDS.index("qpn")]
    valid = hdr[_PKT_FIELDS.index("valid")] > 0
    # invalid lanes -> sentinel group n_qps.  The clamp only keeps every
    # index in range: a valid QPN past the table (which RdmaNode never
    # produces) gets unspecified outputs here, as it does in JAX
    key = torch.where(valid, torch.clamp(qpn_row, 0, n_qps),
                      torch.full_like(qpn_row, n_qps))
    idx = torch.arange(n, dtype=I32, device=dev)

    # one stable sort by QP; pack (key, lane) into one int32 when it fits
    if (n_qps + 1) * n + n < 2 ** 31:
        packed = torch.sort(key * n + idx).values
        sk = packed // n
        order_k = packed - sk * n
    else:
        order_k = torch.argsort(key, stable=True).to(I32)
        sk = key[order_k.long()]
    # header fields in sorted order, padded by W so wave gathers of live
    # lanes stay in bounds (dead lanes are clamped in the loop)
    fmat = torch.cat([hdr[:, order_k.long()],
                      torch.zeros((len(_PKT_FIELDS), w), dtype=I32,
                                  device=dev)], dim=1)

    # per-QP segment lengths from the sorted keys
    bounds = torch.searchsorted(
        sk, torch.arange(n_qps + 1, dtype=I32, device=dev)).to(I32)
    counts = bounds[1:] - bounds[:-1]              # (Q,) valid pkts per QP
    seg_off_qp = bounds[:-1]
    rank_sorted = idx - bounds[sk.long()]          # rank within segment

    # dense slots ordered by descending segment length
    slot_to_qp = torch.argsort(-counts, stable=True)[:w]
    qp_to_slot = torch.full((n_qps + 1,), w, dtype=I32, device=dev)
    qp_to_slot[slot_to_qp] = torch.arange(w, dtype=I32, device=dev)
    slot_len = counts[slot_to_qp]                  # nonincreasing
    seg_off_slot = seg_off_qp[slot_to_qp]

    # wave t spans output columns [start[t], start[t] + m[t]) where
    # m[t] = #slots with segment length > t (a slot prefix)
    n_waves = int(slot_len[0]) if w else 0         # the one host read
    m_arr = torch.searchsorted(
        -slot_len, -torch.arange(n + 1, dtype=I32, device=dev)).to(I32)
    start_arr = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                           torch.cumsum(m_arr, 0, dtype=I32)])

    # (rank, slot) output position of every lane; invalid lanes go last
    n_valid = bounds[n_qps]
    pos_sorted = torch.where(sk == n_qps, n_valid + rank_sorted,
                             start_arr[rank_sorted.long()]
                             + qp_to_slot[sk.long()])
    # inverse permutation: original lane -> output position
    if n * (n + w) + (n + w) < 2 ** 31:
        pos = torch.sort(order_k * (n + w) + pos_sorted).values % (n + w)
    else:
        pos = torch.zeros(n, dtype=I32, device=dev)
        pos[order_k.long()] = pos_sorted

    state = {f: getattr(tables, f)[slot_to_qp] for f in _STATE_FIELDS}
    outs = torch.zeros((len(_OUT_KEYS), n + w), dtype=I32, device=dev)
    lanes = torch.arange(w, dtype=I32, device=dev)
    for t in range(n_waves):
        # slot s -> its t-th packet; dead slots are clamped, masked out
        # of the state update and overwritten by later waves' outputs
        lane_idx = torch.clamp(seg_off_slot + t, max=n + w - 1)
        block = fmat[:, lane_idx.long()]
        p = {k: block[i] for i, k in enumerate(_PKT_FIELDS)}
        new_state, out = _rx_decide(state, p)
        live = lanes < m_arr[t]
        state = {f: torch.where(live, new_state[f], state[f])
                 for f in _STATE_FIELDS}
        cols = (start_arr[t] + lanes).long()       # start[t] <= n: in range
        outs[:, cols] = torch.stack([out[k].to(I32) for k in _OUT_KEYS])

    new_tables = {}
    for f in _STATE_FIELDS:
        col = getattr(tables, f).clone()
        col[slot_to_qp] = state[f]
        new_tables[f] = col
    unsorted = torch.where(valid, outs[:, pos.long()],
                           torch.zeros((), dtype=I32, device=dev))
    res = {}
    for i, k in enumerate(_OUT_KEYS):
        res[k] = unsorted[i] > 0 if k in _OUT_BOOL else unsorted[i]
    # per-QP CE tally as a segmented reduction over the sorted layout
    ecn_s = fmat[_PKT_FIELDS.index("ecn"), :n]
    opc_s = fmat[_PKT_FIELDS.index("opcode"), :n]
    flag = ((ecn_s > 0) & (sk < n_qps) &
            torch.isin(opc_s, _opset(pk.PAYLOAD_OPS, dev)))
    csum = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                      torch.cumsum(flag.to(I32), 0, dtype=I32)])
    res["ecn_cnt"] = (csum[bounds[1:].long()]
                      - csum[bounds[:-1].long()]).to(I32)
    return RxTables(**new_tables), RxResult(**{k: res[k]
                                               for k in RxResult._fields})


class TxTables(NamedTuple):
    npsn: torch.Tensor         # (Q,) int32
    msn: torch.Tensor          # (Q,) int32


def tx_pipeline(tables: TxTables, cmds: Dict[str, torch.Tensor]
                ) -> Tuple[TxTables, Dict[str, torch.Tensor]]:
    """TX path oracle: assign consecutive PSNs per command (one command
    = one message of n_pkts fragments) and bump nPSN/MSN (§4.1 TX)."""
    npsn = tables.npsn.clone()
    msn = tables.msn.clone()
    qpn = torch.as_tensor(cmds["qpn"]).to(npsn.device).to(I32)
    n_pkts = torch.as_tensor(cmds["n_pkts"]).to(npsn.device).to(I32)
    starts = []
    for i in range(qpn.shape[0]):
        q = int(qpn[i])
        start = npsn[q].clone()
        npsn[q] = (start + n_pkts[i]) & pk.PSN_MASK
        msn[q] += 1
        starts.append(start.reshape(1))
    start_psn = torch.cat(starts) if starts else \
        torch.zeros(0, dtype=I32, device=npsn.device)
    return TxTables(npsn=npsn, msn=msn), {"start_psn": start_psn}


def tx_pipeline_batched(tables: TxTables, cmds: Dict[str, torch.Tensor]
                        ) -> Tuple[TxTables, Dict[str, torch.Tensor]]:
    """Batched TX engine: PSN-range assignment is a per-QP segmented
    exclusive cumulative sum.  Bit-identical to ``tx_pipeline``."""
    dev = tables.npsn.device
    qpn = torch.as_tensor(cmds["qpn"]).to(dev).to(I32)
    n_pkts = torch.as_tensor(cmds["n_pkts"]).to(dev).to(I32)
    n = qpn.shape[0]
    order = torch.argsort(qpn, stable=True)
    sq = qpn[order]
    sn = n_pkts[order]
    excl = torch.cumsum(sn, 0, dtype=I32) - sn     # exclusive prefix sum
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sq[1:] != sq[:-1]])
    # exclusive sum at each segment start, broadcast down the segment
    # (excl is nondecreasing, so a running max of the start values works)
    seg_base = torch.cummax(torch.where(is_start, excl,
                                        torch.zeros_like(excl)), 0).values
    start_sorted = (tables.npsn[sq.long()] + (excl - seg_base)) & pk.PSN_MASK
    start_psn = torch.zeros(n, dtype=I32, device=dev)
    start_psn[order] = start_sorted.to(I32)
    npsn = tables.npsn.clone().index_add_(0, qpn.long(), n_pkts) & pk.PSN_MASK
    msn = tables.msn.clone().index_add_(0, qpn.long(), torch.ones_like(qpn))
    return TxTables(npsn=npsn, msn=msn), {"start_psn": start_psn}


RX_ENGINES = {"scan": rx_pipeline, "batched": rx_pipeline_batched}
TX_ENGINES = {"scan": tx_pipeline, "batched": tx_pipeline_batched}


def clone_tables(t):
    """Deep-copy an Rx/TxTables value.  The port's engines never modify
    their input tables, but callers that hand one value to two engines
    (the bit-identity tests) clone per use as the reference requires."""
    return type(t)(*(a.clone() for a in t))


def make_rx_tables(n_qps: int, initial_credits: int = 64,
                   device: DeviceLike = None) -> RxTables:
    device = resolve_device(device)
    z = lambda: torch.zeros(n_qps, dtype=I32, device=device)  # noqa: E731
    return RxTables(
        epsn=z(), msn=z(), bytes_left=z(), cur_vaddr=z(),
        credits=torch.full((n_qps,), initial_credits, dtype=I32,
                           device=device),
        rkey=z(), rxbit=z(), sr=z(),
        acc_cnt=z(), dup_cnt=z(), ooo_cnt=z(), cdrop_cnt=z(), ecn_tot=z())


def make_tx_tables(n_qps: int, device: DeviceLike = None) -> TxTables:
    device = resolve_device(device)
    return TxTables(npsn=torch.zeros(n_qps, dtype=I32, device=device),
                    msn=torch.zeros(n_qps, dtype=I32, device=device))
