"""Fused epoch core: whole simulator epochs as one kernel launch.

Every per-tick construct of the Python simulator — the fabric's ingress
wire and drop-tail egress rings, RED/ECN mark state, the RDMA nodes'
retransmission slots, ACK-clocked flow-control ledgers and the RX
header-FSM tables — is packed into ONE flat int32 vector ("the blob"),
and an entire epoch of network ticks runs as one launch of the
hand-written kernel of ``repro_torch.kernels.fused_epoch`` on the nodes'
device (its plain version on the CPU).  The Python-object netsim stays
the oracle: tests/test_torch_fused_core.py asserts the fused epoch is
bit-identical to per-tick stepping under loss / dup / ECN / reorder
schedules, for both go-back-N and selective-repeat RX modes, and holds
the packing and the plain epoch against the reference
(``repro.core.fused``) on the same worlds.

Design (the reference's, module for module)
-------------------------------------------
* ``try_pack(nodes)`` inspects the live simulation.  If every feature in
  play is one the fused core models (see the gate list in ``try_pack``),
  it returns a ``_World`` — the blob plus the host-side plan needed to
  unpack.  Anything else returns ``None`` and the caller falls back to
  per-tick ``rdma.step_network`` — fused mode is a fast path, never a
  semantic fork.
* The *plan*: per directed flow (sender QP -> receiver QP), every packet
  that can possibly appear during the epoch is precomputed on the host.
  On the device a data packet is just ``(flow, plan_row)`` — payload
  bytes never touch it; the DMA writes are replayed on the host at
  unpack from the recorded ``(accepted, address, order)`` columns.
* Randomness: loss / RED / jitter / reorder decisions replay the
  counter-keyed hash of ``repro_torch.core.chaos``.
* The engine-counter contract of the telemetry plane is intact: the
  per-QP counter columns ride the blob and are written back once, at the
  epoch boundary.

Host<->device traffic of one epoch: every node's RX table comes down
in one copy at pack time; the blob goes up in one copy, the kernel
runs once, the blob comes back in one copy; each receiving node's rows
go up in one copy at unpack.  ``STATS`` counts epochs, their ticks,
refusals (``try_pack`` returned ``None``) and aborts.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import chaos
from repro_torch.core import netsim
from repro_torch.core import packet as pk
from repro_torch.core.pipeline import _STATE_FIELDS
from repro_torch.core.retransmit import _Slot
from repro_torch.device import to_device
from repro_torch.kernels import fused_epoch as fe
from repro_torch.kernels.fused_epoch import (HALF, MASK, NEG, SPAN, ShapeKey,
                                             _Layout, cached_layout)

_LAST_OPS = (pk.WRITE_LAST, pk.WRITE_ONLY,
             pk.READ_RESP_LAST, pk.READ_RESP_ONLY)
_RX_NAMES = fe.RX_NAMES

_PC_BUCKETS = (8, 16, 32, 64, 128, 256, 512)
_CC_BUCKETS = (4, 8, 16, 32, 64, 128)
_W_BUCKETS = (64, 128, 256, 512, 1024)


def _bucket(n: int, opts) -> Optional[int]:
    for o in opts:
        if n <= o:
            return o
    return None


def _i32(x: int) -> int:
    """uint32 value -> the int32 with the same bit pattern (the blob is
    all-int32; unsigned thresholds are compared as uint32 on the
    device)."""
    x = int(x) & 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


@dataclasses.dataclass
class EpochStats:
    """What the fused mode did since the last ``reset``: epochs run
    (kernel launches on a card), ticks they covered, ``try_pack``
    refusals and epochs discarded on an abort."""
    epochs: int = 0
    ticks: int = 0
    refusals: int = 0
    aborts: int = 0

    def reset(self) -> None:
        self.epochs = self.ticks = self.refusals = self.aborts = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


STATS = EpochStats()


# ---------------------------------------------------------------------------
# Packing: live Python simulation -> blob (or None when not fusable)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Flow:
    """Host-side view of one directed flow (sender QP -> receiver QP)."""
    idx: int
    snd: object                  # RdmaNode
    rcv: object
    sq: int                      # sender-local QPN
    rq: int                      # receiver-local QPN
    base: int                    # PSN of plan row 0
    plan: List[Optional[pk.Packet]]    # row -> packet template (or None)
    n_chunks: int
    window: int
    had_slot_key: bool           # retx.slots had the sq key at pack
    rx_prog0: int
    rx_prog_had_key: bool
    rx0: np.ndarray              # packed (13,) receiver table row


@dataclasses.dataclass
class _World:
    skey: ShapeKey
    layout: _Layout
    vec0: np.ndarray
    flows: List[_Flow]
    net: object
    link_keys: List[Tuple[int, int]]   # p2p only


def _ctrl_tuple(p: pk.Packet, flow: _Flow) -> Optional[Tuple[int, int, int]]:
    """Classify an in-flight control packet and verify it is exactly the
    packet the in-graph twin would reconstruct.  Returns (kind, ack_psn,
    sack) or None."""
    if p.opcode == pk.ACK:
        ref, kind = pk.make_ack(flow.sq, p.ack_psn, sack=p.sack_bits), 1
    elif p.opcode == pk.NAK:
        ref, kind = pk.make_ack(flow.sq, p.ack_psn, nak=True), 2
    elif p.opcode == pk.CNP:
        ref = pk.make_cnp(flow.sq, src_ip=flow.rcv.node_id, path_id=-1)
        kind = 3
    else:
        return None
    if not _pkt_eq(p, ref):
        return None
    return kind, int(p.ack_psn) & MASK, int(p.sack_bits)


def _pkt_eq(a: pk.Packet, b: pk.Packet) -> bool:
    for f in dataclasses.fields(pk.Packet):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "payload":
            an = va is None or va.size == 0
            bn = vb is None or vb.size == 0
            if an != bn or (not an and not np.array_equal(va, vb)):
                return False
        elif va != vb:
            return False
    return True


def try_pack(nodes, max_ticks: int, idle_done: int,
             watermarks: Optional[Dict[Tuple[int, int], int]] = None
             ) -> Optional[_World]:
    """Inspect the live simulation; return a packed ``_World`` when every
    feature in play is modeled in-graph, else None (caller falls back to
    per-tick stepping).  Packing never mutates the Python objects."""
    if not nodes:
        return None
    net = nodes[0].net
    N = len(nodes)
    for i, nd in enumerate(nodes):
        if (nd.net is not net or nd.node_id != i
                or nd.services is not None or nd.sniffer is not None
                or nd.recorder is not None or nd.fc.rate is not None
                or nd._retx_staged or nd._fatal_qps or nd.qp_errors):
            return None

    link_keys: List[Tuple[int, int]] = []
    if type(net) is netsim.SwitchedFabric:
        mode = "star"
        cfg = net.cfg
        if (net.reducer is not None or net.recorder is not None
                or net.n_nodes != N
                or any(q.on_event is not None for q in net.egress)
                or any(d < 1 for d in net.delay)):
            return None
        if (cfg.loss_prob > 0 or cfg.ecn_kmax > 0) and cfg.chaos_seed is None:
            return None
        P, L, G = N, 0, N
        loss_on, ecn_on = cfg.loss_prob > 0, cfg.ecn_kmax > 0
        jit_on = reo_on = False
        RCAP = int(cfg.queue_capacity)
    elif type(net) is netsim.Network:
        mode = "p2p"
        if net.recorder is not None:
            return None
        link_keys = list(net.links)          # oracle delivery order
        links = [net.links[k] for k in link_keys]
        if not links:
            return None
        c0 = links[0].cfg
        for (a, b), lk in zip(link_keys, links):
            lc = lk.cfg
            if (lk.on_event is not None or a >= N or b >= N
                    or lc.latency_ticks < 1
                    or lc.loss_prob != c0.loss_prob
                    or lc.reorder_prob != c0.reorder_prob
                    or lc.jitter_ticks != c0.jitter_ticks
                    or (lc.chaos_seed is None) != (c0.chaos_seed is None)):
                return None
        loss_on, reo_on = c0.loss_prob > 0, c0.reorder_prob > 0
        jit_on = c0.jitter_ticks > 0
        if (loss_on or reo_on or jit_on) and c0.chaos_seed is None:
            return None
        P, L, G = 0, len(links), len(links)
        ecn_on = False
        RCAP = 1                              # unused; keep layout small
    else:
        return None

    # ---- enumerate directed flows -------------------------------------
    flows: List[_Flow] = []
    by_rcv: Dict[Tuple[int, int], _Flow] = {}
    by_snd: Dict[Tuple[int, int], _Flow] = {}
    for s in nodes:
        for sq in sorted(s._peer):
            dst = s._peer[sq]
            if not 0 <= dst < N:
                return None
            r = nodes[dst]
            rq = int(s.qp.tables.remote_qpn[sq])
            if (int(r.qp.tables.remote_qpn[rq]) != sq or s._sr != r._sr):
                return None
            fl = _Flow(idx=len(flows), snd=s, rcv=r, sq=sq, rq=rq,
                       base=0, plan=[], n_chunks=0,
                       window=int(s.fc.cfg.window),
                       had_slot_key=sq in s.retx.slots,
                       rx_prog0=r._rx_progress.get(rq, 0),
                       rx_prog_had_key=rq in r._rx_progress,
                       rx0=np.zeros(13, np.int64))
            flows.append(fl)
            by_rcv[(r.node_id, rq)] = fl
            by_snd[(s.node_id, sq)] = fl
    F = len(flows)
    if F == 0:
        return None

    # ---- collect every in-flight packet -------------------------------
    # (container, dst, arrival, seq) tuples; classification below
    inflight: List[Tuple[str, int, int, int, pk.Packet]] = []
    ring_content: List[List[pk.Packet]] = []
    if mode == "star":
        for arr, seq, dst, p in net._wire:
            inflight.append(("wire", dst, arr, seq, p))
        for port, q in enumerate(net.egress):
            pkts = []
            for item in q._q:
                p, meta = item
                if meta is not None:
                    return None
                pkts.append(p)
                inflight.append(("ring", port, 0, 0, p))
            ring_content.append(pkts)
    else:
        for li, lk in enumerate(links):
            for arr, seq, p in lk._heap:
                inflight.append(("wire", li, arr, seq, p))

    def _flow_of(p: pk.Packet, dst_node: int) -> Optional[Tuple[_Flow, int]]:
        if p.coll_tag or p.ecn or p.path_id != -1:
            return None
        if p.opcode in pk.PAYLOAD_OPS:
            fl = by_rcv.get((dst_node, p.qpn))
            return None if fl is None else (fl, 0)
        fl = by_snd.get((dst_node, p.qpn))
        if fl is None:
            return None
        ct = _ctrl_tuple(p, fl)
        return None if ct is None else (fl, ct[0])

    # map in-flight data packets onto their flow (psn -> packet)
    data_by_flow: List[Dict[int, pk.Packet]] = [dict() for _ in range(F)]
    for where, loc, arr, seq, p in inflight:
        dst_node = loc if mode == "star" else link_keys[loc][1]
        hit = _flow_of(p, dst_node)
        if hit is None:
            return None
        fl, kind = hit
        if kind == 0:
            prev = data_by_flow[fl.idx].setdefault(p.psn & MASK, p)
            if prev is not p and not _pkt_eq(prev, p):
                return None

    # ---- per-flow plan construction -----------------------------------
    # every node's RX table in ONE device-to-host copy (the nodes of a
    # network share its device)
    n_rows = [nd.rx_tables.epsn.numel() for nd in nodes]
    flat = torch.cat([torch.stack([getattr(nd.rx_tables, f)
                                   for f in _STATE_FIELDS]).reshape(-1)
                      for nd in nodes]).cpu().numpy()
    bounds = np.cumsum([len(_STATE_FIELDS) * q for q in n_rows])[:-1]
    tbl = [part.reshape(len(_STATE_FIELDS), q)
           for part, q in zip(np.split(flat, bounds), n_rows)]
    chunk_rows: List[List[int]] = []
    for fl in flows:
        s, r, sq, rq = fl.snd, fl.rcv, fl.sq, fl.rq
        held = s.retx.slots.get(sq, {})
        for slot in held.values():
            if slot.packet.opcode not in pk.PAYLOAD_OPS:
                return None
        npsn = int(s.qp.tables.npsn[sq])
        psns = set(held) | set(data_by_flow[fl.idx])
        offs = [(npsn - psn) & MASK for psn in psns]
        if any(o == 0 or o > HALF for o in offs):
            return None
        base = npsn - (max(offs) if offs else 0)
        if base < 0:
            return None
        templates: List[Optional[pk.Packet]] = []
        for row in range(npsn - base):
            psn = base + row
            if psn in held:
                templates.append(held[psn].packet)
            elif psn in data_by_flow[fl.idx]:
                templates.append(data_by_flow[fl.idx][psn])
            else:
                templates.append(None)
        cur, npkts = npsn, []
        for n_req, item in s.fc.pending[sq]:
            kind, addr, data, coll = item
            if kind == "read" or coll is not None:
                return None
            pkts = pk.fragment_message(
                rq, cur, addr, s._remote_rkey[sq], data,
                op="write" if kind == "write" else "read_resp",
                mtu=s.mtu, src_ip=s.node_id,
                dst_ip=int(s.qp.tables.remote_ip[sq]),
                addr_per_pkt=s._sr)
            if len(pkts) != n_req:
                return None
            templates.extend(pkts)
            npkts.append(n_req)
            cur = (cur + n_req) & MASK
        if base + len(templates) >= SPAN:
            return None
        for row, t in enumerate(templates):
            if t is None:
                continue
            if (t.psn != base + row or t.opcode not in pk.PAYLOAD_OPS
                    or t.vaddr < 0 or t.vaddr + t.dma_len >= 2 ** 31
                    or t.payload_len > min(s.mtu, r.mtu)):
                return None
        for psn, p in data_by_flow[fl.idx].items():
            if not _pkt_eq(p, templates[psn - base]):
                return None
        fl.base, fl.plan, fl.n_chunks = base, templates, len(npkts)
        chunk_rows.append(npkts)
        # receiver-side invariants
        if (r.credits.credits[rq] != r.credits.max_credits
                or fl.rx_prog0 >= 2 ** 31 or r._buffer_for(rq) is None):
            return None
        row13 = tbl[r.node_id][:, rq].astype(np.int64)
        if bool(row13[_STATE_FIELDS.index("sr")]) != s._sr:
            return None
        fl.rx0 = row13
        if watermarks and (r.node_id, rq) in watermarks and s._sr:
            return None                       # watermark exit is GBN-only

    # ---- buckets / shape key ------------------------------------------
    PC = _bucket(max(max((len(fl.plan) for fl in flows)), 1), _PC_BUCKETS)
    CC = _bucket(max(max((fl.n_chunks for fl in flows)), 1), _CC_BUCKETS)
    n_wire = sum(1 for e in inflight if e[0] == "wire")
    WCAP = _bucket(n_wire + 2 * sum(fl.window for fl in flows)
                   + 2 * F + 16, _W_BUCKETS)
    if PC is None or CC is None or WCAP is None:
        return None
    if mode == "star":
        DEL = tuple(min(b, RCAP) for b in net.bandwidth)
        LDST: Tuple[int, ...] = ()
    else:
        DEL = tuple(min(lk.cfg.bandwidth_pkts_per_tick or (1 << 30), WCAP)
                    for lk in links)
        LDST = tuple(b for (_a, b) in link_keys)
    skey = ShapeKey(mode=mode, N=N, P=P, L=L, G=G, F=F, PC=PC, CC=CC,
                    WCAP=WCAP, RCAP=RCAP, DEL=DEL, LDST=LDST,
                    loss_on=loss_on, ecn_on=ecn_on, jit_on=jit_on,
                    reo_on=reo_on, wm_on=bool(watermarks))
    layout = cached_layout(skey)

    # ---- blob values ---------------------------------------------------
    v: Dict[str, object] = {
        "now": net.now, "max_ticks": max_ticks, "idle_done": idle_done,
        "f_snd": [fl.snd.node_id for fl in flows],
        "f_sq": [fl.sq for fl in flows],
        "f_rcv": [fl.rcv.node_id for fl in flows],
        "f_rq": [fl.rq for fl in flows],
        "f_sr": [int(fl.snd._sr) for fl in flows],
        "f_window": [fl.window for fl in flows],
        "f_gap_lag": [fl.snd.sr_gap_lag for fl in flows],
        "f_timeout": [fl.snd.retx.timeout for fl in flows],
        "f_base": [fl.base for fl in flows],
        "f_plan_len": [len(fl.plan) for fl in flows],
        "f_nchunks": [fl.n_chunks for fl in flows],
        "f_budget": [fl.snd.fc.budget[fl.sq] for fl in flows],
        "f_out": [fl.snd.fc.outstanding[fl.sq] for fl in flows],
        "f_last_nak": [fl.snd._last_nak_resend.get(fl.sq, NEG)
                       for fl in flows],
        "f_last_gap": [fl.snd._last_gap_resend.get(fl.sq, NEG)
                       for fl in flows],
        "f_last_cnp": [fl.rcv._last_cnp_sent.get(fl.rq, NEG)
                       for fl in flows],
        "f_wm": [fl.rx_prog0 for fl in flows],
        "f_wm_armed": [int(bool(watermarks)
                           and (fl.rcv.node_id, fl.rq) in watermarks)
                       for fl in flows],
        "f_wm_thresh": [(watermarks or {}).get((fl.rcv.node_id, fl.rq), 0)
                        for fl in flows],
        "f_maxcred": [fl.rcv.credits.max_credits for fl in flows],
    }
    p_op = np.zeros((F, PC), np.int64)
    p_plen = np.zeros((F, PC), np.int64)
    p_vaddr = np.zeros((F, PC), np.int64)
    p_dlen = np.zeros((F, PC), np.int64)
    p_ackreq = np.zeros((F, PC), np.int64)
    p_rkey = np.zeros((F, PC), np.int64)
    p_held = np.zeros((F, PC), np.int64)
    p_retr = np.zeros((F, PC), np.int64)
    p_dl = np.zeros((F, PC), np.int64)
    p_aseq = np.full((F, PC), -1, np.int64)
    c_np = np.zeros((F, CC), np.int64)
    for fl, npkts in zip(flows, chunk_rows):
        held = fl.snd.retx.slots.get(fl.sq, {})
        for row, t in enumerate(fl.plan):
            if t is None:
                continue
            p_op[fl.idx, row] = t.opcode
            p_plen[fl.idx, row] = t.payload_len
            p_vaddr[fl.idx, row] = t.vaddr
            p_dlen[fl.idx, row] = t.dma_len
            p_ackreq[fl.idx, row] = int(t.ack_req)
            p_rkey[fl.idx, row] = t.rkey
        for psn, slot in held.items():
            row = psn - fl.base
            p_held[fl.idx, row] = 1
            p_retr[fl.idx, row] = slot.retries
            p_dl[fl.idx, row] = slot.deadline
        c_np[fl.idx, :len(npkts)] = npkts
        v["f_next"] = v.get("f_next", [])
    v["f_next"] = [int(fl.snd.qp.tables.npsn[fl.sq]) - fl.base
                   for fl in flows]
    v.update(p_op=p_op, p_plen=p_plen, p_vaddr=p_vaddr, p_dlen=p_dlen,
             p_ackreq=p_ackreq, p_rkey=p_rkey, p_held=p_held,
             p_retr=p_retr, p_dl=p_dl, p_aseq=p_aseq, c_np=c_np)
    rx_names = ("rx_epsn", "rx_msn", "rx_bytes", "rx_cur", "rx_cred",
                "rx_rkey", "rx_rxbit", "rx_srf", "rx_acc", "rx_dup",
                "rx_ooo", "rx_cdrop", "rx_ecn")
    rxm = np.stack([fl.rx0 for fl in flows], axis=1)    # (13, F)
    for k, name in enumerate(rx_names):
        v[name] = rxm[k]

    # wire slots
    wn = ("w_valid", "w_arr", "w_seq", "w_dst", "w_flow", "w_pidx",
          "w_kind", "w_ap", "w_sack")
    wv = {n: np.zeros(WCAP, np.int64) for n in wn}
    wi = 0
    for where, loc, arr, seq, p in inflight:
        if where != "wire":
            continue
        dst_node = loc if mode == "star" else link_keys[loc][1]
        fl, kind = _flow_of(p, dst_node)
        if kind == 0:
            pidx, ap, sack = (p.psn & MASK) - fl.base, 0, 0
        else:
            _, ap, sack = _ctrl_tuple(p, fl)
            pidx = 0
        wv["w_valid"][wi] = 1
        wv["w_arr"][wi] = arr
        wv["w_seq"][wi] = seq
        wv["w_dst"][wi] = loc
        wv["w_flow"][wi] = fl.idx
        wv["w_pidx"][wi] = pidx
        wv["w_kind"][wi] = kind
        wv["w_ap"][wi] = ap
        wv["w_sack"][wi] = sack
        wi += 1
    v.update(wv)

    # order tables
    v["t_order"] = sorted(range(F), key=lambda i: (flows[i].snd.node_id,
                                                   flows[i].sq))
    cnp_ord = np.full((G, F), -1, np.int64)
    for g in range(G):
        dst_node = g if mode == "star" else LDST[g]
        fs = sorted((fl for fl in flows if fl.rcv.node_id == dst_node),
                    key=lambda fl: fl.rq)
        for j, fl in enumerate(fs):
            cnp_ord[g, j] = fl.idx
    v["cnp_ord"] = cnp_ord

    if mode == "star":
        red = np.zeros(RCAP + 1, np.int64)
        if cfg.ecn_kmax > 0:
            for d in range(RCAP + 1):
                ramp = cfg.ecn_pmax * (d - cfg.ecn_kmin) / max(
                    cfg.ecn_kmax - cfg.ecn_kmin, 1)
                red[d] = _i32(chaos.u32_prob(min(max(ramp, 0.0), 1.0)))
        v.update(
            seq=net._seq, cseed=_i32(cfg.chaos_seed or 0),
            loss_t=_i32(chaos.u32_prob(cfg.loss_prob)),
            kmin=cfg.ecn_kmin, kmax=cfg.ecn_kmax,
            delay=net.delay, red_t=red,
            pt_maxd=[st.max_depth for st in net.port_stats],
            r_len=[len(q) for q in ring_content],
        )
        rn = ("r_flow", "r_pidx", "r_kind", "r_ap", "r_sack")
        rv = {n: np.zeros((P, RCAP), np.int64) for n in rn}
        for port, pkts in enumerate(ring_content):
            for j, p in enumerate(pkts):
                fl, kind = _flow_of(p, port)
                if kind == 0:
                    pidx, ap, sack = (p.psn & MASK) - fl.base, 0, 0
                else:
                    _, ap, sack = _ctrl_tuple(p, fl)
                    pidx = 0
                rv["r_flow"][port, j] = fl.idx
                rv["r_pidx"][port, j] = pidx
                rv["r_kind"][port, j] = kind
                rv["r_ap"][port, j] = ap
                rv["r_sack"][port, j] = sack
        v.update(rv)
    else:
        v.update(
            l_seed=[_i32(lk.cfg.chaos_seed or 0) for lk in links],
            l_loss_t=[_i32(chaos.u32_prob(lk.cfg.loss_prob))
                      for lk in links],
            l_reorder_t=[_i32(chaos.u32_prob(lk.cfg.reorder_prob))
                         for lk in links],
            l_jitter=[lk.cfg.jitter_ticks for lk in links],
            l_lat=[lk.cfg.latency_ticks for lk in links],
            l_seq=[lk._seq for lk in links],
            f_ldata=[link_keys.index((fl.snd.node_id, fl.rcv.node_id))
                     for fl in flows],
            f_lctrl=[link_keys.index((fl.rcv.node_id, fl.snd.node_id))
                     for fl in flows],
        )

    vec0 = layout.pack(v)
    return _World(skey=skey, layout=layout, vec0=vec0, flows=flows,
                  net=net, link_keys=link_keys)


# ---------------------------------------------------------------------------
# Unpacking: blob -> live Python simulation
# ---------------------------------------------------------------------------

def _rebuild_pkt(fl: _Flow, kind: int, pidx: int, ap: int,
                 sack: int) -> pk.Packet:
    if kind == 0:
        return fl.plan[pidx].clone()
    if kind == 1:
        return pk.make_ack(fl.sq, ap, sack=sack)
    if kind == 2:
        return pk.make_ack(fl.sq, ap, nak=True)
    return pk.make_cnp(fl.sq, src_ip=fl.rcv.node_id, path_id=-1)


def _apply(world: _World, out: np.ndarray, nodes) -> None:
    """Write the epoch's final blob back into the Python objects,
    reproducing exactly the state the per-tick oracle would have."""
    lay, flows, skey = world.layout, world.flows, world.skey
    g = lambda name: lay.get(out, name)               # noqa: E731
    g0 = lambda name: lay.get(world.vec0, name)       # noqa: E731
    star = skey.mode == "star"

    held, retr, dl = g("p_held"), g("p_retr"), g("p_dl")
    acc, aseq, aaddr = g("p_acc"), g("p_aseq"), g("p_aaddr")
    nextv, next0, cur = g("f_next"), g0("f_next"), g("f_cursor")
    rxf = {n: g(n) for n in _RX_NAMES}

    # ---- DMA replay (+ SR interval merge), global acceptance order ----
    recs = []
    for fl in flows:
        for row in np.nonzero(acc[fl.idx])[0]:
            recs.append((int(aseq[fl.idx, row]), fl.idx, int(row)))
    recs.sort()
    for _s, fi, row in recs:
        fl = world.flows[fi]
        t = fl.plan[row]
        a, ln = int(aaddr[fl.idx, row]), t.payload_len
        buf = fl.rcv._buffer_for(fl.rq)
        if ln:
            buf[a:a + ln] = t.payload[:ln]
        if fl.snd._sr:
            fl.rcv._sr_note_progress(fl.rq, a, ln)

    for fl in flows:
        s, r, sq, rq, i = fl.snd, fl.rcv, fl.sq, fl.rq, fl.idx
        accd = int(rxf["rx_acc"][i]) - int(fl.rx0[8])
        dupd = int(rxf["rx_dup"][i]) - int(fl.rx0[9])
        oood = int(rxf["rx_ooo"][i]) - int(fl.rx0[10])
        cdropd = int(rxf["rx_cdrop"][i]) - int(fl.rx0[11])
        ecnd = int(rxf["rx_ecn"][i]) - int(fl.rx0[12])

        # receiver: progress watermark + message completions
        last_rows = [row for row in np.nonzero(acc[i])[0]
                     if fl.plan[row].opcode in _LAST_OPS]
        if s._sr:
            lst = list(r._sr_pending_last.get(rq, []))
            lst += [fl.base + int(row) for row in
                    sorted(last_rows, key=lambda rr: int(aseq[i, rr]))]
            if lst:
                epsn = int(rxf["rx_epsn"][i])
                done = [ps for ps in lst if ((ps - epsn) % SPAN) > HALF]
                rest = [ps for ps in lst if ((ps - epsn) % SPAN) <= HALF]
                if done:
                    r._completions[rq] = r._completions.get(rq, 0) \
                        + len(done)
                if rest:
                    r._sr_pending_last[rq] = rest
                else:
                    r._sr_pending_last.pop(rq, None)
        else:
            if accd > 0:
                r._rx_progress[rq] = int(g("f_wm")[i])
            if last_rows:
                r._completions[rq] = r._completions.get(rq, 0) \
                    + len(last_rows)

        # receiver: credit ledger (note_accepted/note_dropped/replenish)
        r.credits.accepted += accd
        r.credits.accepted_per_qp[rq] += accd
        r.credits.granted += accd
        r.credits.dropped_no_credit += cdropd
        r.credits.dropped_per_qp[rq] += cdropd

        # receiver: per-QP node stats driven by the engine verdicts
        r.stats.accepted += accd
        r.stats.dup_dropped += dupd
        r.stats.ooo_nak += oood
        r.stats.credit_dropped += cdropd
        r.stats.ecn_marked_rx += ecnd

        # sender: PSN space, retransmit slots, flow control, holdoffs
        s.qp.tables.npsn[sq] = (fl.base + int(nextv[i])) & MASK
        slots = {}
        for row in np.nonzero(held[i])[0]:
            psn = fl.base + int(row)
            slots[psn] = _Slot(psn, fl.plan[row].clone(),
                               int(dl[i, row]), int(retr[i, row]))
        if slots or fl.had_slot_key or int(nextv[i]) > int(next0[i]):
            s.retx.slots[sq] = slots
        s.fc.budget[sq] = int(g("f_budget")[i])
        s.fc.outstanding[sq] = int(g("f_out")[i])
        for _ in range(int(cur[i])):
            s.fc.pending[sq].popleft()
        s.fc.total_passed += int(g("f_tpassed_d")[i])
        if g("f_last_nak_w")[i]:
            s._last_nak_resend[sq] = int(g("f_last_nak")[i])
        if g("f_last_gap_w")[i]:
            s._last_gap_resend[sq] = int(g("f_last_gap")[i])
        if g("f_last_cnp_w")[i]:
            r._last_cnp_sent[rq] = int(g("f_last_cnp")[i])

    # ---- RX table scatter: one host-to-device copy of the receiving
    # rows per node, written into the node's columns on its device -----
    by_node: Dict[int, List[_Flow]] = {}
    for fl in flows:
        by_node.setdefault(fl.rcv.node_id, []).append(fl)
    for nid, fls in by_node.items():
        nd = nodes[nid]
        idx = [fl.idx for fl in fls]
        host = np.concatenate([[fl.rq for fl in fls]]
                              + [rxf[n][idx] for n in _RX_NAMES])
        dev = torch.from_numpy(host.astype(np.int32)).to(nd.device)
        dev = dev.view(len(_RX_NAMES) + 1, len(fls))
        rows = dev[0].long()
        for k, field in enumerate(_STATE_FIELDS):
            getattr(nd.rx_tables, field)[rows] = dev[k + 1]

    # ---- node-level stat deltas ---------------------------------------
    for n, nd in enumerate(nodes):
        nd.stats.tx_pkts += int(g("n_tx")[n])
        nd.stats.rx_pkts += int(g("n_rx")[n])
        nd.stats.retransmissions += int(g("n_retx")[n])
        nd.stats.sacked += int(g("n_sacked")[n])
        nd.stats.cnp_tx += int(g("n_cnptx")[n])
        nd.stats.cnp_rx += int(g("n_cnprx")[n])
        nd.retx.retransmissions += int(g("n_retx")[n])

    # ---- fabric / link state ------------------------------------------
    net = world.net
    now = g("now")
    wv = {n_: g(n_) for n_ in ("w_valid", "w_arr", "w_seq", "w_dst",
                               "w_flow", "w_pidx", "w_kind", "w_ap",
                               "w_sack")}

    def _wire_entries():
        for si in range(skey.WCAP):
            if not wv["w_valid"][si]:
                continue
            pkt = _rebuild_pkt(flows[int(wv["w_flow"][si])],
                               int(wv["w_kind"][si]),
                               int(wv["w_pidx"][si]),
                               int(wv["w_ap"][si]),
                               int(wv["w_sack"][si]))
            yield (int(wv["w_arr"][si]), int(wv["w_seq"][si]),
                   int(wv["w_dst"][si]), pkt)

    if star:
        net.now = now
        net._seq = g("seq")
        net.injected += g("injected_d")
        net._ctick, net._csend, net._cpop = now, g("csend"), g("cpop")
        for p in range(skey.P):
            st = net.port_stats[p]
            st.enqueued += int(g("pt_enq")[p])
            st.delivered += int(g("pt_del")[p])
            st.tail_dropped += int(g("pt_tdrop")[p])
            st.wire_dropped += int(g("pt_wdrop")[p])
            st.ecn_marked += int(g("pt_ecn")[p])
            st.max_depth = int(g("pt_maxd")[p])
        wire = [(a, s_, d, p) for a, s_, d, p in _wire_entries()]
        heapq.heapify(wire)
        net._wire = wire
        rl, rh = g("r_len"), g("r_head")
        rf, rp_ = g("r_flow"), g("r_pidx")
        rk, ra, rs = g("r_kind"), g("r_ap"), g("r_sack")
        for p in range(skey.P):
            q = collections.deque()
            for j in range(int(rl[p])):
                slot = (int(rh[p]) + j) % skey.RCAP
                q.append((_rebuild_pkt(flows[int(rf[p, slot])],
                                       int(rk[p, slot]), int(rp_[p, slot]),
                                       int(ra[p, slot]),
                                       int(rs[p, slot])), None))
            net.egress[p]._q = q
    else:
        net.now = now
        heaps: List[List] = [[] for _ in world.link_keys]
        for arr, seqv, li, pkt in _wire_entries():
            heaps[li].append((arr, seqv, pkt))
        for li, key in enumerate(world.link_keys):
            lk = net.links[key]
            heapq.heapify(heaps[li])
            lk._heap = heaps[li]
            lk._seq = int(g("l_seq")[li])
            lk.sent += int(g("l_sent_d")[li])
            lk.dropped += int(g("l_drop_d")[li])
            lk._ctick, lk._cidx = now, int(g("l_cidx")[li])


def run_fused_epoch(nodes, max_ticks: int = 100_000, idle_done: int = 8,
                    watermarks: Optional[Dict[Tuple[int, int], int]] = None
                    ) -> Optional[Dict[str, int]]:
    """Pack, run one fused epoch on the nodes' device, unpack.

    Returns None when the world is not fusable or the fused core hit a
    case it does not model (retry exhaustion, rkey protection error,
    wire-capacity overflow) — in that case the Python objects are
    untouched and the caller falls back to per-tick stepping.

    On success the Python world has advanced exactly as ``for _ in
    range(steps): rdma.step_network(nodes)`` would have, and the return
    dict carries ``steps``, ``wm_hit``, ``idle_exit`` and ``ticks`` (the
    ``rdma.run_network`` return-value convention).
    """
    world = try_pack(nodes, max_ticks, idle_done, watermarks)
    if world is None:
        STATS.refusals += 1
        return None
    blob = to_device(world.vec0, nodes[0].device)      # one copy up
    fe.fused_epoch(blob, world.skey)                   # one launch
    out = blob.cpu().numpy()                           # one copy down
    lay = world.layout
    STATS.epochs += 1
    STATS.ticks += lay.get(out, "steps")
    if lay.get(out, "abort"):
        STATS.aborts += 1
        return None
    steps = lay.get(out, "steps")
    idle_exit = lay.get(out, "idle") >= idle_done
    _apply(world, out, nodes)
    return {"steps": steps, "wm_hit": bool(lay.get(out, "wm_hit")),
            "idle_exit": idle_exit,
            "ticks": (steps - 1) if idle_exit else max_ticks}
