"""RDMA endpoint: the full BALBOA node (paper Fig. 1 & 3 wired together).

One ``RdmaNode`` owns the QP manager, the torch RX/TX pipelines, ACK-clocked
flow control (optionally DCQCN rate-paced: the node plays the DCQCN NP
role — in-graph CE detection, coalesced CNP emission — and RP role —
CNP-driven rate cuts pacing both fresh traffic and staged go-back-N
resends), the retransmission buffer, RX crediting and the service
chain.  Nodes exchange packets over ``repro_torch.core.netsim`` — either the
point-to-point ``Network`` or the ``SwitchedFabric`` (shared egress
queues, where incast congestion lives) — tests drive lossy links and
assert exactly-once in-order delivery; benchmarks measure
latency/throughput vs. buffer size exactly like the paper's Fig. 4.

The node is a host-side control plane (verbs, ACK clocking, retransmit
timers — BALBOA's sequencer logic) around a data plane on ``device``
(default the card): the RX tables live there, each arriving batch's
headers go there in one copy, and the service chain runs there on the
hand-written kernels.  ``engine`` selects the RX data plane:
``"batched"`` (the multi-QP wave engine, default — one engine call per
network tick across all QPs) or ``"scan"`` (the per-packet oracle it is
diffed against; meant for tests on the CPU).
TX PSN assignment stays host-side here (one message at a time at the
verbs layer); the batched TX engine (``pipeline.tx_pipeline_batched``)
serves bulk command streams and is exercised by tests/benchmarks.

Programming model mirrors the Coyote-thread verbs of §4.6:
    qpn, rkey, buf = node.init_rdma(max_size, remote_node)
    node.rdma_write(qpn, data)           # REMOTE_RDMA_WRITE
    node.rdma_read(qpn, length)          # REMOTE_RDMA_READ
    node.check_completed(qpn)            # completion polling
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import packet as pk
from repro_torch.core import pipeline as pipe
from repro_torch.core.flow_control import (AckClockedFlowControl,
                                           CreditManager, DcqcnConfig,
                                           FlowControlConfig)
from repro_torch.core.qp import QPManager
from repro_torch.core.retransmit import RetransmissionBuffer
from repro_torch.core.services import ServiceChain
from repro_torch.device import DeviceLike, resolve_device, to_device

RX_PAD = 16           # pad RX batches to power-of-two multiples of this


@dataclasses.dataclass
class NodeStats:
    tx_pkts: int = 0
    rx_pkts: int = 0
    accepted: int = 0
    dup_dropped: int = 0
    ooo_nak: int = 0
    credit_dropped: int = 0
    retransmissions: int = 0
    dpi_flagged: int = 0
    ecn_marked_rx: int = 0       # CE-marked payload packets seen (NP)
    cnp_tx: int = 0              # CNPs emitted (NP, after coalescing)
    cnp_rx: int = 0              # CNPs received (RP)
    prot_errors: int = 0         # rkey mismatches NAKed at this responder
    nak_prot_rx: int = 0         # protection NAKs received (requester side)
    sacked: int = 0              # slots released by selective ACK bitmaps

    def snapshot(self) -> dict:
        """Common telemetry shape (see ``telemetry.MetricRegistry``)."""
        return dataclasses.asdict(self)


# engine counter column -> the host-side NodeStats counter it
# mirrors (the reconciliation tests assert per-column sums match)
ENGINE_COUNTERS = {
    "acc_cnt": "accepted",
    "dup_cnt": "dup_dropped",
    "ooo_cnt": "ooo_nak",
    "cdrop_cnt": "credit_dropped",
    "ecn_tot": "ecn_marked_rx",
}


CONGESTION_CONTROLS = ("ack_clocked", "static", "dcqcn")
RX_MODES = ("go_back_n", "selective_repeat")
PATH_SELECTS = (None, "ecmp", "spray")


class RdmaNode:
    def __init__(self, node_id: int, network, *,
                 n_qps: int = 500, mtu: int = pk.MTU,
                 fc_window: int = 64, rx_credits: int = 64,
                 services: Optional[ServiceChain] = None,
                 sniffer=None, engine: str = "batched",
                 congestion_control: str = "ack_clocked",
                 dcqcn: Optional[DcqcnConfig] = None,
                 rx_mode: str = "go_back_n",
                 path_select: Optional[str] = None,
                 sr_gap_lag: int = 12,
                 device: DeviceLike = None):
        if engine not in pipe.RX_ENGINES:
            raise ValueError(f"unknown engine {engine!r}; "
                             f"choose from {sorted(pipe.RX_ENGINES)}")
        if congestion_control not in CONGESTION_CONTROLS:
            raise ValueError(
                f"unknown congestion_control {congestion_control!r}; "
                f"choose from {CONGESTION_CONTROLS}")
        if rx_mode not in RX_MODES:
            raise ValueError(f"unknown rx_mode {rx_mode!r}; "
                             f"choose from {RX_MODES}")
        if path_select not in PATH_SELECTS:
            raise ValueError(f"unknown path_select {path_select!r}; "
                             f"choose from {PATH_SELECTS}")
        if rx_mode == "selective_repeat" and fc_window > pipe.SR_WINDOW:
            raise ValueError(
                f"fc_window={fc_window} exceeds the selective-repeat "
                f"receive window ({pipe.SR_WINDOW}): the sender could "
                f"legally burst past what the RX bitmap can hold")
        self.device = resolve_device(device)
        self.node_id = node_id
        self.net = network                   # Network / SwitchedFabric / Clos
        self.engine = engine
        self._rx_pipe = pipe.RX_ENGINES[engine]
        self.mtu = mtu
        self.rx_mode = rx_mode
        self._sr = rx_mode == "selective_repeat"
        self.path_select = path_select
        self.sr_gap_lag = sr_gap_lag
        self.qp = QPManager(n_qps, node_id)
        self.rx_tables = pipe.make_rx_tables(n_qps, rx_credits,
                                             device=self.device)
        if self._sr:
            # whole-node RX mode: both peers of a QP must agree on it
            # (a selective-repeat sender emits per-packet RETHs)
            self.rx_tables = self.rx_tables._replace(
                sr=torch.ones_like(self.rx_tables.sr))
        self.tx_tables = pipe.make_tx_tables(n_qps, device=self.device)
        self.fc = AckClockedFlowControl(n_qps, FlowControlConfig(
            fc_window, congestion_control=congestion_control,
            dcqcn=dcqcn if dcqcn is not None else DcqcnConfig()))
        if (self.fc.rate is not None and path_select == "spray"
                and getattr(network, "n_paths", 1) > 1):
            # per-spine DCQCN: CNPs attribute congestion to one plane
            self.fc.rate.enable_multipath(network.n_paths)
        self.credits = CreditManager(n_qps, rx_credits, rx_credits)
        self.retx = RetransmissionBuffer(timeout_ticks=64)
        self.services = services
        self.sniffer = sniffer
        self.stats = NodeStats()
        self.recorder = None                 # telemetry.FlightRecorder
        self.qp_errors: set = set()                  # QPs dead on retry budget
        self._fatal_qps: set = set()                 # protection errors: never
                                                     # retransmit, only recover
        self._exhausted_seen = 0                     # retx.exhausted cursor
        self._completions: Dict[int, int] = {}       # qpn -> completed msgs
        self._qp_buffer: Dict[int, Tuple[int, np.ndarray]] = {}
        self._peer: Dict[int, int] = {}              # qpn -> remote node id
        # contiguous-byte completion watermark per QP: the highest byte
        # offset of the registered buffer such that every byte below it
        # has been accepted by the RX pipeline.  PSN checking accepts
        # strictly in order, so ``dma_addr + dma_len`` of the newest
        # accepted payload IS the contiguous frontier — streaming
        # consumers (``repro.core.ingest``) poll it between network
        # ticks to hand completed fragment tiles onward mid-transfer.
        self._rx_progress: Dict[int, int] = {}       # qpn -> bytes landed
        self._remote_rkey: Dict[int, int] = {}       # qpn -> peer buffer rkey
        self._local_rkey: Dict[int, int] = {}        # qpn -> our buffer rkey
        self._read_pending: Dict[int, int] = {}      # qpn -> bytes expected
        self._last_nak_resend: Dict[int, int] = {}   # qpn -> tick
        self._last_cnp_sent: Dict[int, int] = {}     # qpn -> tick (coalescing)
        # retransmissions awaiting pacing tokens (DCQCN only: the rate
        # limiter sits at the wire, so resends are paced like first
        # transmissions instead of bursting back into the hot queue)
        self._retx_staged: Dict[int, List[pk.Packet]] = {}
        # selective-repeat host state --------------------------------------
        # out-of-order byte intervals not yet contiguous with the
        # watermark: qpn -> {start byte: end byte}
        self._sr_pend: Dict[int, Dict[int, int]] = {}
        # LAST/ONLY packets accepted out of order: their message
        # completion is deferred until epsn passes them
        self._sr_pending_last: Dict[int, List[int]] = {}
        self._last_gap_resend: Dict[int, int] = {}   # qpn -> tick
        self._path_rr: Dict[int, int] = {}           # qpn -> spray cursor

    # --------------------------------------------------------- telemetry
    def attach_recorder(self, rec):
        """Record transport lifecycle events (retransmit, SACK/NAK, CNP
        tx/rx, completion, QP error) into a ``telemetry.FlightRecorder``
        — one track per (node, QP)."""
        self.recorder = rec

    def _rec(self, kind: str, qpn: int, **attrs):
        if self.recorder is not None:
            self.recorder.record(self.net.now, kind,
                                 ("qp", f"{self.node_id}:{qpn}"), **attrs)

    def engine_counters(self) -> Dict[str, np.ndarray]:
        """Harvest the per-QP counter columns carried through the RX
        engine state (``pipeline.COUNTER_FIELDS``): one device-to-host
        copy, at an epoch boundary, never inside the per-batch engine
        calls."""
        cols = torch.stack([getattr(self.rx_tables, col)
                            for col in ENGINE_COUNTERS]).cpu().numpy()
        return {host: cols[i]
                for i, host in enumerate(ENGINE_COUNTERS.values())}

    def engine_totals(self) -> Dict[str, int]:
        return {k: int(v.sum()) for k, v in self.engine_counters().items()}

    def snapshot(self) -> dict:
        """Common telemetry shape: every stats surface of the node."""
        return {"stats": self.stats.snapshot(),
                "engine": self.engine_totals(),
                "fc": self.fc.snapshot(),
                "credits": self.credits.snapshot(),
                "retx": self.retx.snapshot(),
                "completions": sum(self._completions.values()),
                "qp_errors": len(self.qp_errors)}

    # ------------------------------------------------------------- verbs
    def init_rdma(self, max_size: int, remote: "RdmaNode",
                  key_id: int = 0) -> Tuple[int, int, np.ndarray]:
        """Out-of-band QP + buffer exchange (paper §4.6: 'completely
        hidden abstraction' over TCP sockets)."""
        rkey_l, buf_l = self.qp.register_buffer(max_size)
        rkey_r, buf_r = remote.qp.register_buffer(max_size)
        qpn_l = self.qp.create_qp(remote.node_id, pk.UDP_DPORT_ROCE)
        qpn_r = remote.qp.create_qp(self.node_id, pk.UDP_DPORT_ROCE)
        self.qp.connect(qpn_l, qpn_r, key_id)
        remote.qp.connect(qpn_r, qpn_l, key_id)
        self._qp_buffer[qpn_l] = (rkey_r, buf_l)     # local view
        remote._qp_buffer[qpn_r] = (rkey_l, buf_r)
        self._peer[qpn_l] = remote.node_id
        remote._peer[qpn_r] = self.node_id
        # out-of-band: each side knows the peer's buffer under its own QP
        self._remote_rkey[qpn_l] = rkey_r
        remote._remote_rkey[qpn_r] = rkey_l
        # ... and arms protection on its own: the RX pipeline checks every
        # RETH against the registered rkey (host path: _on_read_request)
        self._local_rkey[qpn_l] = rkey_l
        remote._local_rkey[qpn_r] = rkey_r
        self.rx_tables.rkey[qpn_l] = rkey_l          # in place: the node
        remote.rx_tables.rkey[qpn_r] = rkey_r        # owns its tables
        return qpn_l, rkey_r, buf_l

    def rdma_write(self, qpn: int, data: np.ndarray, remote_addr: int = 0,
                   coll: Optional[Tuple[int, int, int]] = None):
        """One-sided WRITE of ``data`` into the peer's registered buffer.
        Messages larger than the flow-control window are chunked into
        window-sized sub-messages so the ACK clock can pace them.

        ``coll = (tag, src, nsrc)`` marks every packet of the message as
        a collective CHUNK contribution for the in-fabric reduction
        offload (``repro.core.collectives``): the switch absorbs tagged
        contributions and forwards one summed stream per reduction slot.
        Transport semantics are unchanged — tagged packets still ride
        flow control, retransmission and pacing."""
        self._submit(qpn, "write", remote_addr, np.asarray(data, np.uint8),
                     coll=coll)

    def rdma_read(self, qpn: int, length: int, remote_addr: int = 0):
        """One-sided READ from the peer's buffer into ours."""
        for passed in self.fc.request(qpn, 1,
                                      ("read", remote_addr, length, None)):
            self._dispatch(qpn, passed[1])

    def check_completed(self, qpn: int) -> int:
        return self._completions.get(qpn, 0)

    def remote_qpn(self, qpn: int) -> int:
        """The peer QPN this local QP is connected to (from the
        connection table ``init_rdma`` filled in) — callers must derive
        the remote end from here, never by inspecting the peer's
        buffer dict."""
        return self._remote_qpn(qpn)

    def rx_progress(self, qpn: int) -> int:
        """Contiguous bytes landed in this QP's registered buffer since
        the last ``reset_rx_progress`` — the completion watermark a
        streaming consumer polls between ``step_network`` ticks."""
        return self._rx_progress.get(qpn, 0)

    def reset_rx_progress(self, qpn: int):
        """Re-arm the watermark before issuing a new transfer whose DMA
        addresses restart at the buffer base."""
        self._rx_progress.pop(qpn, None)
        self._sr_pend.pop(qpn, None)

    def expected_completions(self, nbytes: int) -> int:
        """How many RX completions one ``rdma_write`` of ``nbytes``
        produces at the peer (one per flow-control sub-message) —
        collective schedules poll ``check_completed`` against this."""
        return max(1, -(-max(nbytes, 1) // self._sub_message_bytes()))

    # -------------------------------------------------------- TX internals
    def _sub_message_bytes(self) -> int:
        """TX chunking policy: messages split into half-window-sized
        sub-messages so the ACK clock can pace them (always a multiple
        of the MTU, so collective fragment numbering stays aligned)."""
        return max(1, (self.fc.cfg.window // 2)) * self.mtu

    def _submit(self, qpn: int, kind: str, remote_addr: int,
                data: np.ndarray, coll=None):
        chunk_bytes = self._sub_message_bytes()
        for off in range(0, max(len(data), 1), chunk_bytes):
            chunk = data[off:off + chunk_bytes]
            n_pkts = pk.read_resp_npkts(len(chunk), self.mtu)
            # sub-messages fragment independently, so collective fragment
            # numbering continues across them (chunk_bytes % mtu == 0)
            sub = None if coll is None else (*coll, off // self.mtu)
            for passed in self.fc.request(
                    qpn, n_pkts, (kind, remote_addr + off, chunk, sub)):
                self._dispatch(qpn, passed[1])

    def _dispatch(self, qpn: int, item):
        kind, addr, payload, coll = item
        if kind == "read":
            self._emit_read_request(qpn, addr, payload)
        else:
            self._emit_message(qpn, addr, payload,
                               op="write" if kind == "write" else "read_resp",
                               coll=coll)

    def _emit_message(self, qpn: int, remote_addr: int,
                      data: np.ndarray, op: str = "write", coll=None):
        t = self.qp.tables
        start_psn = int(t.npsn[qpn])
        rkey = self._remote_rkey[qpn]
        pkts = pk.fragment_message(
            int(t.remote_qpn[qpn]), start_psn, remote_addr, rkey, data,
            op=op, mtu=self.mtu, src_ip=self.node_id,
            dst_ip=int(t.remote_ip[qpn]), coll=coll,
            addr_per_pkt=self._sr)
        t.npsn[qpn] = (start_psn + len(pkts)) & pk.PSN_MASK
        for p in pkts:
            # retransmission buffer holds every payload until remote ACK
            self.retx.hold(qpn, p, self.net.now)
            self._send(qpn, p)

    def _emit_read_request(self, qpn: int, remote_addr: int, length: int):
        t = self.qp.tables
        psn = int(t.npsn[qpn])
        p = pk.make_read_request(int(t.remote_qpn[qpn]), psn, remote_addr,
                                 self._remote_rkey[qpn], length,
                                 src_ip=self.node_id,
                                 dst_ip=int(t.remote_ip[qpn]))
        # responder will stream n_pkts of responses; budget accounted as 1
        t.npsn[qpn] = (psn + 1) & pk.PSN_MASK
        self._read_pending[qpn] = length
        self.retx.hold(qpn, p, self.net.now)
        self._send(qpn, p)

    def _send(self, local_qpn: int, p: pk.Packet):
        self.stats.tx_pkts += 1
        n_paths = getattr(self.net, "n_paths", 0)
        if self.path_select and n_paths > 1 and p.opcode in pk.PAYLOAD_OPS:
            # stamp the spine this payload should ride; control packets
            # stay unstamped (the fabric picks).  Happens AFTER the
            # retransmit buffer cloned the packet, so a resend re-picks
            # its path — re-sending down a failed or congested spine
            # would repeat the very loss being repaired.
            p.path_id = self._pick_path(local_qpn, n_paths)
        if self.sniffer is not None:
            self.sniffer.capture(p, self.net.now, direction="tx")
        dst = self._peer[local_qpn]
        self.net.send(self.node_id, dst, p)

    def _pick_path(self, qpn: int, n_paths: int) -> int:
        paths = getattr(self.net, "alive_paths", None) \
            or tuple(range(n_paths))
        if self.path_select == "ecmp":
            # stable per-flow hash: one QP stays on one spine
            h = (qpn * 0xC2B2AE3D + self.node_id * 0x9E3779B1) & 0xFFFFFFFF
            return paths[h % len(paths)]
        rate = self.fc.rate
        if rate is not None and rate.multipath:
            # congestion-aware spray: weight by per-path DCQCN tokens
            return rate.pick_path(qpn, paths)
        c = self._path_rr.get(qpn, 0)
        self._path_rr[qpn] = c + 1
        return paths[c % len(paths)]

    # -------------------------------------------------------- RX internals
    def on_packets(self, pkts: List[pk.Packet]):
        """Feed an arriving packet batch through the RX pipeline on the
        node's device.  Host/device traffic per batch: the header matrix
        and the credit column go down, the packed result matrix (with
        the per-QP CE tally and the new credits) comes back in one copy;
        with a service chain, the payload goes down and the processed
        payload and flags come back."""
        if not pkts:
            return
        self.stats.rx_pkts += len(pkts)
        if self.sniffer is not None:
            for p in pkts:
                self.sniffer.capture(p, self.net.now, direction="rx")
        # control-plane packets (ACK/NAK) handled on the control path
        data_pkts = []
        for p in pkts:
            if p.opcode == pk.ACK:
                self._on_ack(p)
            elif p.opcode == pk.NAK:
                self._on_nak(p)
            elif p.opcode == pk.NAK_PROT:
                self._on_nak_prot(p)
            elif p.opcode == pk.CNP:
                self._on_cnp(p)
            elif p.opcode == pk.READ_REQUEST:
                self._on_read_request(p)
            else:
                data_pkts.append(p)
        if not data_pkts:
            return
        batch_np = pk.batch_from_packets(data_pkts, self.mtu)
        n = len(data_pkts)
        # pad to the next power-of-two multiple of RX_PAD (the reference
        # pads to bound its jit shapes; kept so result shapes match)
        target = RX_PAD
        while target < n:
            target *= 2
        pad = target - n
        if pad:
            for k, v in batch_np.items():
                batch_np[k] = np.concatenate(
                    [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
            batch_np["valid"][n:] = 0
        # sync credits from the host-side credit manager
        self.rx_tables = self.rx_tables._replace(
            credits=to_device(np.asarray(self.credits.credits, np.int32),
                              self.device))
        self.rx_tables, res = self._rx_pipe(self.rx_tables, batch_np)
        # one device-to-host copy: per-packet results, CE tally, credits
        n_qps = self.rx_tables.credits.shape[0]
        packed = torch.cat(
            [torch.stack([getattr(res, k)[:n].to(torch.int32)
                          for k in pipe.RxResult._fields
                          if k != "ecn_cnt"]).reshape(-1),
             res.ecn_cnt.to(torch.int32),
             self.rx_tables.credits]).cpu().numpy()
        fields = [k for k in pipe.RxResult._fields if k != "ecn_cnt"]
        rows = packed[:len(fields) * n].reshape(len(fields), n)
        res = {k: (rows[i] > 0 if k in pipe._OUT_BOOL else rows[i])
               for i, k in enumerate(fields)}
        ecn_cnt = packed[len(fields) * n:len(fields) * n + n_qps]
        self.credits.credits = list(packed[len(fields) * n + n_qps:])
        # attribute CE marks to the spine that carried them, so the CNP
        # can steer the sender's per-path rate cut (ecn_cnt only says
        # *which QP*; the packet's path_id says which plane)
        ce_path: Dict[int, int] = {}
        for p in data_pkts:
            if p.ecn and p.opcode in pk.PAYLOAD_OPS:
                ce_path[p.qpn] = p.path_id
        self._emit_cnps(ecn_cnt, ce_path)

        # ---- service chain over the accepted payload stream -------------
        payload = batch_np["payload"][:n]
        plen = batch_np["plen"][:n]
        flags = np.zeros(n, np.int64)
        if self.services is not None:
            out, f = self.services.process(to_device(payload, self.device),
                                           to_device(plen, self.device))
            payload = out.cpu().numpy()
            flags = f.cpu().numpy()

        # ---- DMA accepted payloads into registered memory ----------------
        for i, p in enumerate(data_pkts):
            qpn = p.qpn
            if res["accept"][i]:
                self.stats.accepted += 1
                if flags[i]:
                    # DPI decision flag -> host-directed command (user
                    # interrupt analogue): count + still deliver
                    self.stats.dpi_flagged += 1
                buf = self._buffer_for(qpn)
                if buf is not None:
                    a = int(res["dma_addr"][i])
                    ln = int(res["dma_len"][i])
                    buf[a:a + ln] = payload[i][:ln]
                    if self._sr:
                        # out-of-order acceptance: merge the landed
                        # interval, advance the contiguous watermark
                        # only when the gap before it has filled
                        self._sr_note_progress(qpn, a, ln)
                    else:
                        # in-order acceptance makes this the contiguous
                        # frontier (max against replays of acked data)
                        self._rx_progress[qpn] = max(
                            self._rx_progress.get(qpn, 0), a + ln)
                self.credits.note_accepted(qpn)
                # host consumes the payload -> credit returns (paper §4.3)
                self._replenish_credit(qpn)
                if res["send_ack"][i]:
                    self._send_ctrl(qpn, pk.make_ack(
                        self._remote_qpn(qpn), int(res["ack_psn"][i]),
                        sack=int(res["sack"][i])))
                if p.opcode in (pk.WRITE_LAST, pk.WRITE_ONLY,
                                pk.READ_RESP_LAST, pk.READ_RESP_ONLY):
                    if self._sr:
                        # completion only once every earlier PSN landed
                        self._sr_pending_last.setdefault(
                            qpn, []).append(p.psn)
                    else:
                        self._completions[qpn] = \
                            self._completions.get(qpn, 0) + 1
                        self._rec("completion", qpn, psn=p.psn)
            elif res["dup"][i]:
                self.stats.dup_dropped += 1
                self._send_ctrl(qpn, pk.make_ack(self._remote_qpn(qpn),
                                                 int(res["ack_psn"][i]),
                                                 sack=int(res["sack"][i])))
            elif res["dropped_credit"][i]:
                self.stats.credit_dropped += 1   # silent drop: peer retransmits
                self.credits.note_dropped(qpn)
            elif res["rkey_err"][i]:
                # remote-access protection error: the wire rkey does not
                # match the registered buffer — NAK fatally, serve nothing
                self.stats.prot_errors += 1
                self._send_ctrl(qpn, pk.make_nak_prot(
                    self._remote_qpn(qpn), p.psn))
            elif res["ooo"][i]:
                self.stats.ooo_nak += 1
                self._rec("nak", qpn, psn=p.psn,
                          expected=int(res["ack_psn"][i]) + 1)
                self._send_ctrl(qpn, pk.make_ack(self._remote_qpn(qpn),
                                                 int(res["ack_psn"][i]),
                                                 nak=True))
        if self._sr and self._sr_pending_last:
            self._flush_sr_completions()

    # ---- selective-repeat host bookkeeping -----------------------------
    def _sr_note_progress(self, qpn: int, a: int, ln: int):
        """Merge the byte interval ``[a, a+ln)`` into this QP's landed
        set and advance the contiguous watermark over any now-filled
        gaps — the streaming-consumer invariant (every byte below the
        watermark is present) survives out-of-order DMA."""
        pend = self._sr_pend.setdefault(qpn, {})
        pend[a] = max(pend.get(a, 0), a + ln)
        fr = self._rx_progress.get(qpn, 0)
        advanced = True
        while advanced:
            advanced = False
            for s in sorted(pend):
                if s > fr:
                    break
                fr = max(fr, pend.pop(s))
                advanced = True
        self._rx_progress[qpn] = fr
        if not pend:
            self._sr_pend.pop(qpn, None)

    def _flush_sr_completions(self):
        """Deferred message completions: a LAST/ONLY fragment accepted
        out of order completes only when the receive window's cumulative
        edge (epsn) has passed it — i.e. every fragment before it
        landed."""
        span = pk.PSN_MASK + 1
        epsn_col = self.rx_tables.epsn.cpu().numpy()
        for qpn in list(self._sr_pending_last):
            epsn = int(epsn_col[qpn])
            lst = self._sr_pending_last[qpn]
            done = [ps for ps in lst
                    if ((ps - epsn) % span) > pk.PSN_MASK // 2]
            if not done:
                continue
            self._completions[qpn] = self._completions.get(qpn, 0) \
                + len(done)
            for ps in done:
                self._rec("completion", qpn, psn=ps)
            rest = [ps for ps in lst
                    if ((ps - epsn) % span) <= pk.PSN_MASK // 2]
            if rest:
                self._sr_pending_last[qpn] = rest
            else:
                del self._sr_pending_last[qpn]

    def _on_ack(self, p: pk.Packet):
        qpn = self._local_qpn(p.qpn)
        released = self.retx.ack(qpn, p.ack_psn)
        if p.sack_bits:
            sacked = self.retx.sack_release(qpn, p.ack_psn, p.sack_bits)
            self.stats.sacked += sacked
            released += sacked
            if sacked:
                self._rec("sack", qpn, released=sacked, ack_psn=p.ack_psn)
            self._maybe_gap_resend(qpn, p)
        for passed in self.fc.ack(qpn, max(released, 1)):
            self._dispatch(qpn, passed[1])

    def _maybe_gap_resend(self, qpn: int, p: pk.Packet):
        """Selective-repeat fast retransmit: the SACK bitmap proves
        delivery up to its highest bit, so held slots lagging it by
        ``sr_gap_lag``+ PSNs are gaps (lost, not just reordered) —
        resend exactly those, rate-limited like NAK bursts."""
        if qpn in self._fatal_qps:
            return
        last = self._last_gap_resend.get(qpn, -10**9)
        if self.net.now - last < self.NAK_HOLDOFF:
            return
        hi = (p.ack_psn + p.sack_bits.bit_length()) & pk.PSN_MASK
        resend = self.retx.gap_resend(qpn, p.ack_psn, hi,
                                      self.sr_gap_lag, self.net.now)
        if resend:
            self._last_gap_resend[qpn] = self.net.now
            for rp in resend:
                self._send_retx(qpn, rp)

    CNP_HOLDOFF = 8      # ticks: NP-side CNP coalescing window per QP

    def _emit_cnps(self, ecn_cnt: np.ndarray,
                   ce_path: Optional[Dict[int, int]] = None):
        """DCQCN NP role: one (coalesced) CNP per QP that saw CE marks in
        this batch.  Runs unconditionally — the notification point needs
        no local DCQCN state, so any receiver disciplines any sender.
        ``ce_path`` maps QP -> the spine a CE-marked packet crossed; the
        CNP echoes it so a multipath reaction point cuts that plane."""
        for qpn in np.nonzero(ecn_cnt)[0]:
            qpn = int(qpn)
            self.stats.ecn_marked_rx += int(ecn_cnt[qpn])
            last = self._last_cnp_sent.get(qpn, -10**9)
            if self.net.now - last < self.CNP_HOLDOFF:
                continue
            self._last_cnp_sent[qpn] = self.net.now
            self.stats.cnp_tx += 1
            self._rec("cnp_tx", qpn, marks=int(ecn_cnt[qpn]))
            path = ce_path.get(qpn, -1) if ce_path else -1
            self._send_ctrl(qpn, pk.make_cnp(self._remote_qpn(qpn),
                                             src_ip=self.node_id,
                                             path_id=path))

    def _on_cnp(self, p: pk.Packet):
        """DCQCN RP role: cut this QP's rate.  A CNP is a pure
        congestion signal — it must NOT release retransmission slots or
        ACK-clocked budget (go-back-N state is untouched)."""
        qpn = self._local_qpn(p.qpn)
        self.stats.cnp_rx += 1
        self._rec("cnp_rx", qpn, path=p.path_id)
        self.fc.on_cnp(qpn, self.net.now, path=p.path_id)

    NAK_HOLDOFF = 8      # ticks: rate-limit go-back-N resend bursts

    def _on_nak_prot(self, p: pk.Packet):
        """Remote-access protection error: fatal for the QP.  Unlike a
        sequence NAK there is nothing to retransmit — the rkey can never
        become right by retrying — so the QP goes straight to the error
        state (recover via ``reestablish_qp`` after re-exchanging keys)."""
        qpn = self._local_qpn(p.qpn)
        self.stats.nak_prot_rx += 1
        self.qp_errors.add(qpn)
        self._fatal_qps.add(qpn)

    def _on_nak(self, p: pk.Packet):
        qpn = self._local_qpn(p.qpn)
        if qpn in self._fatal_qps:
            return       # fatal QP: no more replays until re-established
        last = self._last_nak_resend.get(qpn, -10**9)
        if self.net.now - last < self.NAK_HOLDOFF:
            return       # a resend burst is already in flight
        self._last_nak_resend[qpn] = self.net.now
        expected = (p.ack_psn + 1) & pk.PSN_MASK
        for rp in self.retx.nak(qpn, expected, self.net.now):
            self._send_retx(qpn, rp)

    def _send_retx(self, qpn: int, rp: pk.Packet):
        """Send a retransmission — immediately under plain ACK clocking,
        through the pacing bucket under DCQCN (the rate limiter sits at
        the wire: a resend burst must not re-congest the very queue
        whose overflow it is repairing)."""
        if qpn in self._fatal_qps:
            return       # fatal QP: hold fire until re-established
        if self.fc.rate is None:
            self.stats.retransmissions += 1
            self._rec("retransmit", qpn, psn=rp.psn)
            self._send(qpn, rp)
            return
        staged = self._retx_staged.setdefault(qpn, [])
        if any(s.psn == rp.psn for s in staged):
            return       # this PSN is already awaiting tokens
        staged.append(rp)

    def _drain_staged_retx(self):
        rate = self.fc.rate
        if rate is None or not self._retx_staged:
            return
        for qpn in sorted(self._retx_staged):
            if qpn in self._fatal_qps:
                continue     # parked until reestablish_qp clears the stage
            q = self._retx_staged[qpn]
            while q and rate.take(qpn, 1):
                self.stats.retransmissions += 1
                self._rec("retransmit", qpn, psn=q[0].psn)
                self._send(qpn, q.pop(0))
        self._retx_staged = {q: v for q, v in self._retx_staged.items() if v}

    def _on_read_request(self, p: pk.Packet):
        """Responder side of RDMA READ: stream the requested region
        through the same flow-control path as writes (the response
        stream is ACK-clocked too).  The wire rkey is validated against
        the registered buffer first — a mismatch is NAKed with a
        protection error instead of serving the read."""
        qpn = p.qpn                      # our local QPN (dst of the request)
        if p.rkey != self._local_rkey.get(qpn):
            self.stats.prot_errors += 1
            self._send_ctrl(qpn, pk.make_nak_prot(self._remote_qpn(qpn),
                                                  p.psn))
            return
        buf = self._buffer_for(qpn)
        data = buf[p.vaddr:p.vaddr + p.dma_len] if buf is not None else \
            np.zeros(p.dma_len, np.uint8)
        # ACK the request BEFORE streaming the response: on a shaped
        # link the ACK would otherwise queue behind the whole response
        # burst, leaving the requester's READ_REQUEST retransmit slot
        # held (and its fc budget debited) for the entire stream — and
        # parking the fused epoch core (core.fused) in per-tick fallback
        # for exactly as long, since a non-payload held slot is one of
        # the things its in-graph twin does not model
        self._send_ctrl(qpn, pk.make_ack(self._remote_qpn(qpn), p.psn))
        self._submit(qpn, "read_resp", 0, data)

    # ------------------------------------------------------------ timers
    def tick(self):
        # rate-paced drain (DCQCN): token buckets refill once per tick;
        # staged retransmissions spend tokens before new requests (they
        # carry the oldest PSNs, and go-back-N wants them in order)
        self.fc.tick_rate(self.net.now)
        self._drain_staged_retx()
        for qpn, item in self.fc.tick(self.net.now):
            self._dispatch(qpn, item[1])
        for qpn, rp in self.retx.tick(self.net.now):
            self._send_retx(qpn, rp)
        # surface retry-budget exhaustion as a QP error instead of
        # retransmitting forever (upper layers re-establish or fail over)
        exhausted = self.retx.exhausted
        while self._exhausted_seen < len(exhausted):
            qpn, psn = exhausted[self._exhausted_seen]
            self._exhausted_seen += 1
            if qpn not in self.qp_errors:
                self._rec("qp_error", qpn, psn=psn)
            self.qp_errors.add(qpn)

    def qp_error(self, qpn: int) -> bool:
        """True if the QP died on retry-budget exhaustion (fatal until
        ``reestablish_qp``)."""
        return qpn in self.qp_errors

    def reestablish_qp(self, qpn: int, start_psn: int = 0):
        """Tear down the errored QP's transport state and re-establish it
        (paper §4.6 failover: fresh PSN space, empty retransmit ring,
        drained flow-control queue)."""
        self.retx.slots.pop(qpn, None)
        self._retx_staged.pop(qpn, None)     # stale PSNs must not leak
        self.fc.pending[qpn].clear()
        self.fc.outstanding[qpn] = 0
        self.fc.budget[qpn] = self.fc.cfg.window
        self._last_nak_resend.pop(qpn, None)
        self._last_cnp_sent.pop(qpn, None)
        self._last_gap_resend.pop(qpn, None)
        self._rx_progress.pop(qpn, None)
        self._sr_pend.pop(qpn, None)
        self._sr_pending_last.pop(qpn, None)
        self.qp_errors.discard(qpn)
        self._fatal_qps.discard(qpn)
        self.qp.reestablish(qpn, start_psn)
        t = self.qp.tables
        # mirror the reset into the device RX tables
        self.rx_tables.epsn[qpn] = start_psn
        for col in ("msn", "bytes_left", "cur_vaddr", "rxbit"):
            getattr(self.rx_tables, col)[qpn] = 0
        t.npsn[qpn] = start_psn

    # ------------------------------------------------------------ helpers
    def _buffer_for(self, qpn: int):
        ent = self._qp_buffer.get(qpn)
        return ent[1] if ent else None

    def _remote_qpn(self, local_qpn: int) -> int:
        return int(self.qp.tables.remote_qpn[local_qpn])

    def _local_qpn(self, qpn_in_packet: int) -> int:
        return qpn_in_packet      # packets carry the destination QPN

    def _replenish_credit(self, qpn: int):
        self.credits.replenish(qpn, 1)

    def _send_ctrl(self, local_qpn: int, p: pk.Packet):
        self._send(local_qpn, p)


def step_network(nodes: List[RdmaNode]) -> None:
    """Advance the simulation by exactly ONE tick: deliver in-flight
    packets to their destination nodes, then run every node's timer
    tick.  The incremental unit ``run_network`` is built from — and the
    primitive streaming consumers (``repro.core.ingest``) interleave
    with completion-watermark polls to process data *as it arrives*
    instead of store-and-forwarding whole transfers."""
    net = nodes[0].net
    delivered = net.tick()
    for (src, dst), pkts in delivered.items():
        if pkts:
            nodes[dst].on_packets(pkts)
    for nd in nodes:
        nd.tick()


def network_pending(nodes: List[RdmaNode]) -> bool:
    """True while any transport work remains: packets in flight, unacked
    payloads awaiting (re)transmission, or queued flow-control requests.
    QPs dead on a protection error park their unacked slots until
    ``reestablish_qp`` — they are not live work (retrying can never
    succeed); retry-exhaustion QPs keep replaying their surviving slots
    exactly as before."""
    net = nodes[0].net
    if not net.quiescent():
        return True
    for nd in nodes:
        if any(nd.retx.outstanding(q) for q in nd.retx.slots
               if q not in nd._fatal_qps):
            return True
        if any(nd.fc.queue_depth(q) for q in range(len(nd.fc.pending))
               if nd.fc.pending[q] and q not in nd._fatal_qps):
            return True
    return False


EPOCH_MODES = ("tick", "fused")


def resolve_epoch_mode(epoch_mode: Optional[str]) -> str:
    """The reference's choice of epoch mode: an explicit ``epoch_mode``,
    else the ``BALBOA_EPOCH_MODE`` environment variable, else
    ``"tick"``.  An unknown mode raises ``ValueError``."""
    mode = epoch_mode or os.environ.get("BALBOA_EPOCH_MODE") or "tick"
    if mode not in EPOCH_MODES:
        raise ValueError(f"unknown epoch_mode {mode!r}; "
                         f"choose from {EPOCH_MODES}")
    return mode


def check_epoch_mode(epoch_mode: Optional[str]) -> None:
    """Constructors' early check of an explicit ``epoch_mode`` (``None``
    defers to ``BALBOA_EPOCH_MODE`` when the network runs)."""
    if epoch_mode is not None:
        resolve_epoch_mode(epoch_mode)


def run_network(nodes: List[RdmaNode], max_ticks: int = 100_000,
                idle_done: int = 8, *,
                epoch_mode: Optional[str] = None) -> int:
    """Drive the simulation until quiescent: no packets in flight, no
    unacked payloads awaiting (re)transmission, no queued flow-control
    requests.  Returns ticks elapsed.

    ``epoch_mode="fused"`` (or env ``BALBOA_EPOCH_MODE=fused``) runs
    whole epochs as one launch of the fused epoch kernel on the nodes'
    device (``repro_torch.core.fused``) instead of round-tripping
    device<->host every tick; any world the fused core does not model
    falls back to per-tick stepping, one tick at a time, re-attempting
    fusion after each (e.g. an in-flight READ_REQUEST unfuses only until
    it is ACKed).  The fused path is bit-identical to per-tick stepping
    — pinned by tests/test_torch_fused_core.py — except that
    interleaving fallback ticks with fused epochs may re-run up to
    ``idle_done`` quiescent (no-op) ticks, shifting only ``net.now`` and
    the returned count, exactly as the reference does."""
    if resolve_epoch_mode(epoch_mode) == "fused":
        from repro_torch.core import fused as _fused
        t, idle = 0, 0
        while t < max_ticks:
            res = _fused.run_fused_epoch(nodes, max_ticks=max_ticks - t,
                                         idle_done=idle_done)
            if res is None:                      # unfusable: oracle tick
                step_network(nodes)
                t += 1
                if network_pending(nodes):
                    idle = 0
                else:
                    idle += 1
                    if idle >= idle_done:
                        return t - 1
                continue
            t += res["steps"]
            if res["idle_exit"]:
                return t - 1
        return max_ticks
    idle = 0
    for t in range(max_ticks):
        step_network(nodes)
        if network_pending(nodes):
            idle = 0
        else:
            idle += 1
            if idle >= idle_done:
                return t
    return max_ticks
