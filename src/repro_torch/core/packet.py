"""RoCE v2 packet model (paper §4.1).

Packets follow the RoCE v2 header stack (IP / UDP / InfiniBand BTH /
RETH).  Opcode values follow the InfiniBand RC opcode space.

FPGA -> TPU design dual: the FPGA parses one 512-bit header beat per
cycle through pipelined FSMs; the dual represents a *batch* of packets
as a dict of arrays (one column per header field, payloads padded to
MTU) so the RX/TX pipelines in ``repro_torch.core.pipeline`` and the service
chain are SIMD across packets instead of across clock cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

# --- IB RC opcodes (subset BALBOA implements: one-sided ops + ACK) --------
WRITE_FIRST = 0x06
WRITE_MIDDLE = 0x07
WRITE_LAST = 0x08
WRITE_ONLY = 0x0A
READ_REQUEST = 0x0C
READ_RESP_FIRST = 0x0D
READ_RESP_MIDDLE = 0x0E
READ_RESP_LAST = 0x0F
READ_RESP_ONLY = 0x10
ACK = 0x11
NAK = 0x31          # we fold the NAK syndrome into its own opcode
NAK_PROT = 0x32     # NAK, remote-access (R_Key) protection error: fatal,
                    # the requester must not retry (IB "Remote Access Error")
CNP = 0x81          # RoCE v2 congestion notification packet (DCQCN NP->RP)

OPCODE_NAMES = {
    WRITE_FIRST: "WRITE_FIRST", WRITE_MIDDLE: "WRITE_MIDDLE",
    WRITE_LAST: "WRITE_LAST", WRITE_ONLY: "WRITE_ONLY",
    READ_REQUEST: "READ_REQUEST", READ_RESP_FIRST: "READ_RESP_FIRST",
    READ_RESP_MIDDLE: "READ_RESP_MIDDLE", READ_RESP_LAST: "READ_RESP_LAST",
    READ_RESP_ONLY: "READ_RESP_ONLY", ACK: "ACK", NAK: "NAK",
    NAK_PROT: "NAK_PROT", CNP: "CNP",
}

WRITE_OPS = (WRITE_FIRST, WRITE_MIDDLE, WRITE_LAST, WRITE_ONLY)
READ_RESP_OPS = (READ_RESP_FIRST, READ_RESP_MIDDLE, READ_RESP_LAST,
                 READ_RESP_ONLY)
# opcodes that carry an address (start of a new DMA region).  NOTE: on
# the wire, READ RESPONSEs carry no RETH (the requester tracks its
# scatter address); our simulator attaches the base address to the first
# response fragment instead of a per-QP pending-read table — same
# semantics, recorded as a simplification in DESIGN.md.
RETH_OPS = (WRITE_FIRST, WRITE_ONLY, READ_REQUEST, READ_RESP_FIRST,
            READ_RESP_ONLY)
# opcodes that carry payload
PAYLOAD_OPS = WRITE_OPS + READ_RESP_OPS

MTU = 4096                      # paper §6: MTU set to 4K
UDP_DPORT_ROCE = 4791           # RoCE v2 well-known UDP port
PSN_MASK = 0x00FF_FFFF          # 24-bit PSN space


@dataclasses.dataclass
class Packet:
    """One RoCE v2 packet (host-side representation)."""
    # IP / UDP
    src_ip: int = 0
    dst_ip: int = 0
    src_port: int = 0
    dst_port: int = UDP_DPORT_ROCE
    # BTH
    opcode: int = ACK
    qpn: int = 0
    psn: int = 0
    ack_req: bool = False
    # RETH (valid for RETH_OPS)
    vaddr: int = 0
    rkey: int = 0
    dma_len: int = 0
    # AETH-ish (for ACK/NAK): cumulative PSN being acknowledged
    ack_psn: int = 0
    msn: int = 0
    # Selective-ACK bitmap (selective-repeat RX mode): bit k set means
    # PSN ``ack_psn + 1 + k`` was received out of order (bit 0 — the
    # expected PSN itself — is never set: receiving it advances the
    # cumulative ACK instead).  0 on go-back-N ACKs and on data packets.
    sack_bits: int = 0
    # Multipath routing tag: the spine index a leaf-spine fabric carried
    # (or should carry) this packet over.  Stamped by spraying/ECMP
    # senders, honored and/or (re)stamped by ``netsim.ClosFabric``,
    # echoed into CNPs so per-path DCQCN can cut the congested path
    # only.  -1 = unrouted / single-path fabric.
    path_id: int = -1
    # payload
    payload: Optional[np.ndarray] = None      # uint8[<=MTU]
    icrc: int = 0
    # DPI decision flag travels with the host-directed command (§5.1.2)
    dpi_flag: bool = False
    # IP ECN field: True = Congestion Experienced (CE).  Set by the
    # switch when an egress queue crosses its Kmin/Kmax marking
    # thresholds; echoed by the receiver as a CNP (DCQCN NP role).
    ecn: bool = False
    # Collective CHUNK tag (in-fabric reduction offload).  ``coll_tag``
    # != 0 marks this payload packet as one contribution to a switch-
    # resident reduction slot; the fabric's SwitchReducer absorbs the
    # contribution (synthesizing the transport ACK itself) instead of
    # forwarding it, and releases one summed packet per fragment once
    # all ``coll_nsrc`` contributors delivered it.  ``coll_src`` is the
    # contributor's position in the canonical fold order (NOT its rank;
    # position coll_nsrc-1 is the *carrier* whose packets survive the
    # hop and deliver the sums).  ``coll_frag`` indexes the MTU-sized
    # fragment within the chunk, so slots reduce fragment-wise.
    coll_tag: int = 0
    coll_src: int = -1
    coll_nsrc: int = 0
    coll_frag: int = -1

    @property
    def payload_len(self) -> int:
        return 0 if self.payload is None else int(self.payload.size)

    def clone(self) -> "Packet":
        p = dataclasses.replace(self)
        if self.payload is not None:
            p.payload = self.payload.copy()
        return p


def batch_from_packets(pkts, mtu: int = MTU) -> Dict[str, np.ndarray]:
    """Pack a list of Packets into a dict-of-arrays batch for the
    vectorized (torch) pipelines.  Payloads are padded to ``mtu``."""
    n = len(pkts)
    out = {
        "opcode": np.zeros(n, np.int32),
        "qpn": np.zeros(n, np.int32),
        "psn": np.zeros(n, np.int32),
        "ack_req": np.zeros(n, np.int32),
        "vaddr": np.zeros(n, np.int64),
        "rkey": np.zeros(n, np.int32),
        "dma_len": np.zeros(n, np.int32),
        "ack_psn": np.zeros(n, np.int32),
        "ecn": np.zeros(n, np.int32),
        "plen": np.zeros(n, np.int32),
        "payload": np.zeros((n, mtu), np.uint8),
        "valid": np.ones(n, np.int32),
    }
    for i, p in enumerate(pkts):
        out["opcode"][i] = p.opcode
        out["qpn"][i] = p.qpn
        out["psn"][i] = p.psn
        out["ack_req"][i] = int(p.ack_req)
        out["vaddr"][i] = p.vaddr
        out["rkey"][i] = p.rkey
        out["dma_len"][i] = p.dma_len
        out["ack_psn"][i] = p.ack_psn
        out["ecn"][i] = int(p.ecn)
        if p.payload is not None:
            out["plen"][i] = p.payload.size
            out["payload"][i, :p.payload.size] = p.payload
    return out


def fragment_message(
    qpn: int, start_psn: int, vaddr: int, rkey: int, data: np.ndarray,
    *, op: str = "write", mtu: int = MTU, src_ip: int = 0, dst_ip: int = 0,
    coll: Optional[tuple] = None, addr_per_pkt: bool = False,
):
    """Fragment one RDMA WRITE (or READ RESPONSE) payload into MTU-sized
    packets with FIRST/MIDDLE/LAST/ONLY opcodes, consecutive PSNs and a
    RETH on the first packet (paper §4.1 TX path).

    ``coll = (tag, src, nsrc, frag_base)`` stamps every fragment as a
    collective CHUNK contribution (fragment indices continue from
    ``frag_base``, so one chunk split into several flow-control
    sub-messages still numbers its fragments globally).

    ``addr_per_pkt=True`` makes every fragment self-contained (IRN
    style, for selective-repeat receivers): each packet carries its own
    target address / rkey / length, so an out-of-order arrival can DMA
    without the FIRST fragment's RETH cursor."""
    assert op in ("write", "read_resp")
    data = np.asarray(data, np.uint8)
    n_pkts = max(1, (data.size + mtu - 1) // mtu)
    tag, src, nsrc, frag_base = coll if coll is not None else (0, -1, 0, 0)
    pkts = []
    for i in range(n_pkts):
        chunk = data[i * mtu:(i + 1) * mtu]
        if n_pkts == 1:
            opc = WRITE_ONLY if op == "write" else READ_RESP_ONLY
        elif i == 0:
            opc = WRITE_FIRST if op == "write" else READ_RESP_FIRST
        elif i == n_pkts - 1:
            opc = WRITE_LAST if op == "write" else READ_RESP_LAST
        else:
            opc = WRITE_MIDDLE if op == "write" else READ_RESP_MIDDLE
        if addr_per_pkt:
            p_vaddr, p_rkey, p_len = vaddr + i * mtu, rkey, chunk.size
        else:
            p_vaddr = vaddr if i == 0 else 0
            p_rkey = rkey if i == 0 else 0
            p_len = data.size if i == 0 else 0
        pkts.append(Packet(
            src_ip=src_ip, dst_ip=dst_ip, opcode=opc, qpn=qpn,
            psn=(start_psn + i) & PSN_MASK, ack_req=(i == n_pkts - 1),
            vaddr=p_vaddr, rkey=p_rkey,
            dma_len=p_len, payload=chunk.copy(),
            coll_tag=tag, coll_src=src, coll_nsrc=nsrc,
            coll_frag=(frag_base + i) if tag else -1))
    return pkts


def make_read_request(qpn: int, psn: int, vaddr: int, rkey: int,
                      length: int, src_ip: int = 0, dst_ip: int = 0) -> Packet:
    return Packet(src_ip=src_ip, dst_ip=dst_ip, opcode=READ_REQUEST,
                  qpn=qpn, psn=psn & PSN_MASK, vaddr=vaddr, rkey=rkey,
                  dma_len=length, ack_req=True)


def make_ack(qpn: int, ack_psn: int, msn: int = 0, nak: bool = False,
             sack: int = 0) -> Packet:
    """ACK/NAK with optional selective-ACK bitmap (``sack`` bit k =>
    PSN ``ack_psn + 1 + k`` held out of order by a selective-repeat
    receiver)."""
    return Packet(opcode=NAK if nak else ACK, qpn=qpn,
                  psn=ack_psn & PSN_MASK, ack_psn=ack_psn & PSN_MASK,
                  msn=msn, sack_bits=int(sack))


def make_nak_prot(qpn: int, psn: int = 0) -> Packet:
    """Remote-access protection NAK: the wire rkey did not match the
    registered buffer's rkey.  Fatal for the flow — the requester marks
    the QP errored instead of retrying (retries can never succeed)."""
    return Packet(opcode=NAK_PROT, qpn=qpn, psn=psn & PSN_MASK)


def make_cnp(qpn: int, src_ip: int = 0, dst_ip: int = 0,
             path_id: int = -1) -> Packet:
    """Congestion notification (DCQCN NP -> RP).  Pure control signal:
    carries no PSN/AETH state on purpose — a CNP must never advance
    cumulative-ACK state at the reaction point.  ``path_id`` echoes the
    spine the CE-marked packet crossed, so a multipath reaction point
    can cut the congested path's rate instead of the whole QP's."""
    return Packet(opcode=CNP, qpn=qpn, src_ip=src_ip, dst_ip=dst_ip,
                  path_id=path_id)


def read_resp_npkts(length: int, mtu: int = MTU) -> int:
    return max(1, (length + mtu - 1) // mtu)
