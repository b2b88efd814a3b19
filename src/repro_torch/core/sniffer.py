"""Traffic sniffer (paper §4.7): capture traversing packets into a
standard PCAP file for analysis with Wireshark-class tools.

Mirrors the paper's design: a header-selecting filter at the link level
(e.g. capture only RoCE v2), optional payload omission to cut the
instrumentation footprint, and full bidirectional RX/TX capture that
never perturbs the datapath (we only copy header fields + optionally the
payload).  Packets are synthesized into Ethernet/IPv4/UDP/IB-BTH wire
format so standard dissectors decode them.

FPGA -> TPU design dual: the FPGA taps the MAC at line rate into a
DMA ring; here capture is a host-side observer on RdmaNode TX/RX (the
simulator's tick clock stands in for hardware timestamps), emitting the
same PCAP byte format.
"""
from __future__ import annotations

import struct
from typing import List, Optional

from repro_torch.core import packet as pk

_PCAP_GLOBAL = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
_ETH_IPV4 = b"\x08\x00"


def _ipv4(addr: int) -> bytes:
    return struct.pack(">I", addr & 0xFFFFFFFF)


class TrafficSniffer:
    def __init__(self, *, capture_payload: bool = True,
                 protocol_filter: Optional[str] = "rocev2",
                 tick_ns: int = 1000):
        self.capture_payload = capture_payload
        self.protocol_filter = protocol_filter
        self.tick_ns = tick_ns
        self.records: List[bytes] = []
        self.n_rx = 0
        self.n_tx = 0

    def capture(self, p: pk.Packet, now_ticks: int, direction: str = "rx"):
        if self.protocol_filter == "rocev2" and p.dst_port != pk.UDP_DPORT_ROCE:
            return
        if direction == "rx":
            self.n_rx += 1
        else:
            self.n_tx += 1
        payload = b""
        if self.capture_payload and p.payload is not None:
            payload = p.payload.tobytes()
        # --- InfiniBand BTH (12 bytes) + RETH (16) when present ----------
        bth = struct.pack(">BBHI I",
                          p.opcode & 0xFF, 0, 0xFFFF,
                          p.qpn & 0x00FFFFFF,
                          ((1 if p.ack_req else 0) << 31)
                          | (p.psn & pk.PSN_MASK))
        ib = bth
        if p.opcode in pk.RETH_OPS:
            ib += struct.pack(">QII", p.vaddr, p.rkey, p.dma_len)
        ib += payload + struct.pack(">I", p.icrc & 0xFFFFFFFF)
        # --- UDP ----------------------------------------------------------
        udp_len = 8 + len(ib)
        udp = struct.pack(">HHHH", p.src_port or 0xC000, p.dst_port,
                          udp_len, 0) + ib
        # --- IPv4 ----------------------------------------------------------
        total = 20 + udp_len
        ip = struct.pack(">BBHHHBBH", 0x45, 0, total, 0, 0, 64, 17, 0) \
            + _ipv4(p.src_ip) + _ipv4(p.dst_ip) + udp
        # --- Ethernet -------------------------------------------------------
        eth = b"\x02" * 6 + b"\x04" * 6 + _ETH_IPV4 + ip
        ts_ns = now_ticks * self.tick_ns
        hdr = struct.pack("<IIII", ts_ns // 1_000_000_000,
                          (ts_ns % 1_000_000_000) // 1000,
                          len(eth), len(eth))
        self.records.append(hdr + eth)

    def write_pcap(self, path: str) -> int:
        with open(path, "wb") as f:
            f.write(_PCAP_GLOBAL)
            for r in self.records:
                f.write(r)
        return len(self.records)
