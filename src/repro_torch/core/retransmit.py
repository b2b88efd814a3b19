"""Retransmission buffer and transport timer (paper §4.2).

All transmitted payloads are held in a dedicated buffer ("directly
exposed HBM channel" on the FPGA) until the remote end acknowledges
reception; timeouts or NAKs (PSN sequence errors) release them back onto
the TX path without another host round-trip.

FPGA -> TPU design dual: the FPGA parks payloads in HBM and replays
them from hardware timers; the dual keeps a per-QP PSN-keyed dict of
held packets on the host (retransmission is the rare path — it only
runs when the simulated network loses or reorders, so it stays off the
jitted hot path) with the same cumulative-ACK release, go-back-N NAK
replay and exponential-backoff timer semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import packet as pk


@dataclasses.dataclass
class _Slot:
    psn: int
    packet: pk.Packet
    deadline: int          # retransmit when now >= deadline
    retries: int = 0


class RetransmissionBuffer:
    """Per-QP ring of unacked packets, keyed by PSN."""

    MAX_RETRIES = 16

    def __init__(self, timeout_ticks: int = 64, capacity: int = 4096):
        self.timeout = timeout_ticks
        self.capacity = capacity
        self.slots: Dict[int, Dict[int, _Slot]] = {}   # qpn -> psn -> slot
        self.retransmissions = 0
        self.exhausted: List[Tuple[int, int]] = []     # fatal (qpn, psn)

    def hold(self, qpn: int, p: pk.Packet, now: int):
        q = self.slots.setdefault(qpn, {})
        if len(q) >= self.capacity:
            raise RuntimeError(f"retransmission buffer overflow qp={qpn}")
        q[p.psn] = _Slot(p.psn, p.clone(), now + self.timeout)

    def ack(self, qpn: int, ack_psn: int) -> int:
        """Cumulative ACK: release every slot with psn <= ack_psn
        (mod-24-bit window).  Returns number released.

        Progress resets the retry counters of the remaining slots —
        RoCE's retry budget counts *consecutive* no-progress events, not
        total retransmissions (go-back-N would otherwise burn the budget
        of healthy flows)."""
        q = self.slots.get(qpn, {})
        released = [s for s in q
                    if ((ack_psn - s) % (pk.PSN_MASK + 1)) <= pk.PSN_MASK // 2]
        for s in released:
            del q[s]
        if released:
            for slot in q.values():
                slot.retries = 0
        return len(released)

    def nak(self, qpn: int, expected_psn: int, now: int) -> List[pk.Packet]:
        """PSN sequence error at the peer: retransmit from expected_psn."""
        return self._resend(qpn, expected_psn, now)

    def sack_release(self, qpn: int, ack_psn: int, sack_bits: int) -> int:
        """Selective ACK: release the individually-acknowledged slots a
        selective-repeat receiver reports holding out of order (bitmap
        bit k => PSN ``ack_psn + 1 + k`` received).  Returns the number
        released.  Like cumulative progress, a selective release resets
        the remaining slots' retry counters — the peer demonstrably got
        packets, so the flow is not stuck."""
        q = self.slots.get(qpn, {})
        released = 0
        k = 1                        # bit 0 (= ack_psn + 1 in sequence)
        bits = sack_bits >> 1        # would be a cumulative advance
        while bits:
            if bits & 1:
                psn = (ack_psn + 1 + k) & pk.PSN_MASK
                if q.pop(psn, None) is not None:
                    released += 1
            bits >>= 1
            k += 1
        if released:
            for slot in q.values():
                slot.retries = 0
        return released

    def gap_resend(self, qpn: int, ack_psn: int, upto_psn: int,
                   min_lag: int, now: int) -> List[pk.Packet]:
        """Selective-repeat fast retransmit: resend only the *gaps* — the
        held slots strictly after the cumulative ACK but at least
        ``min_lag`` PSNs behind ``upto_psn`` (the highest PSN the
        receiver's SACK proves delivered).  The lag guard keeps plain
        multipath reorder (fast-spine packets overtaking slow-spine
        ones) from triggering spurious resends; a real loss keeps
        falling further behind the SACK frontier until it crosses the
        threshold."""
        span = pk.PSN_MASK + 1
        q = self.slots.get(qpn, {})
        out = []
        for slot in sorted(q.values(), key=lambda s: s.psn):
            after_ack = 0 < ((slot.psn - ack_psn) % span) <= pk.PSN_MASK // 2
            lag = (upto_psn - slot.psn) % span
            if after_ack and lag <= pk.PSN_MASK // 2 and lag >= min_lag:
                out.extend(self._bump(qpn, slot, now))
        return out

    def tick(self, now: int) -> List[Tuple[int, pk.Packet]]:
        """Transport timer: collect timed-out (local_qpn, packet) pairs.
        Slots that exhausted their retry budget are evicted (fatal for
        the flow — surfaced via ``self.exhausted`` so the upper layer
        can tear down / re-establish the QP)."""
        out = []
        # sorted: replay order must not depend on dict insertion
        # history (reestablish_qp pops and re-adds a QP's slot map)
        for qpn in sorted(self.slots):
            q = self.slots[qpn]
            dead = []
            for slot in sorted(q.values(), key=lambda s: s.psn):
                if now >= slot.deadline:
                    resend = self._bump(qpn, slot, now)
                    if not resend and slot.retries > self.MAX_RETRIES:
                        dead.append(slot.psn)
                    out.extend((qpn, p) for p in resend)
            for psn in dead:
                q.pop(psn, None)
        return out

    def _resend(self, qpn: int, from_psn: int, now: int) -> List[pk.Packet]:
        q = self.slots.get(qpn, {})
        out = []
        for slot in sorted(q.values(), key=lambda s: s.psn):
            behind = ((slot.psn - from_psn) % (pk.PSN_MASK + 1)) \
                <= pk.PSN_MASK // 2
            if behind:
                out.extend(self._bump(qpn, slot, now))
        return out

    def _bump(self, qpn: int, slot: _Slot, now: int) -> List[pk.Packet]:
        slot.retries += 1
        if slot.retries > self.MAX_RETRIES:
            self.exhausted.append((qpn, slot.psn))
            return []
        slot.deadline = now + self.timeout * (1 << min(slot.retries, 4))
        self.retransmissions += 1
        return [slot.packet.clone()]

    def outstanding(self, qpn: int) -> int:
        return len(self.slots.get(qpn, {}))

    def snapshot(self) -> dict:
        """Common telemetry shape (see ``telemetry.MetricRegistry``)."""
        return {"retransmissions": self.retransmissions,
                "exhausted": len(self.exhausted),
                "held": sum(len(q) for q in self.slots.values())}
