"""Deterministic network simulator: point-to-point links and a switched
fabric.

FPGA -> TPU design dual: the paper evaluates BALBOA on a physical 100G
testbed behind a data-center switch; the dry-run container has no NIC,
so the *protocol logic* is exercised against this simulator instead.
Time is integer ticks; every random decision is seeded, so whole
sender -> network -> RX-pipeline -> ACK -> retransmit loops replay
bit-identically (which is what lets tests assert exactly-once in-order
delivery and lets the batched engine be diffed against the scan oracle
on the very same trace).

Three topologies:

``Network``        — nodes connected pairwise by two directed ``Link``s
                     (loss, reorder, latency, jitter, bandwidth shaping).
                     The original point-to-point model.
``SwitchedFabric`` — a single-switch star: every node hangs off one
                     switch port.  Packets traverse the ingress wire
                     (per-port delay, optional loss), land in the
                     *shared egress queue* of the destination port
                     (drop-tail, finite capacity) and drain at the
                     port's bandwidth.  This is where incast lives: N
                     senders converging on one receiver overflow that
                     receiver's egress queue exactly like a real
                     shallow-buffered ToR switch.  With ``ecn_kmin`` /
                     ``ecn_kmax`` configured, the switch additionally
                     plays the DCQCN congestion-point role: packets are
                     CE-marked (RED-style, at dequeue) instead of only
                     tail-dropped, feeding the CNP/rate-control loop in
                     ``flow_control`` / ``rdma``.
``ClosFabric``     — a two-tier leaf-spine (Clos) fabric: nodes hang
                     off leaf switches, leaves interconnect through
                     ``n_spines`` parallel spine planes.  Cross-leaf
                     packets pick a spine per flow (ECMP hash) or per
                     packet (spray), so the fabric genuinely delivers
                     out of order when spine delays are asymmetric —
                     the arrival pattern selective-repeat RX exists
                     for.  Every stage reuses the same drop-tail /
                     RED-marking egress machinery as the single
                     switch, and a spine can be failed mid-run.

All expose the same surface (``send`` / ``tick`` / ``quiescent`` /
``now``) so ``RdmaNode`` and ``run_network`` work with any of them.

The switched fabric can additionally host a ``SwitchReducer`` (the
in-fabric reduction offload of ``repro.core.collectives``): CHUNK-
tagged packets are folded at the hop instead of forwarded, with the
switch playing a full go-back-N responder toward the contributors.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import chaos as _chaos
from repro_torch.core import packet as pk


@dataclasses.dataclass
class LinkConfig:
    loss_prob: float = 0.0
    reorder_prob: float = 0.0
    latency_ticks: int = 4
    jitter_ticks: int = 0
    bandwidth_pkts_per_tick: int = 0     # 0 = unshaped
    seed: int = 0
    # chaos mode: when set, loss / jitter / reorder decisions come from
    # the counter-keyed hash in ``repro.core.chaos`` instead of the rng
    # stream — replayable inside the fused epoch core (``core.fused``).
    chaos_seed: Optional[int] = None


class Link:
    """One direction of a network path."""

    def __init__(self, cfg: LinkConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self._heap: List[Tuple[int, int, pk.Packet]] = []
        self._seq = 0
        self.sent = 0
        self.dropped = 0
        self.on_event = None     # flight-recorder hook: (kind, packet)
        self._ctick = -1         # chaos mode: per-tick send rank
        self._cidx = 0

    def send(self, p: pk.Packet, now: int):
        self.sent += 1
        if self.cfg.chaos_seed is not None:
            return self._send_chaos(p, now)
        if self.rng.random() < self.cfg.loss_prob:
            self.dropped += 1
            if self.on_event is not None:
                self.on_event("wire_drop", p)
            return
        if self.on_event is not None:
            self.on_event("inject", p)
        delay = self.cfg.latency_ticks
        if self.cfg.jitter_ticks:
            delay += int(self.rng.integers(0, self.cfg.jitter_ticks + 1))
        if self.rng.random() < self.cfg.reorder_prob:
            delay += int(self.rng.integers(1, 8))
        self._seq += 1
        heapq.heappush(self._heap, (now + delay, self._seq, p))

    def _send_chaos(self, p: pk.Packet, now: int):
        """Counter-keyed decisions: every send on this link takes the
        next rank within its tick; each decision hashes (seed, purpose,
        tick, rank) independently — the exact stream ``core.fused``
        replays in-graph."""
        if now != self._ctick:
            self._ctick, self._cidx = now, 0
        i, s = self._cidx, self.cfg.chaos_seed
        self._cidx += 1
        if self.cfg.loss_prob and _chaos.hash32(
                s, _chaos.TAG_LOSS, now, i) < _chaos.u32_prob(
                    self.cfg.loss_prob):
            self.dropped += 1
            if self.on_event is not None:
                self.on_event("wire_drop", p)
            return
        if self.on_event is not None:
            self.on_event("inject", p)
        delay = self.cfg.latency_ticks
        if self.cfg.jitter_ticks:
            delay += _chaos.hash32(s, _chaos.TAG_JITTER, now, i) \
                % (self.cfg.jitter_ticks + 1)
        if self.cfg.reorder_prob and _chaos.hash32(
                s, _chaos.TAG_REORDER, now, i) < _chaos.u32_prob(
                    self.cfg.reorder_prob):
            delay += 1 + _chaos.hash32(s, _chaos.TAG_RDELAY, now, i) % 7
        self._seq += 1
        heapq.heappush(self._heap, (now + delay, self._seq, p))

    def deliver(self, now: int) -> List[pk.Packet]:
        out = []
        budget = self.cfg.bandwidth_pkts_per_tick or 1 << 30
        while self._heap and self._heap[0][0] <= now and budget > 0:
            _, _, p = heapq.heappop(self._heap)
            out.append(p)
            budget -= 1
        return out

    @property
    def in_flight(self) -> int:
        return len(self._heap)


class Network:
    """A set of nodes connected pairwise by two directed links."""

    def __init__(self, n_nodes: int, cfg: LinkConfig = LinkConfig()):
        self.links: Dict[Tuple[int, int], Link] = {}
        for a in range(n_nodes):
            for b in range(n_nodes):
                if a != b:
                    c = dataclasses.replace(
                        cfg, seed=cfg.seed * 1000 + a * 37 + b,
                        chaos_seed=None if cfg.chaos_seed is None else
                        _chaos.link_stream(cfg.chaos_seed, a, b))
                    self.links[(a, b)] = Link(c)
        self.now = 0
        self.recorder = None

    def send(self, src: int, dst: int, p: pk.Packet):
        self.links[(src, dst)].send(p, self.now)

    def tick(self) -> Dict[Tuple[int, int], List[pk.Packet]]:
        self.now += 1
        return {k: l.deliver(self.now) for k, l in self.links.items()
                if l.in_flight}

    def quiescent(self) -> bool:
        return all(l.in_flight == 0 for l in self.links.values())

    # ---- telemetry ----------------------------------------------------
    def attach_recorder(self, rec):
        """Record per-link inject / wire_drop lifecycle events into a
        ``telemetry.FlightRecorder`` (track per directed link)."""
        self.recorder = rec

        def hook(track):
            def on_event(kind, p):
                rec.record(self.now, kind, track, qpn=p.qpn, psn=p.psn)
            return on_event

        for (a, b), link in self.links.items():
            link.on_event = hook(("link", f"{a}->{b}"))

    def snapshot(self) -> dict:
        """Common telemetry shape (see ``telemetry.MetricRegistry``)."""
        return {"now": self.now,
                "injected": sum(l.sent for l in self.links.values()),
                "wire_dropped": sum(l.dropped for l in self.links.values()),
                "in_flight": sum(l.in_flight for l in self.links.values())}


# ---------------------------------------------------------------------------
# Switched fabric (+ the in-fabric reduction offload)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ReduceSlot:
    """One in-flight reduction: (coll_tag, coll_frag) -> contributions."""
    nsrc: int
    dst: int
    contribs: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    carrier: Optional[pk.Packet] = None     # held until the slot completes
    done_payload: Optional[np.ndarray] = None


class SwitchReducer:
    """Switch-resident reduction engine (the in-fabric half of the
    collective offload; control-plane handle: ``collectives.
    AllreduceService``).

    The paper's thesis is line-rate compute on data *as it arrives from
    the network*; this is that idea moved one hop upstream, onto the
    switch the fabric models (SHARP / SwitchML lineage, expressed in
    BALBOA vocabulary).  Architecturally it is a parallel-path service
    tap placed at the congestion point: CHUNK-tagged packets (``Packet.
    coll_*``) are diverted off the forwarding path as they leave the
    ingress wire, their payloads accumulate in per-(tag, fragment)
    slots, and once all ``coll_nsrc`` contributors delivered a fragment
    ONE summed packet enters the egress queue — the N:1 incast of a
    direct reduction never touches the drop-tail buffer.

    Transport invariants are preserved, not bypassed:

      * the switch plays a full go-back-N *responder* per contributor
        stream (fragment-granular: in-sequence contributions are
        absorbed and ACKed, gaps are NAKed, late retransmissions are
        re-ACKed) — per-packet ACKs alone would be wrong, because the
        sender's release is cumulative and an ACK for fragment k+1
        would silently free a lost fragment k that nobody could ever
        resend;
      * the **carrier** (fold position ``nsrc - 1``) is never absorbed:
        its packets are held and forwarded with payloads replaced by
        the fold result, so the destination sees one ordinary in-order
        WRITE stream — PSN checking, rkey protection, crediting and
        completion generation all run unchanged;
      * retransmissions dedup against the slot (re-ACKed, never
        double-summed); a carrier retransmission after completion is
        re-filled from the cached result, so losses *behind* the switch
        recover end-to-end exactly like any other loss.

    The fold runs in canonical contribution order (``coll_src`` IS the
    fold position) via ``reduce_fn`` — the jitted segmented-reduce
    kernel — which is what keeps ring and offloaded collectives
    bit-identical.
    """

    def __init__(self, reduce_fn):
        self.reduce_fn = reduce_fn          # (K, L) u8 -> (L,) u8, row order
        self._slots: Dict[Tuple[int, int], _ReduceSlot] = {}
        # per-tag forwarding cursor: completed fragments are released to
        # the egress queue IN ORDER, so a loss-induced completion gap
        # never shows the destination an out-of-order carrier PSN (the
        # resulting NAK storm would burn the carrier's retry budget on
        # resends the incomplete slot cannot serve yet)
        self._next_fwd: Dict[int, int] = {}
        # per-(tag, fold position) responder cursor: next fragment
        # expected in sequence from that contributor stream
        self._next_frag: Dict[Tuple[int, int], int] = {}
        # control plane: (src node, dst node) -> the contributor's local
        # QPN, installed by the collective group at setup so synthesized
        # ACKs address the right sender-side QP
        self._ack_qpn: Dict[Tuple[int, int], int] = {}
        # telemetry
        self.absorbed = 0            # contributions summed at the hop
        self.acks_synthesized = 0
        self.naks_synthesized = 0    # go-back-N NAKs for stream gaps
        self.reduced_forwarded = 0   # summed packets released to egress
        self.dup_dropped = 0
        self.refills = 0             # carrier retransmits after completion
        self.peak_slots = 0
        self.bytes_reduced = 0

    def register_qp(self, src_node: int, dst_node: int, src_qpn: int):
        self._ack_qpn[(src_node, dst_node)] = src_qpn

    def clear(self):
        """Drop completed-slot caches (safe once the fabric is
        quiescent — between collective operations)."""
        self._slots.clear()
        self._next_fwd.clear()
        self._next_frag.clear()

    @property
    def in_flight(self) -> int:
        """Held carrier packets (awaiting completion or in-order
        release) — in-flight work the fabric must not call quiescent."""
        return sum(s.carrier is not None for s in self._slots.values())

    def snapshot(self) -> dict:
        """Common telemetry shape (see ``telemetry.MetricRegistry``)."""
        return {"absorbed": self.absorbed,
                "acks_synthesized": self.acks_synthesized,
                "naks_synthesized": self.naks_synthesized,
                "reduced_forwarded": self.reduced_forwarded,
                "dup_dropped": self.dup_dropped,
                "refills": self.refills,
                "peak_slots": self.peak_slots,
                "bytes_reduced": self.bytes_reduced,
                "in_flight": self.in_flight}

    # ---- datapath ----------------------------------------------------
    def on_packet(self, dst: int, p: pk.Packet
                  ) -> List[Tuple[int, pk.Packet]]:
        """Process one CHUNK-tagged arrival.  Returns ``(port, packet)``
        pairs to enqueue (summed forwards toward ``dst``, synthesized
        ACKs/NAKs back toward contributors); the contribution itself
        never reaches an egress queue."""
        tag, frag, pos = p.coll_tag, p.coll_frag, p.coll_src
        is_carrier = pos == p.coll_nsrc - 1
        nxt = self._next_frag.get((tag, pos), 0)

        if frag > nxt:
            # sequence gap in this contributor stream (an earlier
            # fragment was lost on the wire): go-back-N, exactly like a
            # receiving endpoint — dropping + NAKing is what keeps the
            # sender's cumulative-ACK release sound
            self.naks_synthesized += 1
            return self._nak(p, dst, nxt)

        if frag < nxt:                         # retransmission from behind
            self.dup_dropped += 1
            if not is_carrier:
                # the earlier ACK was lost; re-ACK at boundaries only
                # (cumulative release covers the rest, as at an endpoint)
                return self._ack(p, dst) if p.ack_req else []
            slot = self._slots.get((tag, frag))
            if (slot is not None and slot.done_payload is not None
                    and frag < self._next_fwd.get(tag, 0)):
                # the summed forward was lost behind the switch: re-fill
                # from the cached fold and send it again
                self.refills += 1
                return [(dst, self._filled(p, slot.done_payload))]
            return []                          # held / queued: nothing to do

        # in sequence: absorb the contribution
        self._next_frag[(tag, pos)] = nxt + 1
        slot = self._slots.get((tag, frag))
        if slot is None:
            slot = self._slots[(tag, frag)] = _ReduceSlot(
                nsrc=p.coll_nsrc, dst=dst)
            self.peak_slots = max(self.peak_slots, len(self._slots))
        slot.contribs[pos] = np.asarray(p.payload, np.uint8).copy()
        out: List[Tuple[int, pk.Packet]] = []
        if is_carrier:
            slot.carrier = p                   # held, forwarded on completion
        else:
            self.absorbed += 1
            if p.ack_req:
                # ACK like an endpoint: only at sub-message boundaries,
                # releasing the whole window cumulatively — per-packet
                # ACKs would flood the contributors' egress ports and
                # throttle the very phase the offload accelerates
                out.extend(self._ack(p, dst))

        if len(slot.contribs) == slot.nsrc:    # fold, then release in order
            stack = np.stack([slot.contribs[i] for i in range(slot.nsrc)])
            slot.done_payload = np.asarray(self.reduce_fn(stack), np.uint8)
            self.bytes_reduced += int(stack.nbytes)
            slot.contribs = {}                 # keep only the fold result
            out.extend(self._flush(tag))
        return out

    def _flush(self, tag: int) -> List[Tuple[int, pk.Packet]]:
        """Release every completed fragment at the head of the tag's
        forwarding cursor (the carrier stream stays in PSN order)."""
        out: List[Tuple[int, pk.Packet]] = []
        nxt = self._next_fwd.get(tag, 0)
        while True:
            slot = self._slots.get((tag, nxt))
            if slot is None or slot.done_payload is None \
                    or slot.carrier is None:
                break
            self.reduced_forwarded += 1
            out.append((slot.dst, self._filled(slot.carrier,
                                               slot.done_payload)))
            slot.carrier = None
            nxt += 1
        self._next_fwd[tag] = nxt
        return out

    def _filled(self, carrier: pk.Packet, payload: np.ndarray) -> pk.Packet:
        p = carrier.clone()
        p.payload = payload.copy()
        return p

    def _src_qpn(self, p: pk.Packet, dst: int) -> int:
        try:
            return self._ack_qpn[(p.src_ip, dst)]
        except KeyError:
            raise RuntimeError(
                f"SwitchReducer: CHUNK from node {p.src_ip} to port {dst} "
                f"but no QP registered — install the collective group's "
                f"control plane before sending tagged traffic") from None

    def _ack(self, p: pk.Packet, dst: int) -> List[Tuple[int, pk.Packet]]:
        self.acks_synthesized += 1
        return [(p.src_ip, pk.make_ack(self._src_qpn(p, dst), p.psn))]

    def _nak(self, p: pk.Packet, dst: int, expected_frag: int
             ) -> List[Tuple[int, pk.Packet]]:
        # fragments map 1:1 onto consecutive PSNs within one tagged
        # stream, so the PSN of the first missing fragment is recoverable
        # from any later packet; NAK semantics resume resending there
        ack_psn = (p.psn - (p.coll_frag - expected_frag) - 1) & pk.PSN_MASK
        return [(p.src_ip,
                 pk.make_ack(self._src_qpn(p, dst), ack_psn, nak=True))]

def _per_port(value: Union[int, Sequence[int]], n_ports: int) -> List[int]:
    """Broadcast a scalar config to all ports, or validate a sequence."""
    if isinstance(value, (list, tuple)):
        if len(value) != n_ports:
            raise ValueError(f"per-port config of length {len(value)} "
                             f"for {n_ports} ports")
        return [int(v) for v in value]
    return [int(value)] * n_ports


@dataclasses.dataclass
class FabricConfig:
    """Single-switch star fabric.  ``port_bandwidth`` and ``port_delay``
    accept either a scalar (all ports alike) or a per-port sequence.

    ECN marking (RED-style, the DCQCN congestion-point role): a packet
    leaving an egress queue whose remaining depth exceeds ``ecn_kmin``
    is CE-marked with probability ramping linearly up to ``ecn_pmax``
    at ``ecn_kmax``; at or above ``ecn_kmax`` every departure is
    marked.  Marking happens at *dequeue*, so the mark reaches the
    receiver after only the wire delay — not after the packet's own
    queue sojourn.  ``ecn_kmax = 0`` (default) disables marking
    entirely — the fabric then only tail-drops, exactly the pre-ECN
    behaviour."""
    port_bandwidth: Union[int, Sequence[int]] = 4   # egress pkts per tick
    port_delay: Union[int, Sequence[int]] = 2       # ingress wire latency
    queue_capacity: int = 64                        # egress drop-tail depth
    loss_prob: float = 0.0                          # random wire loss
    ecn_kmin: int = 0                               # CE-mark ramp start
    ecn_kmax: int = 0                               # CE-mark saturation (0=off)
    ecn_pmax: float = 1.0                           # mark prob at kmax
    seed: int = 0
    # chaos mode: when set, wire-loss and RED draws come from the
    # counter-keyed hash in ``repro.core.chaos`` (loss ranked by send
    # order within the tick, RED by pop order across ports) — the same
    # stream ``core.fused`` replays in-graph.
    chaos_seed: Optional[int] = None


@dataclasses.dataclass
class PortStats:
    enqueued: int = 0
    delivered: int = 0
    tail_dropped: int = 0        # drop-tail at the egress queue
    wire_dropped: int = 0        # random loss on the ingress wire
    ecn_marked: int = 0          # CE marks applied at this egress queue
    max_depth: int = 0           # high-water mark of the egress queue

    def snapshot(self) -> dict:
        """Common telemetry shape (see ``telemetry.MetricRegistry``)."""
        return dataclasses.asdict(self)


def sum_port_stats(stats) -> dict:
    """Aggregate any iterable of ``PortStats`` field-wise (``max_depth``
    takes the max) — the one helper behind every fabric-level total."""
    out = {f.name: 0 for f in dataclasses.fields(PortStats)}
    for s in stats:
        for k in out:
            v = getattr(s, k)
            out[k] = max(out[k], v) if k == "max_depth" else out[k] + v
    return out


def _red_mark(rng: np.random.Generator, depth: int,
              kmin: int, kmax: int, pmax: float) -> bool:
    """RED-style CE-marking decision for a dequeue leaving ``depth``
    packets behind it (including itself).  Only draws randomness inside
    the [kmin, kmax) ramp, so configurations without ECN replay the
    exact same rng stream as before.  Shared by every egress stage of
    both switched topologies."""
    if kmax <= 0:
        return False
    if depth >= kmax:
        return True
    if depth <= kmin:
        return False
    prob = pmax * (depth - kmin) / max(kmax - kmin, 1)
    return bool(rng.random() < prob)


class _EgressQueue:
    """One drop-tail egress queue drained at a fixed bandwidth — the
    per-port machinery of ``SwitchedFabric``, factored out so the Clos
    fabric's leaf uplinks / spine downlinks / node ports are all the
    same stage.  Items are ``(packet, meta)`` pairs (``meta`` carries
    the final destination through multi-hop stages)."""

    def __init__(self, capacity: int, bandwidth: int, stats: PortStats):
        self.capacity = capacity
        self.bandwidth = bandwidth
        self.stats = stats
        self._q: Deque[Tuple[pk.Packet, object]] = collections.deque()
        # flight-recorder hook: (kind, packet, depth-after).  Installed
        # by the owning fabric's ``attach_recorder``; one ``is None``
        # test per queue operation when no recorder is attached.
        self.on_event = None

    def __len__(self) -> int:
        return len(self._q)

    def enqueue(self, p: pk.Packet, meta=None) -> bool:
        """Drop-tail admission."""
        if len(self._q) >= self.capacity:
            self.stats.tail_dropped += 1
            if self.on_event is not None:
                self.on_event("tail_drop", p, len(self._q))
            return False
        self._q.append((p, meta))
        self.stats.enqueued += 1
        self.stats.max_depth = max(self.stats.max_depth, len(self._q))
        if self.on_event is not None:
            self.on_event("enqueue", p, len(self._q))
        return True

    def drain(self, mark) -> List[Tuple[pk.Packet, object]]:
        """Pop up to ``bandwidth`` items; ``mark(depth)`` decides the CE
        bit per departure (marking at DEQUEUE: the mark reflects the
        depth the packet leaves behind and reaches the receiver after
        only the remaining wire delay — the tight feedback loop DCQCN's
        stability relies on)."""
        batch: List[Tuple[pk.Packet, object]] = []
        for _ in range(min(self.bandwidth, len(self._q))):
            if mark(len(self._q)):
                self._q[0][0].ecn = True
                self.stats.ecn_marked += 1
                if self.on_event is not None:
                    self.on_event("ecn", self._q[0][0], len(self._q))
            batch.append(self._q.popleft())
            if self.on_event is not None:
                self.on_event("dequeue", batch[-1][0], len(self._q))
        self.stats.delivered += len(batch)
        return batch

    def flush(self) -> int:
        """Discard everything queued (link/spine failure); returns the
        number of packets lost."""
        n = len(self._q)
        if self.on_event is not None:
            for i, (p, _meta) in enumerate(self._q):
                self.on_event("flush", p, n - 1 - i)
        self._q.clear()
        return n


def _queue_hook(fabric, rec, track):
    """Build an ``_EgressQueue.on_event`` closure recording lifecycle
    events on ``track`` at the owning fabric's current tick; enqueue /
    dequeue additionally emit a ``qdepth`` sample so Perfetto renders a
    queue-depth counter graph per port/uplink/downlink."""
    def on_event(kind, p, depth):
        rec.record(fabric.now, kind, track, qpn=p.qpn, psn=p.psn)
        if kind in ("enqueue", "dequeue"):
            rec.record(fabric.now, "qdepth", track, depth=depth)
    return on_event


class SwitchedFabric:
    """A single switch; node ``i`` hangs off port ``i``.

    Datapath per packet: ingress wire (``port_delay[src]`` ticks, seeded
    random loss) -> destination port's egress FIFO (drop-tail at
    ``queue_capacity``) -> drained at ``port_bandwidth[dst]`` packets
    per tick.  The egress queue is *shared by all flows* targeting that
    port — congestion (incast) shows up as drop-tail losses the RDMA
    layer must recover via retransmission, exactly like a
    shallow-buffered data-center switch.
    """

    def __init__(self, n_nodes: int, cfg: Optional[FabricConfig] = None):
        cfg = cfg if cfg is not None else FabricConfig()
        self.cfg = cfg
        self.n_nodes = n_nodes
        self.bandwidth = _per_port(cfg.port_bandwidth, n_nodes)
        self.delay = _per_port(cfg.port_delay, n_nodes)
        self.rng = np.random.default_rng(cfg.seed)
        self.now = 0
        self._seq = 0
        # packets on the ingress wire: (arrival_tick, seq, dst, packet)
        self._wire: List[Tuple[int, int, int, pk.Packet]] = []
        self.port_stats = [PortStats() for _ in range(n_nodes)]
        self.egress: List[_EgressQueue] = [
            _EgressQueue(cfg.queue_capacity, self.bandwidth[i],
                         self.port_stats[i]) for i in range(n_nodes)]
        self.reducer: Optional[SwitchReducer] = None
        self.recorder = None
        self.injected = 0        # send() calls (conservation anchor)
        self._ctick = -1         # chaos mode: per-tick send / pop ranks
        self._csend = 0
        self._cpop = 0

    def _chaos_rank(self, kind: str) -> int:
        """Next chaos rank within the current tick (``kind`` selects the
        send or pop counter; both reset together on a new tick)."""
        if self.now != self._ctick:
            self._ctick, self._csend, self._cpop = self.now, 0, 0
        if kind == "send":
            i, self._csend = self._csend, self._csend + 1
        else:
            i, self._cpop = self._cpop, self._cpop + 1
        return i

    def attach_reducer(self, reducer: SwitchReducer):
        """Install the in-fabric reduction offload (collective control
        plane).  CHUNK-tagged packets are then diverted to the reducer
        as they leave the ingress wire, before the egress queues.  One
        reducer per fabric: silently replacing an attached one would
        strand the first group's tagged traffic on the wrong control
        plane (wrong ACK QPs, wrong fold dtype)."""
        if self.reducer is not None and self.reducer is not reducer:
            raise RuntimeError(
                "SwitchedFabric already has a reducer attached; offload "
                "groups sharing a fabric must share one AllreduceService")
        self.reducer = reducer

    def send(self, src: int, dst: int, p: pk.Packet):
        self.injected += 1
        st = self.port_stats[dst]
        if self.cfg.loss_prob:
            if self.cfg.chaos_seed is not None:
                lost = _chaos.hash32(
                    self.cfg.chaos_seed, _chaos.TAG_LOSS, self.now,
                    self._chaos_rank("send")) < _chaos.u32_prob(
                        self.cfg.loss_prob)
            else:
                lost = self.rng.random() < self.cfg.loss_prob
            if lost:
                st.wire_dropped += 1
                if self.recorder is not None:
                    self.recorder.record(self.now, "wire_drop",
                                         ("node", src),
                                         qpn=p.qpn, psn=p.psn, dst=dst)
                return
        if self.recorder is not None:
            self.recorder.record(self.now, "inject", ("node", src),
                                 qpn=p.qpn, psn=p.psn, dst=dst)
        self._seq += 1
        heapq.heappush(self._wire,
                       (self.now + self.delay[src], self._seq, dst, p))

    def tick(self) -> Dict[Tuple[int, int], List[pk.Packet]]:
        """Advance one tick: move arrived packets into egress queues
        (drop-tail), then drain each port at its bandwidth.  Returns
        ``{(-1, dst): packets}`` — the switch is the source."""
        self.now += 1
        while self._wire and self._wire[0][0] <= self.now:
            _, _, dst, p = heapq.heappop(self._wire)
            if p.coll_tag and self.reducer is not None:
                # in-fabric reduction: the contribution is consumed at
                # the hop; only summed forwards / synthesized ACKs enter
                # the (drop-tail) egress queues
                for port, outp in self.reducer.on_packet(dst, p):
                    self._enqueue(port, outp)
                continue
            self._enqueue(dst, p)
        out: Dict[Tuple[int, int], List[pk.Packet]] = {}
        for dst in range(self.n_nodes):
            if not len(self.egress[dst]):
                continue
            batch = [p for p, _ in self.egress[dst].drain(self._ecn_mark)]
            out[(-1, dst)] = batch
        return out

    def _enqueue(self, dst: int, p: pk.Packet):
        """Drop-tail admission into a port's egress queue."""
        self.egress[dst].enqueue(p)

    def _ecn_mark(self, depth: int) -> bool:
        if self.cfg.chaos_seed is not None and self.cfg.ecn_kmax > 0:
            # every pop consumes one rank (whether or not the depth is
            # inside the ramp), so the fused core can rank pops by
            # (port asc, pop order) without replaying the ramp test
            return _chaos.red_mark(self.cfg.chaos_seed, self.now,
                                   self._chaos_rank("pop"), depth,
                                   self.cfg.ecn_kmin, self.cfg.ecn_kmax,
                                   self.cfg.ecn_pmax)
        return _red_mark(self.rng, depth, self.cfg.ecn_kmin,
                         self.cfg.ecn_kmax, self.cfg.ecn_pmax)

    def quiescent(self) -> bool:
        return (not self._wire and all(not len(q) for q in self.egress)
                and (self.reducer is None or self.reducer.in_flight == 0))

    # ---- telemetry ----------------------------------------------------
    def attach_recorder(self, rec):
        """Record packet lifecycle events (inject, per-port enqueue /
        dequeue with queue depth, ECN mark, drops) into a
        ``telemetry.FlightRecorder``; one track per port."""
        self.recorder = rec
        for i, q in enumerate(self.egress):
            q.on_event = _queue_hook(self, rec, ("port", i))

    def snapshot(self) -> dict:
        """Common telemetry shape (see ``telemetry.MetricRegistry``):
        conservation holds as ``injected == wire_dropped + tail_dropped
        + delivered + in_flight`` (absent a reducer, which consumes
        contributions and synthesizes new packets at the hop)."""
        snap = {"now": self.now, "injected": self.injected,
                "in_flight": (len(self._wire)
                              + sum(len(q) for q in self.egress)),
                **sum_port_stats(self.port_stats),
                "ports": {i: s.snapshot()
                          for i, s in enumerate(self.port_stats)}}
        if self.reducer is not None:
            snap["reducer"] = self.reducer.snapshot()
        return snap

    @property
    def total_tail_dropped(self) -> int:
        return sum_port_stats(self.port_stats)["tail_dropped"]

    @property
    def total_delivered(self) -> int:
        return sum_port_stats(self.port_stats)["delivered"]

    @property
    def total_ecn_marked(self) -> int:
        return sum_port_stats(self.port_stats)["ecn_marked"]


def dcqcn_fabric_profile() -> FabricConfig:
    """The calibrated ECN-marking fabric for DCQCN experiments (swept in
    benchmarks/fig6_multiqp.py): mark lightly from Kmin=8, saturate at
    Kmax=24, keep half the drop-tail headroom above Kmax to absorb AI
    overshoot between CNPs.  The single source of truth — the incast
    default, the CC bench and the acceptance tests all measure this
    exact profile."""
    return FabricConfig(port_bandwidth=4, port_delay=2, queue_capacity=48,
                        ecn_kmin=8, ecn_kmax=24, ecn_pmax=0.05, seed=7)


# ---------------------------------------------------------------------------
# Leaf-spine (Clos) multipath fabric
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClosConfig:
    """Two-tier leaf-spine fabric.  ``port_bandwidth`` / ``port_delay``
    accept a scalar or a per-node sequence; ``spine_delay`` a scalar or
    per-spine sequence (asymmetric spine delays are what make per-packet
    spraying genuinely reorder).  ECN marking (same RED ramp as
    ``FabricConfig``) applies at every egress stage — node ports, leaf
    uplinks and spine downlinks — so a congested spine plane CE-marks
    the packets that crossed it, and the receiver's CNPs can carry the
    path back to a per-path DCQCN reaction point.

    ``path_mode`` is the *fabric-side* route choice for packets the
    sender did not stamp (``Packet.path_id < 0``) or whose stamped
    spine has failed: ``"ecmp"`` hashes (src, dst, qpn) so one flow
    stays on one spine; ``"spray"`` round-robins per source across the
    live spines.  Sender-stamped live paths are always honored."""
    nodes_per_leaf: int = 1
    n_spines: int = 2
    port_bandwidth: Union[int, Sequence[int]] = 4   # node egress pkts/tick
    port_delay: Union[int, Sequence[int]] = 2       # node ingress wire
    queue_capacity: int = 64                        # node-port egress depth
    uplink_bandwidth: int = 4                       # leaf->spine drain rate
    uplink_capacity: int = 64
    downlink_bandwidth: int = 4                     # spine->leaf drain rate
    downlink_capacity: int = 64
    spine_delay: Union[int, Sequence[int]] = 2      # per-spine wire latency
    loss_prob: float = 0.0                          # random ingress-wire loss
    ecn_kmin: int = 0
    ecn_kmax: int = 0                               # 0 = marking off
    ecn_pmax: float = 1.0
    path_mode: str = "ecmp"                         # | "spray"
    seed: int = 0


class ClosFabric:
    """A two-tier Clos: node ``i`` hangs off leaf ``i // nodes_per_leaf``;
    every leaf connects to every spine.  Same surface as
    ``SwitchedFabric`` (``send`` / ``tick`` / ``quiescent`` / ``now``).

    Datapath per cross-leaf packet:
        ingress wire (``port_delay[src]``, seeded random loss)
        -> leaf uplink queue toward the chosen spine (drop-tail + RED)
        -> spine wire (``spine_delay[s]``)
        -> spine downlink queue toward the destination leaf
        -> spine wire (``spine_delay[s]``) back down
        -> destination node's port queue -> drained at port bandwidth.
    Same-leaf packets skip the spine stages entirely (one wire + the
    port queue — exactly the single-switch datapath).

    Spraying across spines with asymmetric ``spine_delay`` makes
    packets of one flow overtake each other — the reorder regime
    go-back-N collapses under and selective-repeat RX absorbs.
    ``fail_spine`` kills a plane mid-run: everything queued on or
    flying toward it is lost (counted in ``failure_dropped``) and
    future picks re-route to the surviving spines.
    """

    # wire-event stage codes (heap entries stay tuple-comparable)
    _UP, _DOWN, _PORT = 0, 1, 2

    def __init__(self, n_nodes: int, cfg: Optional[ClosConfig] = None):
        cfg = cfg if cfg is not None else ClosConfig()
        if cfg.path_mode not in ("ecmp", "spray"):
            raise ValueError(f"unknown path_mode {cfg.path_mode!r}; "
                             f"choose from ('ecmp', 'spray')")
        if cfg.n_spines < 1:
            raise ValueError("ClosFabric needs at least one spine")
        self.cfg = cfg
        self.n_nodes = n_nodes
        self.nodes_per_leaf = max(1, cfg.nodes_per_leaf)
        self.n_leaves = -(-n_nodes // self.nodes_per_leaf)
        self.n_spines = cfg.n_spines
        self.bandwidth = _per_port(cfg.port_bandwidth, n_nodes)
        self.delay = _per_port(cfg.port_delay, n_nodes)
        self.spine_delay = _per_port(cfg.spine_delay, cfg.n_spines)
        self.rng = np.random.default_rng(cfg.seed)
        self.now = 0
        self._seq = 0
        # wire events: (arrival, seq, stage, leaf, spine, dst, packet)
        self._wire: List[Tuple[int, int, int, int, int, int, pk.Packet]] = []
        self.port_stats = [PortStats() for _ in range(n_nodes)]
        self.down = [_EgressQueue(cfg.queue_capacity, self.bandwidth[i],
                                  self.port_stats[i])
                     for i in range(n_nodes)]
        self.uplink_stats = [[PortStats() for _ in range(self.n_spines)]
                             for _ in range(self.n_leaves)]
        self.up = [[_EgressQueue(cfg.uplink_capacity, cfg.uplink_bandwidth,
                                 self.uplink_stats[lf][s])
                    for s in range(self.n_spines)]
                   for lf in range(self.n_leaves)]
        self.spine_stats = [[PortStats() for _ in range(self.n_leaves)]
                            for _ in range(self.n_spines)]
        self.spdown = [[_EgressQueue(cfg.downlink_capacity,
                                     cfg.downlink_bandwidth,
                                     self.spine_stats[s][lf])
                        for lf in range(self.n_leaves)]
                       for s in range(self.n_spines)]
        self._alive: List[int] = list(range(self.n_spines))
        self.failed_spines: List[int] = []
        self._rr: Dict[int, int] = {}       # per-src spray cursor
        # telemetry
        self.spine_pkts = [0] * self.n_spines   # packets forwarded via spine
        self.failure_dropped = 0                # lost to fail_spine()
        self.rerouted = 0                       # stamped path dead, re-picked
        self.injected = 0                       # send() calls
        self.recorder = None

    # ---- topology helpers ---------------------------------------------
    def leaf_of(self, node: int) -> int:
        return node // self.nodes_per_leaf

    @property
    def n_paths(self) -> int:
        """Parallel spine planes — what a spraying sender spreads over."""
        return self.n_spines

    @property
    def alive_paths(self) -> Tuple[int, ...]:
        return tuple(self._alive)

    # ---- datapath ------------------------------------------------------
    def send(self, src: int, dst: int, p: pk.Packet):
        self.injected += 1
        st = self.port_stats[dst]
        if self.cfg.loss_prob and self.rng.random() < self.cfg.loss_prob:
            st.wire_dropped += 1
            if self.recorder is not None:
                self.recorder.record(self.now, "wire_drop", ("node", src),
                                     qpn=p.qpn, psn=p.psn, dst=dst)
            return
        if self.recorder is not None:
            self.recorder.record(self.now, "inject", ("node", src),
                                 qpn=p.qpn, psn=p.psn, dst=dst)
        self._seq += 1
        if self.leaf_of(src) == self.leaf_of(dst):
            p.path_id = -1                  # no spine crossed
            heapq.heappush(self._wire, (self.now + self.delay[src],
                                        self._seq, self._PORT, 0, 0, dst, p))
            return
        s = self._route(src, dst, p)
        p.path_id = s                       # record the path actually taken
        heapq.heappush(self._wire, (self.now + self.delay[src], self._seq,
                                    self._UP, self.leaf_of(src), s, dst, p))

    def _route(self, src: int, dst: int, p: pk.Packet) -> int:
        alive = self._alive
        if not alive:
            raise RuntimeError("ClosFabric: every spine has failed")
        pid = p.path_id
        if 0 <= pid < self.n_spines:
            if pid in alive:
                return pid                  # honor the sender's stamp
            self.rerouted += 1              # stamped plane is dead: re-pick
            if self.recorder is not None:
                self.recorder.record(self.now, "reroute", ("spine", pid),
                                     qpn=p.qpn, psn=p.psn)
        if self.cfg.path_mode == "spray":
            c = self._rr.get(src, 0)
            self._rr[src] = c + 1
            return alive[c % len(alive)]
        # ECMP: stable flow hash over the live spines
        h = (src * 0x9E3779B1 + dst * 0x85EBCA77
             + p.qpn * 0xC2B2AE3D) & 0xFFFFFFFF
        return alive[h % len(alive)]

    def tick(self) -> Dict[Tuple[int, int], List[pk.Packet]]:
        """Advance one tick: land wire arrivals in their stage queues,
        then drain every queue in deterministic (index) order.  Returns
        ``{(-1, dst): packets}`` exactly like ``SwitchedFabric``."""
        self.now += 1
        while self._wire and self._wire[0][0] <= self.now:
            _, _, stage, lf, s, dst, p = heapq.heappop(self._wire)
            if stage == self._UP:
                self.up[lf][s].enqueue(p, dst)
            elif stage == self._DOWN:
                self.spdown[s][lf].enqueue(p, dst)
            else:
                self.down[dst].enqueue(p)
        # leaf uplinks -> spine wires
        for lf in range(self.n_leaves):
            for s in range(self.n_spines):
                for p, dst in self.up[lf][s].drain(self._ecn_mark):
                    self.spine_pkts[s] += 1
                    self._seq += 1
                    heapq.heappush(
                        self._wire,
                        (self.now + self.spine_delay[s], self._seq,
                         self._DOWN, self.leaf_of(dst), s, dst, p))
        # spine downlinks -> destination-leaf wires
        for s in range(self.n_spines):
            for lf in range(self.n_leaves):
                for p, dst in self.spdown[s][lf].drain(self._ecn_mark):
                    self._seq += 1
                    heapq.heappush(
                        self._wire,
                        (self.now + self.spine_delay[s], self._seq,
                         self._PORT, 0, 0, dst, p))
        # node ports -> deliver
        out: Dict[Tuple[int, int], List[pk.Packet]] = {}
        for dst in range(self.n_nodes):
            if not len(self.down[dst]):
                continue
            out[(-1, dst)] = [p for p, _ in self.down[dst].drain(
                self._ecn_mark)]
        return out

    def _ecn_mark(self, depth: int) -> bool:
        return _red_mark(self.rng, depth, self.cfg.ecn_kmin,
                         self.cfg.ecn_kmax, self.cfg.ecn_pmax)

    # ---- failure injection --------------------------------------------
    def fail_spine(self, s: int) -> int:
        """Kill spine plane ``s``: every packet queued on it or flying
        toward/from it is lost; future picks route around it.  Returns
        the number of packets dropped (also accumulated in
        ``failure_dropped``) — the transport recovers them by
        retransmission like any other loss."""
        if s not in self._alive:
            return 0
        self._alive.remove(s)
        self.failed_spines.append(s)
        dropped = 0
        for lf in range(self.n_leaves):
            dropped += self.up[lf][s].flush()
            dropped += self.spdown[s][lf].flush()
        keep = [ev for ev in self._wire
                if not (ev[2] in (self._UP, self._DOWN) and ev[4] == s)]
        dropped += len(self._wire) - len(keep)
        heapq.heapify(keep)
        self._wire = keep
        self.failure_dropped += dropped
        if self.recorder is not None:
            self.recorder.record(self.now, "spine_fail", ("spine", s),
                                 dropped=dropped)
        return dropped

    def quiescent(self) -> bool:
        return (not self._wire
                and all(not len(q) for q in self.down)
                and all(not len(q) for row in self.up for q in row)
                and all(not len(q) for row in self.spdown for q in row))

    # ---- telemetry -----------------------------------------------------
    def attach_recorder(self, rec):
        """Record packet lifecycle events across every stage — node
        ports, leaf uplinks, spine downlinks — into a
        ``telemetry.FlightRecorder``: one track per port, per
        leaf->spine uplink and per spine->leaf downlink, so an incast
        or a spine failure is visually debuggable in Perfetto."""
        self.recorder = rec
        for i, q in enumerate(self.down):
            q.on_event = _queue_hook(self, rec, ("port", i))
        for lf in range(self.n_leaves):
            for s in range(self.n_spines):
                self.up[lf][s].on_event = _queue_hook(
                    self, rec, ("uplink", f"leaf{lf}->spine{s}"))
        for s in range(self.n_spines):
            for lf in range(self.n_leaves):
                self.spdown[s][lf].on_event = _queue_hook(
                    self, rec, ("spdown", f"spine{s}->leaf{lf}"))

    def snapshot(self) -> dict:
        """Common telemetry shape.  Conservation: ``injected ==
        ports/wire_dropped + tail_dropped(all stages) + failure_dropped
        + ports/delivered + in_flight``."""
        up_flat = [s for row in self.uplink_stats for s in row]
        sp_flat = [s for row in self.spine_stats for s in row]
        return {"now": self.now, "injected": self.injected,
                "failure_dropped": self.failure_dropped,
                "rerouted": self.rerouted,
                "alive_spines": len(self._alive),
                "spine_pkts": list(self.spine_pkts),
                "in_flight": (len(self._wire)
                              + sum(len(q) for q in self.down)
                              + sum(len(q) for row in self.up for q in row)
                              + sum(len(q) for row in self.spdown
                                    for q in row)),
                "ports": {**sum_port_stats(self.port_stats),
                          **{i: s.snapshot()
                             for i, s in enumerate(self.port_stats)}},
                "uplinks": sum_port_stats(up_flat),
                "spine_down": sum_port_stats(sp_flat)}

    @property
    def total_tail_dropped(self) -> int:
        return (sum_port_stats(self.port_stats)["tail_dropped"]
                + sum_port_stats(s for row in self.uplink_stats
                                 for s in row)["tail_dropped"]
                + sum_port_stats(s for row in self.spine_stats
                                 for s in row)["tail_dropped"])

    @property
    def total_delivered(self) -> int:
        return sum_port_stats(self.port_stats)["delivered"]

    @property
    def total_ecn_marked(self) -> int:
        return (sum_port_stats(self.port_stats)["ecn_marked"]
                + sum_port_stats(s for row in self.uplink_stats
                                 for s in row)["ecn_marked"]
                + sum_port_stats(s for row in self.spine_stats
                                 for s in row)["ecn_marked"])


@dataclasses.dataclass
class IncastResult:
    receiver: object                  # RdmaNode (port 0, the hot port)
    senders: List[object]             # RdmaNode per sender
    fabric: SwitchedFabric
    ticks: int                        # simulated ticks until quiescent
    payloads: List[np.ndarray]        # what sender i wrote (QPN i+1 at rx)


def incast_scenario(n_senders: int, *, message_bytes: int = 65536,
                    fabric_cfg: Optional[FabricConfig] = None,
                    rx_credits: int = 64, fc_window: int = 16,
                    max_ticks: int = 300_000,
                    engine: str = "batched",
                    congestion_control: str = "ack_clocked",
                    recorder=None,
                    epoch_mode: Optional[str] = None,
                    device=None) -> IncastResult:
    """The canonical congestion scenario: ``n_senders`` nodes RDMA-WRITE
    simultaneously into one receiver through a shallow-buffered switch
    port.  Runs until the fabric drains — callers assert delivery and
    inspect drop/retransmit stats.

    ``congestion_control="dcqcn"`` arms the full ECN loop: the default
    fabric config then CE-marks above Kmin (unless an explicit
    ``fabric_cfg`` overrides it) and every sender runs the DCQCN
    reaction point, so drop-tail losses give way to rate convergence.

    ``device`` places every node's RX engine tables (default ``"cuda"``;
    pass ``"cpu"`` explicitly to run without a card).
    """
    from repro_torch.core.flow_control import DcqcnConfig     # cycle-free import
    from repro_torch.core.rdma import RdmaNode, run_network

    if fabric_cfg is not None:
        cfg = fabric_cfg
    elif congestion_control == "dcqcn":
        cfg = dcqcn_fabric_profile()
    else:
        cfg = FabricConfig(port_bandwidth=4, port_delay=2,
                           queue_capacity=32, seed=7)
    fabric = SwitchedFabric(n_senders + 1, cfg)
    # the reaction point's line rate is the hot port's drain rate; flows
    # start at a quarter of it — the fabric models no PFC, so a blind
    # first-RTT burst at line rate would only be drop-tail carnage
    line = float(_per_port(cfg.port_bandwidth, n_senders + 1)[0])
    dcqcn = DcqcnConfig(line_rate=line, initial_rate=line / 4)
    recv = RdmaNode(0, fabric, rx_credits=rx_credits, engine=engine,
                    device=device)
    senders = [RdmaNode(i + 1, fabric, fc_window=fc_window, engine=engine,
                        congestion_control=congestion_control, dcqcn=dcqcn,
                        device=device)
               for i in range(n_senders)]
    if recorder is not None:
        fabric.attach_recorder(recorder)
        for n in [recv] + senders:
            n.attach_recorder(recorder)
    rng = np.random.default_rng(13)
    work = []
    for s in senders:
        qpn, _, _ = s.init_rdma(message_bytes, recv)
        data = rng.integers(0, 256, message_bytes, dtype=np.uint8)
        work.append((s, qpn, data))
    for s, qpn, data in work:
        s.rdma_write(qpn, data)
    ticks = run_network([recv] + senders, max_ticks=max_ticks,
                        epoch_mode=epoch_mode)
    return IncastResult(receiver=recv, senders=senders, fabric=fabric,
                        ticks=ticks, payloads=[d for _, _, d in work])


def clos_incast_scenario(n_senders: int, *, message_bytes: int = 65536,
                         clos_cfg: Optional[ClosConfig] = None,
                         rx_mode: str = "selective_repeat",
                         path_select: Optional[str] = "spray",
                         rx_credits: int = 64, fc_window: int = 16,
                         max_ticks: int = 300_000,
                         engine: str = "batched",
                         congestion_control: str = "ack_clocked",
                         fail_spine_at: Optional[int] = None,
                         fail_spine: int = 0,
                         recorder=None, device=None) -> IncastResult:
    """The multipath congestion scenario: ``n_senders`` nodes (one per
    leaf) RDMA-WRITE simultaneously into node 0 across a leaf-spine
    fabric with asymmetric spine delays.  With ``path_select="spray"``
    every flow's packets arrive genuinely out of order — the regime the
    ``rx_mode`` argument exists to compare (``"go_back_n"`` NAKs and
    re-sends whole windows; ``"selective_repeat"`` absorbs the reorder
    and re-sends only real gaps).  ``fail_spine_at`` kills spine
    ``fail_spine`` at that tick mid-transfer; the transport must
    recover over the survivors.  ``device`` as for ``incast_scenario``."""
    from repro_torch.core.flow_control import DcqcnConfig     # cycle-free import
    from repro_torch.core.rdma import RdmaNode, network_pending, step_network

    cfg = clos_cfg if clos_cfg is not None else ClosConfig(
        nodes_per_leaf=1, n_spines=2, port_bandwidth=4, port_delay=1,
        queue_capacity=48, spine_delay=(1, 5), seed=7,
        path_mode=path_select or "ecmp")
    fabric = ClosFabric(n_senders + 1, cfg)
    line = float(_per_port(cfg.port_bandwidth, n_senders + 1)[0])
    dcqcn = DcqcnConfig(line_rate=line, initial_rate=line / 4)
    kw = dict(rx_mode=rx_mode, path_select=path_select, engine=engine,
              device=device)
    recv = RdmaNode(0, fabric, rx_credits=rx_credits,
                    fc_window=fc_window, **kw)
    senders = [RdmaNode(i + 1, fabric, fc_window=fc_window,
                        congestion_control=congestion_control,
                        dcqcn=dcqcn, **kw)
               for i in range(n_senders)]
    if recorder is not None:
        fabric.attach_recorder(recorder)
        for n in [recv] + senders:
            n.attach_recorder(recorder)
    rng = np.random.default_rng(13)
    work = []
    for s in senders:
        qpn, _, _ = s.init_rdma(message_bytes, recv)
        data = rng.integers(0, 256, message_bytes, dtype=np.uint8)
        work.append((s, qpn, data))
    for s, qpn, data in work:
        s.rdma_write(qpn, data)
    nodes = [recv] + senders
    ticks, idle = max_ticks, 0
    for t in range(max_ticks):
        if fail_spine_at is not None and t == fail_spine_at:
            fabric.fail_spine(fail_spine)
        step_network(nodes)
        if network_pending(nodes):
            idle = 0
        else:
            idle += 1
            if idle >= 8:
                ticks = t
                break
    return IncastResult(receiver=recv, senders=senders, fabric=fabric,
                        ticks=ticks, payloads=[d for _, _, d in work])
