"""ACK-clocked flow control (paper §4.4), RX crediting (§4.3), and the
DCQCN reaction point (the congestion-control plane the paper's "open
design space" pitch points at).

Flow control sits on the *control path*: an outgoing request either
passes to the packet pipeline or is queued, bounded by a per-QP budget of
outstanding packets.  The budget is decreased by passing requests and
increased by incoming ACKs — "ACK-clocked", compatible with commodity
NICs, and the hook point for DCQCN/TIMELY-style congestion control.
That hook is now filled: with ``congestion_control="dcqcn"`` a
``DcqcnRateController`` paces the pending-queue drain through a per-QP
token bucket whose fill rate follows the DCQCN RP state machine —
multiplicative decrease on CNP arrival, timer-driven fast recovery /
additive increase between CNPs (Zhu et al., SIGCOMM'15).  The ACK clock
still bounds *inflight* packets; the rate controller bounds *departure
rate*, which is what keeps shallow switch queues below their ECN
thresholds instead of oscillating off drop-tail losses.

Crediting guards the *receive* side: the host-facing datapath advertises
consumption capacity; packets arriving with no credit available are
dropped (never stalling the pipeline) and recovered by the remote peer's
retransmission.

Invariants (property-tested in tests/test_transport.py):
  * outstanding(qp) <= window(qp) at every point in time
  * a request is never dropped by flow control, only delayed
  * credits never go negative; total accepted <= total credits granted

FPGA -> TPU design dual: on the FPGA these ledgers are small counters
next to the pipeline, updated at line rate; here they are host-side
control-plane state (python, per-QP lists) because they gate *when*
work enters the jitted data plane rather than sitting on it — the
credit check itself is replicated inside the jitted RX engines
(``pipeline._rx_decide``), which consume a credit column and return it
via the host ledger when the DMA completes.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class DcqcnConfig:
    """DCQCN reaction-point parameters, in simulator units (packets per
    tick / ticks).  Defaults are scaled for the switched-fabric testbed
    (port bandwidth ~4 pkts/tick, RTT ~6-10 ticks)."""
    line_rate: float = 4.0           # max rate per QP (pkts/tick)
    min_rate: float = 0.05           # rate floor (pkts/tick)
    g: float = 1.0 / 16.0            # EWMA gain of the alpha estimator
    rate_ai: float = 0.2             # additive increase per timer event
    alpha_timer: int = 32            # ticks w/o CNP before alpha decays
    rate_timer: int = 16             # ticks between rate-increase events
    fast_recovery: int = 3           # half-the-gap stages before AI
    # Starting rate of a fresh QP.  Spec DCQCN starts at line rate and
    # relies on PFC to make the first-RTT incast burst lossless; this
    # fabric models no PFC, so flows may start below line rate and let
    # fast recovery / AI climb instead of blasting into a shallow queue
    # blind.  ``None`` = line_rate (spec-faithful).
    initial_rate: Optional[float] = None


@dataclasses.dataclass
class FlowControlConfig:
    window: int = 64                 # max outstanding packets per QP
    congestion_control: str = "ack_clocked"   # | "static" | "dcqcn"
    dcqcn: DcqcnConfig = dataclasses.field(default_factory=DcqcnConfig)


class DcqcnRateController:
    """Per-QP DCQCN RP state machine + token-bucket pacer.

    State per QP (lazily activated on first request so idle QPs cost
    nothing on the tick path): current rate Rc, target rate Rt, the
    congestion estimate alpha, the increase-stage counter, and the token
    bucket the flow-control drain spends from.

    Rate dynamics (Zhu et al., SIGCOMM'15, timer-driven variant):
      * CNP arrival:  Rt <- Rc;  Rc <- max(Rmin, Rc * (1 - alpha/2));
                      alpha <- (1-g)*alpha + g;  stage <- 0
      * every ``rate_timer`` ticks without a cut:
          stage < fast_recovery:  Rc <- (Rc + Rt) / 2       (fast recovery)
          else:                   Rt <- min(line, Rt + Rai);
                                  Rc <- (Rc + Rt) / 2       (additive inc.)
      * every ``alpha_timer`` ticks without a CNP:
          alpha <- (1-g) * alpha

    Invariants (property-tested in tests/test_congestion.py):
      min_rate <= rate(qp) <= line_rate at every point in time.
    """

    def __init__(self, n_qps: int, cfg: DcqcnConfig = DcqcnConfig(), *,
                 burst: float = 8.0):
        self.cfg = cfg
        self.n_qps = n_qps
        self.burst = max(burst, 1.0)
        r0 = cfg.line_rate if cfg.initial_rate is None else \
            min(cfg.line_rate, max(cfg.min_rate, cfg.initial_rate))
        self.rate = [r0] * n_qps
        self.target = [r0] * n_qps
        self.alpha = [1.0] * n_qps
        self.stage = [0] * n_qps
        # buckets start near-empty: send-time bursts are budgeted by the
        # ACK window, not by a pre-filled bucket, so pacing engages from
        # the very first request instead of after one bucket's worth
        self.tokens = [1.0] * n_qps
        self._last_cut = [0] * n_qps         # last CNP / alpha-update tick
        self._last_inc = [0] * n_qps         # last rate-increase tick
        self._last_tick_now = -1
        self._active: set = set()
        # multipath (per-spine) extension: populated by enable_multipath
        self.n_paths = 1
        self.path_rate: Optional[List[List[float]]] = None   # [qpn][path]
        self.path_target: Optional[List[List[float]]] = None
        self.path_alpha: Optional[List[List[float]]] = None
        self.path_stage: Optional[List[List[int]]] = None
        self.path_tokens: Optional[List[List[float]]] = None
        self._path_last_cut: Optional[List[List[int]]] = None
        self._path_last_inc: Optional[List[List[int]]] = None
        # telemetry
        self.cnps_handled = 0
        self.rate_cuts = 0
        self.rate_increases = 0
        self.path_rate_cuts = 0

    def enable_multipath(self, n_paths: int):
        """Split each QP's reaction point into ``n_paths`` independent
        DCQCN instances — one per spine plane of a Clos fabric.  A CNP
        carrying a ``path_id`` then cuts only that plane's rate; the
        QP's aggregate rate (what the flow-control drain paces against)
        is the sum of its per-path rates.  The per-path line rate /
        floor / AI step are the QP-level parameters divided evenly, so
        the aggregate dynamics stay inside the single-path envelope."""
        if n_paths <= 1:
            return
        self.n_paths = n_paths
        r0 = [[r / n_paths] * n_paths for r in self.rate]
        self.path_rate = [row[:] for row in r0]
        self.path_target = [row[:] for row in r0]
        self.path_alpha = [[1.0] * n_paths for _ in range(self.n_qps)]
        self.path_stage = [[0] * n_paths for _ in range(self.n_qps)]
        self.path_tokens = [[0.0] * n_paths for _ in range(self.n_qps)]
        self._path_last_cut = [[0] * n_paths for _ in range(self.n_qps)]
        self._path_last_inc = [[0] * n_paths for _ in range(self.n_qps)]

    @property
    def multipath(self) -> bool:
        return self.path_rate is not None

    def activate(self, qpn: int, now: int = 0):
        if qpn not in self._active:
            self._active.add(qpn)
            self._last_cut[qpn] = now
            self._last_inc[qpn] = now
            if self.multipath:
                self._path_last_cut[qpn] = [now] * self.n_paths
                self._path_last_inc[qpn] = [now] * self.n_paths

    def on_cnp(self, qpn: int, now: int, path: int = -1):
        """Multiplicative decrease at the reaction point.  Called from
        the CNP control path — never from the ACK path, so a CNP cannot
        release ACK-clocked budget (CNPs don't ACK data).

        With multipath enabled and a valid ``path`` (the spine the
        CE-marked packet crossed, echoed in the CNP), only that path's
        rate is cut; the others keep sending — the congestion is *on
        that plane*, not on the flow."""
        self.activate(qpn, now)
        c = self.cfg
        if self.multipath and 0 <= path < self.n_paths:
            pr, pt = self.path_rate[qpn], self.path_target[qpn]
            pa = self.path_alpha[qpn]
            floor = c.min_rate / self.n_paths
            pt[path] = pr[path]
            pr[path] = max(floor, pr[path] * (1.0 - pa[path] / 2.0))
            pa[path] = min(1.0, (1.0 - c.g) * pa[path] + c.g)
            self.path_stage[qpn][path] = 0
            self._path_last_cut[qpn][path] = now
            self._path_last_inc[qpn][path] = now
            self.rate[qpn] = max(c.min_rate, sum(pr))
            self.cnps_handled += 1
            self.rate_cuts += 1
            self.path_rate_cuts += 1
            return
        self.target[qpn] = self.rate[qpn]
        self.rate[qpn] = max(c.min_rate,
                             self.rate[qpn] * (1.0 - self.alpha[qpn] / 2.0))
        self.alpha[qpn] = min(1.0, (1.0 - c.g) * self.alpha[qpn] + c.g)
        self.stage[qpn] = 0
        self._last_cut[qpn] = now
        self._last_inc[qpn] = now
        self.cnps_handled += 1
        self.rate_cuts += 1

    def tick(self, now: int):
        """Advance timers and accrue send tokens for active QPs.
        Idempotent per tick, so pacing consumers (staged retransmits,
        flow-control drain) may each poke it safely."""
        if now == self._last_tick_now:
            return
        self._last_tick_now = now
        c = self.cfg
        for qpn in sorted(self._active):
            if self.multipath:
                self._tick_multipath(qpn, now)
                continue
            if now - self._last_cut[qpn] >= c.alpha_timer:
                self.alpha[qpn] = (1.0 - c.g) * self.alpha[qpn]
                self._last_cut[qpn] = now
            if now - self._last_inc[qpn] >= c.rate_timer:
                self._last_inc[qpn] = now
                if self.stage[qpn] >= c.fast_recovery:
                    self.target[qpn] = min(c.line_rate,
                                           self.target[qpn] + c.rate_ai)
                self.rate[qpn] = min(c.line_rate,
                                     (self.rate[qpn] + self.target[qpn]) / 2)
                self.stage[qpn] += 1
                self.rate_increases += 1
            self.tokens[qpn] = min(self.burst,
                                   self.tokens[qpn] + self.rate[qpn])

    def _tick_multipath(self, qpn: int, now: int):
        """Per-path timers (same RP state machine, per-path constants =
        QP constants / n_paths), then aggregate: the QP-level rate and
        token bucket the drain consults are the sums over paths."""
        c = self.cfg
        n = self.n_paths
        line, ai = c.line_rate / n, c.rate_ai / n
        pburst = self.burst / n
        pr, pt = self.path_rate[qpn], self.path_target[qpn]
        pa, ps = self.path_alpha[qpn], self.path_stage[qpn]
        ptok = self.path_tokens[qpn]
        for path in range(n):
            if now - self._path_last_cut[qpn][path] >= c.alpha_timer:
                pa[path] = (1.0 - c.g) * pa[path]
                self._path_last_cut[qpn][path] = now
            if now - self._path_last_inc[qpn][path] >= c.rate_timer:
                self._path_last_inc[qpn][path] = now
                if ps[path] >= c.fast_recovery:
                    pt[path] = min(line, pt[path] + ai)
                pr[path] = min(line, (pr[path] + pt[path]) / 2)
                ps[path] += 1
                self.rate_increases += 1
            ptok[path] = min(pburst, ptok[path] + pr[path])
        self.rate[qpn] = max(c.min_rate, sum(pr))
        self.tokens[qpn] = min(self.burst, sum(ptok))

    def pick_path(self, qpn: int, paths: Tuple[int, ...]) -> int:
        """Congestion-aware spray: send the next packet down the live
        path with the most accumulated per-path tokens (ties -> lowest
        index), charging it one packet.  A path whose rate DCQCN cut
        accrues tokens slower, so the spray naturally shifts load off
        the congested spine.  Deficits are allowed (the QP-level bucket
        has already admitted the burst)."""
        if not self.multipath:
            return paths[0]
        ptok = self.path_tokens[qpn]
        best = max(paths, key=lambda p: (ptok[p], -p))
        ptok[best] -= 1.0
        return best

    def take(self, qpn: int, n_pkts: int) -> bool:
        """Spend ``n_pkts`` tokens if available (the pacing gate)."""
        if self.tokens[qpn] >= n_pkts:
            self.tokens[qpn] -= n_pkts
            return True
        return False

    def snapshot(self) -> dict:
        """Common telemetry shape (see ``telemetry.MetricRegistry``)."""
        return {"cnps_handled": self.cnps_handled,
                "rate_cuts": self.rate_cuts,
                "rate_increases": self.rate_increases,
                "path_rate_cuts": self.path_rate_cuts,
                "active_qps": len(self._active),
                "n_paths": self.n_paths}


class AckClockedFlowControl:
    """Per-QP outstanding-packet ledger with a pending queue.  With
    ``congestion_control="dcqcn"`` the drain is additionally gated by the
    rate controller's token bucket (rate-paced instead of burst-at-
    window)."""

    def __init__(self, n_qps: int, cfg: FlowControlConfig = FlowControlConfig()):
        self.cfg = cfg
        self.budget = [cfg.window] * n_qps
        self.pending: List[Deque] = [collections.deque() for _ in range(n_qps)]
        self.outstanding = [0] * n_qps
        self.rate: Optional[DcqcnRateController] = None
        if cfg.congestion_control == "dcqcn":
            # the bucket must admit the largest request the window can
            # pass, or pacing would deadlock the head of the queue
            self.rate = DcqcnRateController(n_qps, cfg.dcqcn,
                                            burst=float(cfg.window))
        # telemetry
        self.total_passed = 0
        self.total_queued = 0

    def request(self, qpn: int, n_pkts: int, payload=None) -> List:
        """Submit a request of ``n_pkts`` packets.  Returns the list of
        requests (the given one and/or previously queued ones) that pass
        to the packet pipeline now."""
        if self.rate is not None:
            self.rate.activate(qpn)
        self.pending[qpn].append((n_pkts, payload))
        self.total_queued += 1
        return self._drain(qpn)

    def ack(self, qpn: int, n_pkts: int = 1) -> List:
        """An ACK returns budget; queued requests may now pass."""
        self.outstanding[qpn] = max(0, self.outstanding[qpn] - n_pkts)
        self.budget[qpn] = min(self.cfg.window,
                               self.budget[qpn] + n_pkts)
        return self._drain(qpn)

    def on_cnp(self, qpn: int, now: int, path: int = -1):
        """Congestion notification: cut the QP's rate.  Deliberately does
        NOT touch budget/outstanding — a CNP never ACKs data.  ``path``
        (if >= 0 and multipath is enabled) attributes the cut to one
        spine plane only."""
        if self.rate is not None:
            self.rate.on_cnp(qpn, now, path=path)

    def tick_rate(self, now: int):
        """Advance the rate controller (timers + token accrual) without
        draining.  Lets the node spend tokens on staged retransmissions
        before the pending queue competes for them."""
        if self.rate is not None:
            self.rate.tick(now)

    def tick(self, now: int) -> List[Tuple[int, Tuple]]:
        """Rate-paced drain: accrue tokens, then release whatever the
        refreshed buckets admit.  Returns ``(qpn, (n_pkts, payload))``
        pairs.  No-op (empty) under plain ACK clocking."""
        if self.rate is None:
            return []
        self.rate.tick(now)
        released = []
        for qpn in sorted(self.rate._active):
            if self.pending[qpn]:
                released.extend((qpn, item) for item in self._drain(qpn))
        return released

    def _drain(self, qpn: int) -> List:
        passed = []
        q = self.pending[qpn]
        while q and q[0][0] <= self.budget[qpn]:
            if self.rate is not None and not self.rate.take(qpn, q[0][0]):
                break                      # paced: wait for tokens
            n_pkts, payload = q.popleft()
            self.budget[qpn] -= n_pkts
            self.outstanding[qpn] += n_pkts
            self.total_passed += 1
            passed.append((n_pkts, payload))
        return passed

    def queue_depth(self, qpn: int) -> int:
        return len(self.pending[qpn])

    def snapshot(self) -> dict:
        """Common telemetry shape (see ``telemetry.MetricRegistry``)."""
        snap = {"total_passed": self.total_passed,
                "total_queued": self.total_queued,
                "outstanding": sum(self.outstanding),
                "pending": sum(len(q) for q in self.pending)}
        if self.rate is not None:
            snap["rate"] = self.rate.snapshot()
        return snap


@dataclasses.dataclass(frozen=True)
class CreditLedger:
    """Read-only per-QP view of the credit ledger — the backpressure
    signal a striped consumer (one stripe = one QP in
    ``repro.core.ingest``) reads to see where the receive side is
    gating the stream."""
    qpn: int
    credits: int             # currently available
    max_credits: int
    accepted: int            # payloads this QP's credits admitted
    dropped: int             # payloads dropped for want of a credit

    def snapshot(self) -> dict:
        """Common telemetry shape (see ``telemetry.MetricRegistry``)."""
        return dataclasses.asdict(self)


class CreditManager:
    """RX-side crediting: the host-facing datapath grants consumption
    capacity; a packet consuming a credit that is not there is dropped
    (paper §4.3 — rely on remote retransmission, never stall).

    Accounting is kept per QP (``ledger``) as well as in the aggregate
    counters, so stripe-per-QP consumers can attribute backpressure to
    individual stripes."""

    def __init__(self, n_qps: int, initial_credits: int = 64,
                 max_credits: int = 64):
        self.credits = [initial_credits] * n_qps
        self.max_credits = max_credits
        self.dropped_no_credit = 0
        self.accepted = 0
        self.granted = n_qps * initial_credits
        self.accepted_per_qp = [0] * n_qps
        self.dropped_per_qp = [0] * n_qps

    def note_accepted(self, qpn: int, n: int = 1):
        """Record ``n`` payloads admitted on ``qpn`` (called by the RX
        path when the in-graph credit gate accepted the packet)."""
        self.accepted += n
        self.accepted_per_qp[qpn] += n

    def note_dropped(self, qpn: int, n: int = 1):
        """Record ``n`` payloads dropped on ``qpn`` for want of credit."""
        self.dropped_no_credit += n
        self.dropped_per_qp[qpn] += n

    def ledger(self, qpn: int) -> CreditLedger:
        return CreditLedger(qpn=qpn, credits=self.credits[qpn],
                            max_credits=self.max_credits,
                            accepted=self.accepted_per_qp[qpn],
                            dropped=self.dropped_per_qp[qpn])

    def try_consume(self, qpn: int, n: int = 1) -> bool:
        if self.credits[qpn] >= n:
            self.credits[qpn] -= n
            self.note_accepted(qpn, n)
            return True
        self.note_dropped(qpn, n)
        return False

    def replenish(self, qpn: int, n: int = 1):
        """Called when the host-facing DMA engine consumes a payload."""
        add = min(n, self.max_credits - self.credits[qpn])
        self.credits[qpn] += add
        self.granted += add

    def snapshot(self) -> dict:
        """Common telemetry shape (see ``telemetry.MetricRegistry``)."""
        return {"accepted": self.accepted,
                "dropped_no_credit": self.dropped_no_credit,
                "granted": self.granted,
                "available": sum(self.credits),
                "max_credits": self.max_credits}
