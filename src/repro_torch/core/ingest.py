"""BALBOA ingest: disaggregated storage -> RDMA -> service chain ->
device buffers (paper §8's RDMA-to-GPU path, generalized into the
training framework's data plane), on PyTorch tensors.

Two data planes share one topology (a trainer node + N storage
replicas):

**Streaming plane** (``stream_shard`` / ``fetch_shard_streaming``, the
line-rate path).  Each shard is STRIPED across every replica over
concurrent QPs; the network is ticked incrementally (``step_network``)
and each QP's contiguous-byte completion watermark
(``RdmaNode.rx_progress``) is polled between ticks, so fragment tiles
are handed to the device transform (``tile_to_batch`` -> e.g. the
preprocessing kernel via ``make_dlrm_tile_decoder``) the moment their
bytes are acknowledged — process-as-it-arrives, not store-and-forward.
Tiles land in a ``DeviceLandingZone`` allocated once per shard on the
card; the host never decodes or copies payload bytes (the only host-side
touch is the registered-buffer -> device copy of each tile), which
tests/test_torch_ingest.py enforces by poisoning ``decode_fn``.  Fault
tolerance is per-stripe: a replica that stops answering (QP retry-budget
exhaustion or a stalled watermark) costs a re-fetch of ONLY its stripes
on a surviving replica's QP (``reestablish_qp``), while healthy stripes
keep streaming.

**Synchronous plane** (``fetch_shard``, the store-and-forward baseline).
One blocking READ of the whole shard from one replica, decoded on the
HOST via ``decode_fn`` (payload bytes are copied — counted in
``host_payload_bytes``), then copied to the device.  Kept as the
failover oracle and as the baseline the streaming plane is measured
against.

**Sharded landing** (``shardings``: a batch key -> ``NamedSharding``
on a ``DeviceMesh``, as in the reference).  The port runs one process a
device, so the reference's single controller becomes SPMD: every rank
runs the whole deterministic transport simulation itself (the host work
is replicated), and the device work is split.  A rank allocates only
its own block of each sharded key, decodes only the tiles whose rows
meet that block (the rest are skipped before their device copy and
counted in ``tiles_skipped``), lands only the overlap, and returns a
``DTensor`` of the global shape (PyTorch's sharded ``jax.Array``); the
synchronous plane hands each rank its block of the host batch the same
way.  A shape that the mesh does not divide raises, as the reference's
``device_put`` does.

``epoch_mode="fused"`` (or ``BALBOA_EPOCH_MODE=fused``) advances the
stream in watermark-bounded fused micro-epochs, as the reference does.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import packet as pk
from repro_torch.core.flow_control import CreditLedger
from repro_torch.core.netsim import LinkConfig, Network
from repro_torch.core.rdma import (RdmaNode, check_epoch_mode, run_network,
                                   step_network)
from repro_torch.core.services import ServiceChain
from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.kernels import ops
from repro_torch.parallel.sharding import NamedSharding


@dataclasses.dataclass
class IngestConfig:
    batch_bytes: int = 1 << 20
    straggler_timeout_ticks: int = 5000
    n_storage_nodes: int = 2          # replicas (striping + failover)
    loss_prob: float = 0.0
    latency_ticks: int = 4
    prefetch: int = 2                 # double buffering depth (legacy plane)
    # --- streaming data plane ---------------------------------------
    qps_per_node: int = 1             # concurrent QPs per storage replica
    tile_pkts: int = 4                # fragment-tile size handed to kernels
    link_bw_pkts_per_tick: int = 0    # per-link shaping (0 = unshaped)
    stall_ticks: Optional[int] = None  # per-stripe no-progress failover
                                       # window (None = straggler timeout)
    engine: str = "batched"           # RX engine of every node
    # --- topology / multipath ---------------------------------------
    topology: str = "p2p"             # | "clos" (leaf-spine multipath)
    clos_cfg: Optional[object] = None  # netsim.ClosConfig when "clos"
    rx_mode: str = "go_back_n"        # | "selective_repeat"
    path_select: Optional[str] = None  # | "ecmp" | "spray"
    fc_window: Optional[int] = None   # None = 64 (16 under SR: the
                                      # burst bound must fit the bitmap)
    # None = env BALBOA_EPOCH_MODE; "fused" = whole fused micro-epochs
    # between watermark polls (core.fused), "tick" = per-tick oracle
    epoch_mode: Optional[str] = None


@dataclasses.dataclass
class QpRef:
    """One trainer<->storage queue pair.  ``qpn_r`` comes from the
    connection table via ``RdmaNode.remote_qpn`` — never from inspecting
    the peer's buffer dict (which breaks as soon as a node holds more
    than one QP, exactly what striping requires)."""
    node: int                         # storage replica index
    qpn_l: int                        # trainer-side QPN
    qpn_r: int                        # storage-side QPN


@dataclasses.dataclass
class Stripe:
    """One contiguous packet range of a shard, served by one QP."""
    sid: int
    pkt_start: int                    # first packet index within the shard
    n_pkts: int
    nbytes: int
    node: int = -1                    # replica currently serving
    qp: int = -1                      # index into BalboaIngest.qps
    issued_tick: int = -1
    progress_tick: int = -1           # last tick the watermark advanced
    watermark: int = 0                # contiguous bytes landed
    resume: int = 0                   # byte offset the current READ
                                      # started from (tile-aligned; >0
                                      # after a mid-stripe failover)
    tiles_emitted: int = 0
    refetches: int = 0
    attempts: Tuple[int, ...] = ()    # replicas tried so far
    done: bool = False
    ledger: Optional[CreditLedger] = None   # RX credit view at completion


@dataclasses.dataclass
class StreamReport:
    """What one streamed shard fetch did, for benches and tests."""
    index: int
    nbytes: int
    ticks: int                        # total ticks the stream took
    transport_done_tick: int          # tick (relative) the last byte landed
    tiles: int
    tiles_overlapped: int             # tiles consumed while bytes in flight
    refetches: int
    stripes: List[Stripe]
    events: List[Tuple]               # ("issue"|"tile"|"done"|"refetch",
                                      #  tick, stripe, ...) in time order

    @property
    def goodput_bytes_per_tick(self) -> float:
        return self.nbytes / max(self.ticks, 1)

    @property
    def overlap_efficiency(self) -> float:
        """Fraction of tile work issued while transport was still in
        flight — 1.0 means preprocessing fully hidden behind the wire."""
        return self.tiles_overlapped / max(self.tiles, 1)

    @property
    def ledgers(self) -> Dict[int, CreditLedger]:
        """Per-stripe RX credit ledgers (stripe id -> ledger view)."""
        return {s.sid: s.ledger for s in self.stripes if s.ledger}

    def snapshot(self) -> dict:
        """Common telemetry shape (the reference's ``MetricRegistry``)."""
        return {"index": self.index, "nbytes": self.nbytes,
                "ticks": self.ticks,
                "transport_done_tick": self.transport_done_tick,
                "tiles": self.tiles,
                "tiles_overlapped": self.tiles_overlapped,
                "refetches": self.refetches,
                "goodput_bytes_per_tick": self.goodput_bytes_per_tick,
                "overlap_efficiency": self.overlap_efficiency,
                "stripes": {s.sid: s.ledger.snapshot()
                            for s in self.stripes if s.ledger}}


class DisaggregatedStorage:
    """A remote storage node: shards live in its registered buffers."""

    def __init__(self, node: RdmaNode, shard_fn: Callable[[int], np.ndarray]):
        self.node = node
        self.shard_fn = shard_fn      # shard index -> bytes
        self._cache: Tuple[Optional[int], Optional[np.ndarray]] = (None, None)

    def shard_bytes(self, index: int) -> np.ndarray:
        if self._cache[0] != index:
            self._cache = (index, np.asarray(self.shard_fn(index), np.uint8))
        return self._cache[1]

    def load_shard(self, buf: np.ndarray, index: int) -> int:
        data = self.shard_bytes(index)
        n = min(len(data), len(buf))
        buf[:n] = data[:n]
        return n

    def load_stripe(self, buf: np.ndarray, index: int,
                    byte_start: int, nbytes: int) -> int:
        """Serve one stripe: place its bytes at the base of the QP's
        registered buffer (the stripe READ addresses from 0)."""
        chunk = self.shard_bytes(index)[byte_start:byte_start + nbytes]
        buf[:len(chunk)] = chunk
        return len(chunk)


class DeviceLandingZone:
    """Pre-allocated device buffers streamed tiles land in — the
    software stand-in for the paper's NIC->GPU DMA region.  Buffers are
    allocated ONCE per shard on ``device``; each completed tile is
    copied in place into its rows (``buf[row:row+n].copy_(tile)``), so
    placement never reallocates and never bounces through a host array.

    A key with a sharding in ``shardings`` holds only this rank's block
    (``NamedSharding.block_bounds``; a shape the mesh does not divide
    raises), on ``device``, which must be of the mesh's device type; a
    tile lands only where its rows (and, for a spec that splits other
    dimensions, its columns) meet the block, and ``arrays()`` returns
    the block as a ``DTensor`` of the global shape.

    The reference places with a jitted ``dynamic_update_slice``, which
    clamps a start index so that the update fits; a tile that would run
    past the end here raises instead (the streaming plane never asks
    for one)."""

    def __init__(self, specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                 shardings: Optional[Dict] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self.shardings: Dict = {}
        self._bounds: Dict[str, Tuple[Tuple[int, int], ...]] = {}
        self.bufs: Dict[str, torch.Tensor] = {}
        for k, (shape, dtype) in specs.items():
            self.shapes[k] = shape = tuple(shape)
            shd = (shardings or {}).get(k)
            if shd is not None:
                shd.check_device(self.device)
                self.shardings[k] = shd
                self._bounds[k] = shd.block_bounds(shape)
                shape = tuple(n for _, n in self._bounds[k])
            self.bufs[k] = torch.zeros(shape, dtype=dtype, device=self.device)

    def _rows(self, key: str, row_offset: int, n: int) -> Tuple[int, int]:
        """The global rows ``[lo, hi)`` of a tile at ``row_offset`` that
        this rank holds (empty when ``lo >= hi``)."""
        rows = self.shapes[key][0]
        if row_offset < 0 or row_offset + n > rows:
            raise ValueError(f"tile rows [{row_offset}, {row_offset + n}) "
                             f"outside {key}'s {rows} rows")
        if key not in self._bounds:
            return row_offset, row_offset + n
        r0, nr = self._bounds[key][0]
        return max(row_offset, r0), min(row_offset + n, r0 + nr)

    def wants(self, key: str, row_offset: int, n: int) -> bool:
        """Whether a tile of ``n`` rows at ``row_offset`` meets this
        rank's block of ``key``."""
        lo, hi = self._rows(key, row_offset, n)
        return lo < hi

    def place(self, key: str, tile: torch.Tensor, row_offset: int):
        lo, hi = self._rows(key, row_offset, tile.shape[0])
        if lo >= hi:
            return
        src = tile[lo - row_offset:hi - row_offset]
        r0 = 0
        if key in self._bounds:
            (r0, _), *cols = self._bounds[key]
            for d, (c0, nc) in enumerate(cols, 1):
                src = src.narrow(d, c0, nc)
        self.bufs[key][lo - r0:hi - r0].copy_(src)

    def arrays(self) -> Dict[str, torch.Tensor]:
        return {k: (self.shardings[k].dtensor(b, self.shapes[k])
                    if k in self.shardings else b)
                for k, b in self.bufs.items()}


def make_dlrm_tile_decoder(n_dense: int, n_sparse: int,
                           modulus: Optional[int] = None, *,
                           mtu: int = pk.MTU,
                           impl: Optional[str] = None) -> Callable:
    """Device-side tile -> batch transform for the record-aligned DLRM
    stream layout (``synthetic.encode_dlrm_packets``).

    With ``modulus`` set the tile carries RAW records and is preprocessed
    here, per tile, with the preprocessing kernel — the tile-granular
    process-as-it-arrives path; the kernel reads the records straight
    out of the packet matrix.  With ``modulus=None`` the on-path
    ``PreprocService`` already rewrote the records inside the RX
    pipeline and the decoder only splits columns.  Either way the input
    is a fixed ``(tile_pkts, MTU)`` uint8 tensor on the device and
    nothing here runs on the host.  ``impl="ref"`` asks for the plain
    version of the kernel."""
    rec_w = n_dense + n_sparse
    words = mtu // 4
    rpp = words // rec_w              # records per packet

    def decode(tile_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        p = tile_u8.shape[0]
        w = tile_u8.contiguous().view(torch.int32)      # (p, words)
        recs = w[:, :rpp * rec_w]
        if modulus is not None:
            recs = ops.preproc(recs, n_dense, modulus, rec_w=rec_w,
                               impl=impl)
        else:
            recs = recs.reshape(p * rpp, rec_w)
        return {"dense": recs[:, :n_dense].view(torch.float32),
                "sparse": recs[:, n_dense:]}

    return decode


class BalboaIngest:
    """Streams shards from storage to the device through the service
    chain.  Every node's RX tables and the landing zone live on
    ``device`` (default the card).  ``shardings`` (batch key ->
    ``NamedSharding``) lands each key sharded over its mesh (see the
    module docstring); ``tiles_decoded`` and ``tiles_skipped`` count the
    streamed tiles this rank decoded and those it skipped because their
    rows miss its blocks."""

    def __init__(self, cfg: IngestConfig, services: Optional[ServiceChain],
                 shard_fn: Callable[[int], np.ndarray],
                 decode_fn: Optional[Callable] = None,
                 shardings: Optional[Dict] = None,
                 tile_to_batch: Optional[Callable] = None,
                 device: DeviceLike = None):
        check_epoch_mode(cfg.epoch_mode)
        for k, v in (shardings or {}).items():
            if v is not None and not isinstance(v, NamedSharding):
                raise TypeError(f"shardings[{k!r}] must be a NamedSharding "
                                f"on a DeviceMesh, got {v!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        n_nodes = 1 + cfg.n_storage_nodes
        if cfg.topology == "clos":
            from repro_torch.core.netsim import ClosConfig, ClosFabric
            ccfg = cfg.clos_cfg if cfg.clos_cfg is not None else ClosConfig(
                nodes_per_leaf=1, n_spines=2, port_delay=1,
                spine_delay=(1, 5), loss_prob=cfg.loss_prob, seed=3,
                path_mode=cfg.path_select or "ecmp")
            self.net = ClosFabric(n_nodes, ccfg)
        elif cfg.topology == "p2p":
            self.net = Network(n_nodes, LinkConfig(
                loss_prob=cfg.loss_prob, latency_ticks=cfg.latency_ticks,
                bandwidth_pkts_per_tick=cfg.link_bw_pkts_per_tick, seed=3))
        else:
            raise ValueError(f"unknown topology {cfg.topology!r}; "
                             f"choose from ('p2p', 'clos')")
        fc_window = cfg.fc_window if cfg.fc_window is not None else (
            16 if cfg.rx_mode == "selective_repeat" else 64)
        self._node_kw = dict(engine=cfg.engine, rx_mode=cfg.rx_mode,
                             path_select=cfg.path_select,
                             fc_window=fc_window, device=self.device)
        self.trainer = RdmaNode(0, self.net, services=services,
                                **self._node_kw)
        mtu = self.trainer.mtu
        tile_bytes = cfg.tile_pkts * mtu
        # QP buffers hold a full shard (legacy plane) rounded up to whole
        # tiles, so a fixed-shape tile view never runs off the end
        self._buf_bytes = -(-cfg.batch_bytes // tile_bytes) * tile_bytes
        self.storage: List[DisaggregatedStorage] = []
        self.qps: List[QpRef] = []
        self._node_qps: List[List[int]] = []   # node -> indices into qps
        for i in range(cfg.n_storage_nodes):
            node = RdmaNode(1 + i, self.net, **self._node_kw)
            self.storage.append(DisaggregatedStorage(node, shard_fn))
            mine = []
            for _ in range(cfg.qps_per_node):
                qpn_l, _rkey, _buf = self.trainer.init_rdma(
                    self._buf_bytes, node)
                mine.append(len(self.qps))
                self.qps.append(QpRef(i, qpn_l,
                                      self.trainer.remote_qpn(qpn_l)))
            self._node_qps.append(mine)
        self.shard_fn = shard_fn
        self.decode_fn = decode_fn
        self.shardings = shardings
        self.tile_to_batch = tile_to_batch
        self.tiles_decoded = 0
        self.tiles_skipped = 0
        self.refetches = 0
        self.recorder = None
        self._qp_epoch: Dict[int, int] = {}    # qpn_l -> failover epoch
        # payload bytes that crossed a host-side decode copy (legacy
        # plane only; the streaming plane keeps this at 0 — test-enforced)
        self.host_payload_bytes = 0
        self._rows_per_pkt: Optional[Dict[str, int]] = None
        self._tile_dtypes: Optional[Dict[str, Tuple]] = None

    _EPOCH_PSN_STRIDE = 1 << 16

    # ------------------------------------------------------- telemetry
    def attach_recorder(self, rec):
        """Wire a flight recorder (the reference's ``telemetry.
        FlightRecorder`` shape: ``record(tick, kind, track, **attrs)``)
        through the whole ingest stack: fabric hops, trainer/storage QP
        events, and the stream lifecycle (issue/tile/done/refetch) on
        per-stripe tracks."""
        self.recorder = rec
        self.net.attach_recorder(rec)
        self.trainer.attach_recorder(rec)
        for s in self.storage:
            s.node.attach_recorder(rec)

    def _rec(self, kind: str, sid: int, **attrs):
        if self.recorder is not None:
            self.recorder.record(self.net.now, kind, ("stripe", sid),
                                 **attrs)

    def snapshot(self) -> dict:
        """Common telemetry shape (the reference's ``MetricRegistry``)."""
        return {"refetches": self.refetches,
                "host_payload_bytes": self.host_payload_bytes,
                "n_qps": len(self.qps),
                "n_storage_nodes": len(self.storage)}

    def _failover_reestablish(self, qp: QpRef):
        """Tear down BOTH ends of the pair and restart them in a fresh
        PSN epoch (paper §4.6's out-of-band re-exchange).  A one-sided
        reset is unsound: a still-alive peer (transient outage) keeps
        replaying the old transfer's packets from its retransmit ring
        with exactly the PSNs a zero-reset trainer would expect, which
        silently delivers STALE payload into the next transfer on this
        QP.  The epoch stride additionally keeps packets already on the
        wire outside the new PSN window, where the RX pipeline discards
        them as duplicates instead of accepting them as data."""
        epoch = self._qp_epoch.get(qp.qpn_l, 0) + 1
        self._qp_epoch[qp.qpn_l] = epoch
        start_psn = (epoch * self._EPOCH_PSN_STRIDE) & pk.PSN_MASK
        self.trainer.reestablish_qp(qp.qpn_l, start_psn)
        self.storage[qp.node].node.reestablish_qp(qp.qpn_r, start_psn)

    # ------------------------------------------------ streaming plane
    def plan_stripes(self, nbytes: int) -> List[Stripe]:
        """Stripe a shard of ``nbytes`` across all QPs: contiguous
        packet ranges, one stripe per QP (fewer when the shard is
        smaller than the QP fan-out)."""
        mtu = self.trainer.mtu
        n_pkts = max(1, -(-nbytes // mtu))
        n_stripes = min(len(self.qps), n_pkts)
        per = -(-n_pkts // n_stripes)
        stripes = []
        for s in range(n_stripes):
            lo = s * per
            if lo >= n_pkts:
                break
            cnt = min(per, n_pkts - lo)
            stripes.append(Stripe(
                sid=len(stripes), pkt_start=lo, n_pkts=cnt,
                nbytes=min(cnt * mtu, nbytes - lo * mtu)))
        return stripes

    def _advance(self, nodes, active, stall, on_tick, rel, deadline):
        """One transport advance of the streaming loop: a single oracle
        tick, or — in fused epoch mode — one fused micro-epoch
        (``core.fused``: one launch of the epoch kernel) armed with a
        completion watermark per active stripe, so the device loop exits
        the moment any stripe crosses its next tile boundary and the
        host polls exactly then instead of every tick.  The epoch budget
        is clamped so the per-stripe stall detector and the shard
        deadline still fire on time; any unfusable world (an in-flight
        READ_REQUEST, a dead QP) falls back to per-tick stepping and
        re-attempts fusion next call."""
        cfg = self.cfg
        mode = cfg.epoch_mode or os.environ.get("BALBOA_EPOCH_MODE")
        if mode == "fused" and on_tick is None and active:
            tile_bytes = cfg.tile_pkts * self.trainer.mtu
            wms: Dict[Tuple[int, int], int] = {}
            budget = deadline - rel() + 1
            for qp_idx, stripe in active.items():
                qp = self.qps[qp_idx]
                lo = stripe.tiles_emitted * tile_bytes
                hi = min(lo + tile_bytes, stripe.nbytes)
                wms[(self.trainer.node_id, qp.qpn_l)] = max(
                    hi - stripe.resume, 1)
                budget = min(budget, stall + 1
                             - (self.net.now - stripe.progress_tick))
            if budget > 1:
                from repro_torch.core import fused
                res = fused.run_fused_epoch(nodes, max_ticks=budget,
                                            idle_done=8, watermarks=wms)
                if res is not None:
                    return
        step_network(nodes)

    def stream_shard(self, index: int,
                     consume_tile: Optional[Callable] = None,
                     on_tick: Optional[Callable[[int], None]] = None,
                     wants_tile: Optional[Callable] = None
                     ) -> StreamReport:
        """Striped, incremental fetch of shard ``index``.

        ``consume_tile(stripe, tile_idx, dev_tile, n_valid_pkts)`` fires
        the moment a tile's bytes are contiguously acknowledged —
        ``dev_tile`` is the fixed-shape ``(tile_pkts, MTU)`` uint8 tensor
        copied to the device straight from the registered buffer —
        unless ``wants_tile(first_pkt, n_valid_pkts)`` says this rank
        holds none of it (then the tile is neither copied nor consumed,
        and counts in ``tiles_skipped``).  ``on_tick`` is a
        test/fault-injection hook called once per network tick."""
        cfg = self.cfg
        mtu = self.trainer.mtu
        tile_bytes = cfg.tile_pkts * mtu
        nbytes = int(self.storage[0].shard_bytes(index).size)
        if nbytes > self._buf_bytes:
            raise ValueError(f"shard {index}: {nbytes} B exceeds the "
                             f"registered window {self._buf_bytes} B")
        stripes = self.plan_stripes(nbytes)
        stall = cfg.stall_ticks if cfg.stall_ticks is not None \
            else cfg.straggler_timeout_ticks
        n_pkts_total = max(1, -(-nbytes // mtu))
        deadline = stall * (cfg.n_storage_nodes + 2) + 32 * n_pkts_total
        nodes = [self.trainer] + [s.node for s in self.storage]
        pending: collections.deque = collections.deque(stripes)
        active: Dict[int, Stripe] = {}          # qp index -> stripe
        events: List[Tuple] = []
        t0 = self.net.now
        tiles_total = 0

        def rel() -> int:
            return self.net.now - t0

        def issue(stripe: Stripe, qp_idx: int):
            qp = self.qps[qp_idx]
            st = self.storage[qp.node]
            # tiles already handed downstream are valid (replicas serve
            # identical bytes) — a refetch READs only the un-consumed
            # suffix, resuming at the last emitted tile boundary
            stripe.resume = min(stripe.tiles_emitted * tile_bytes,
                                stripe.nbytes)
            st.load_stripe(st.node._qp_buffer[qp.qpn_r][1], index,
                           stripe.pkt_start * mtu + stripe.resume,
                           stripe.n_pkts * mtu - stripe.resume)
            self.trainer.reset_rx_progress(qp.qpn_l)
            self.trainer.rdma_read(qp.qpn_l, stripe.nbytes - stripe.resume)
            stripe.node, stripe.qp = qp.node, qp_idx
            stripe.issued_tick = stripe.progress_tick = self.net.now
            stripe.watermark = stripe.resume
            stripe.attempts += (qp.node,)
            active[qp_idx] = stripe
            events.append(("issue", rel(), stripe.sid, qp.node))
            self._rec("stream_issue", stripe.sid, node=qp.node,
                      resume=stripe.resume)

        def pick_qp(stripe: Stripe) -> Optional[int]:
            for qp_idx, qp in enumerate(self.qps):
                if qp_idx not in active and qp.node not in stripe.attempts:
                    return qp_idx
            return None

        while pending or active:
            for stripe in list(pending):
                qp_idx = pick_qp(stripe)
                if qp_idx is not None:
                    pending.remove(stripe)
                    issue(stripe, qp_idx)
            self._advance(nodes, active, stall, on_tick, rel, deadline)
            if on_tick is not None:
                on_tick(rel())
            for qp_idx, stripe in list(active.items()):
                qp = self.qps[qp_idx]
                # the READ addresses from the resume offset, so the
                # stripe-relative frontier is resume + QP watermark
                wm = stripe.resume + self.trainer.rx_progress(qp.qpn_l)
                if wm > stripe.watermark:
                    stripe.watermark = wm
                    stripe.progress_tick = self.net.now
                # hand over every newly completed fragment tile
                while True:
                    lo = stripe.tiles_emitted * tile_bytes
                    if lo >= stripe.nbytes:
                        break
                    hi = min(lo + tile_bytes, stripe.nbytes)
                    if stripe.watermark < hi:
                        break
                    n_valid = -(-(hi - lo) // mtu)
                    if consume_tile is not None and wants_tile is not None \
                            and not wants_tile(
                                stripe.pkt_start + lo // mtu, n_valid):
                        self.tiles_skipped += 1
                    elif consume_tile is not None:
                        buf = self.trainer._qp_buffer[qp.qpn_l][1]
                        # the one and only payload movement: registered
                        # buffer -> device, fixed tile shape, no host
                        # transform or decode in between.  The copy is
                        # load-bearing: on the CPU a tensor made from
                        # the buffer would ALIAS it, and a later refetch
                        # rewriting it would corrupt tiles already
                        # handed downstream
                        off = lo - stripe.resume   # buffer-relative
                        dev = to_device(
                            buf[off:off + tile_bytes].reshape(cfg.tile_pkts,
                                                              mtu),
                            self.device)
                        consume_tile(stripe, stripe.tiles_emitted, dev,
                                     n_valid)
                    events.append(("tile", rel(), stripe.sid,
                                   stripe.tiles_emitted))
                    self._rec("stream_tile", stripe.sid,
                              tile=stripe.tiles_emitted)
                    stripe.tiles_emitted += 1
                    tiles_total += 1
                if stripe.watermark >= stripe.nbytes:
                    stripe.done = True
                    stripe.ledger = self.trainer.credits.ledger(qp.qpn_l)
                    del active[qp_idx]
                    events.append(("done", rel(), stripe.sid))
                    self._rec("stream_done", stripe.sid,
                              tiles=stripe.tiles_emitted)
                    continue
                stalled = (self.net.now - stripe.progress_tick) > stall
                if self.trainer.qp_error(qp.qpn_l) or stalled:
                    # per-stripe failover: ONLY this stripe re-fetches,
                    # on a different replica; healthy stripes stream on
                    self.refetches += 1
                    stripe.refetches += 1
                    self._failover_reestablish(qp)
                    del active[qp_idx]
                    events.append(("refetch", rel(), stripe.sid,
                                   stripe.node))
                    self._rec("stream_refetch", stripe.sid,
                              node=stripe.node)
                    if len(set(stripe.attempts)) >= len(self.storage):
                        raise RuntimeError(
                            f"shard {index} stripe {stripe.sid}: "
                            f"all replicas failed")
                    stripe.node = stripe.qp = -1
                    pending.append(stripe)
            if rel() > deadline:
                raise RuntimeError(
                    f"shard {index}: streaming deadline exceeded "
                    f"({rel()} ticks, {len(pending) + len(active)} "
                    f"stripes unfinished)")
        done_ticks = [e[1] for e in events if e[0] == "done"]
        transport_done = max(done_ticks) if done_ticks else 0
        tiles_overlapped = sum(1 for e in events
                               if e[0] == "tile" and e[1] < transport_done)
        return StreamReport(
            index=index, nbytes=nbytes, ticks=rel(),
            transport_done_tick=transport_done, tiles=tiles_total,
            tiles_overlapped=tiles_overlapped,
            refetches=sum(s.refetches for s in stripes),
            stripes=stripes, events=events)

    def _discover_tile_specs(self):
        """One warm-up call of ``tile_to_batch`` on a zero tile pins the
        per-key row counts and dtypes.  On the card it launches the
        tile transform's kernel once, which counts as part of the
        streaming path."""
        mtu = self.trainer.mtu
        zero = torch.zeros((self.cfg.tile_pkts, mtu), dtype=torch.uint8,
                           device=self.device)
        out = self.tile_to_batch(zero)
        self._rows_per_pkt, self._tile_dtypes = {}, {}
        for k, v in out.items():
            if v.shape[0] % self.cfg.tile_pkts:
                raise ValueError(
                    f"tile_to_batch[{k}] rows {v.shape[0]} not a multiple "
                    f"of tile_pkts={self.cfg.tile_pkts}")
            self._rows_per_pkt[k] = v.shape[0] // self.cfg.tile_pkts
            self._tile_dtypes[k] = (tuple(v.shape[1:]), v.dtype)

    def fetch_shard_streaming(self, index: int
                              ) -> Tuple[Dict[str, torch.Tensor],
                                         StreamReport]:
        """Stream shard ``index`` straight into a device landing zone
        (sharded by ``shardings``): stripes fan out across all
        replicas/QPs, each tile is transformed on the device the moment
        it lands, and the host never touches a payload byte."""
        if self.tile_to_batch is None:
            raise ValueError("streaming fetch needs tile_to_batch "
                             "(e.g. make_dlrm_tile_decoder)")
        if self._rows_per_pkt is None:
            self._discover_tile_specs()
        mtu = self.trainer.mtu
        nbytes = int(self.storage[0].shard_bytes(index).size)
        n_pkts_total = max(1, -(-nbytes // mtu))
        zone = DeviceLandingZone(
            {k: ((n_pkts_total * self._rows_per_pkt[k],) + tail, dt)
             for k, (tail, dt) in self._tile_dtypes.items()},
            self.shardings, device=self.device)
        rpp = self._rows_per_pkt

        def mine(pkt0: int, n_valid_pkts: int) -> bool:
            return any(zone.wants(k, pkt0 * r, n_valid_pkts * r)
                       for k, r in rpp.items())

        def consume(stripe: Stripe, tidx: int, dev_tile: torch.Tensor,
                    n_valid_pkts: int):
            self.tiles_decoded += 1
            out = self.tile_to_batch(dev_tile)
            pkt0 = stripe.pkt_start + tidx * self.cfg.tile_pkts
            for k, arr in out.items():
                zone.place(k, arr[:n_valid_pkts * rpp[k]], pkt0 * rpp[k])

        report = self.stream_shard(
            index, consume, wants_tile=mine if zone.shardings else None)
        return zone.arrays(), report

    def stream_batches(self, n: int, start: int = 0
                       ) -> Iterator[Tuple[Dict[str, torch.Tensor],
                                           StreamReport]]:
        """Streamed iterator: transport/kernel overlap happens *inside*
        each fetch (tiles process while later stripes are on the wire),
        so no host-thread double buffering is needed."""
        for i in range(start, start + n):
            yield self.fetch_shard_streaming(i)

    # ---------------------------------------------- synchronous plane
    def fetch_shard(self, index: int) -> Dict[str, torch.Tensor]:
        """Store-and-forward baseline: RDMA-READ the whole shard from one
        replica, decode on the HOST, then copy to the device.  Kept as
        the oracle/bench baseline — the streaming plane exists to beat
        it."""
        if self.decode_fn is None:
            raise ValueError("fetch_shard needs decode_fn; use "
                             "fetch_shard_streaming for the host-bypass "
                             "streaming plane")
        order = [(index + r) % len(self.storage)
                 for r in range(len(self.storage))]
        for s in order:
            st = self.storage[s]
            qp = self.qps[self._node_qps[s][0]]
            nbytes = st.load_shard(st.node._qp_buffer[qp.qpn_r][1], index)
            before = self.trainer.check_completed(qp.qpn_l)
            self.trainer.rdma_read(qp.qpn_l, nbytes)
            run_network([self.trainer] + [x.node for x in self.storage],
                        max_ticks=self.cfg.straggler_timeout_ticks)
            if self.trainer.check_completed(qp.qpn_l) > before:
                raw = self.trainer._qp_buffer[qp.qpn_l][1][:nbytes]
                self.host_payload_bytes += nbytes   # the copy we eliminate
                host_batch = self.decode_fn(raw.copy())
                return self._to_device(host_batch)
            # straggler / dead peer: re-establish BOTH ends in a fresh
            # PSN epoch (clears the errored QP's retransmit ring +
            # flow-control queue on either side) and try the replica
            self.refetches += 1
            self._failover_reestablish(qp)
        raise RuntimeError(f"shard {index}: all replicas failed")

    def _to_device(self, host_batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """Each key onto the device: under its sharding, this rank's
        block as a ``DTensor``."""
        shardings = self.shardings or {}
        return {k: (shardings[k].distribute(
            torch.from_numpy(np.ascontiguousarray(v)), self.device)
            if shardings.get(k) is not None else to_device(v, self.device))
            for k, v in host_batch.items()}

    def batches(self, n: int, start: int = 0) -> Iterator[Dict]:
        """Double-buffered iterator over the synchronous plane: shard
        i+1 transfers on a worker thread while i trains."""
        import concurrent.futures as cf
        with cf.ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self.fetch_shard, start)
            for i in range(start, start + n):
                cur = fut.result()
                if i + 1 < start + n:
                    fut = ex.submit(self.fetch_shard, i + 1)
                yield cur
