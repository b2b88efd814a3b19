"""Collective communication over the BALBOA transport (the ML-fabric
workload the paper's opening claim is about), with the fold on the card.

The dominant data-center RDMA pattern is the collective, and this
module schedules the classic ones across N ``RdmaNode``s on a
``SwitchedFabric`` (or point-to-point ``Network``):

  * ring **reduce-scatter**, **allgather** and **allreduce**
    (reduce-scatter + allgather, the bandwidth-optimal schedule),
  * tree **broadcast** (binary tree rooted at any rank).

Every step rides the real verbs: tensors are chunked through
``rdma_write`` into the peers' registered buffers, receivers poll
``check_completed``, and the whole exchange therefore flows through the
batched RX engine, go-back-N retransmission, rkey protection, RX
crediting and DCQCN pacing — there is no side-channel delivery.

In-fabric reduction offload
---------------------------
``offload=True`` installs an ``AllreduceService``: a parallel-path-
style service tap relocated to the *switch* (``netsim.SwitchReducer``).
The reduce phase then sends every chunk straight to its owner, tagged as
CHUNK contributions (``Packet.coll_*``); the switch folds them
fragment-wise with the segmented-reduce kernel
(``repro_torch.kernels.reduce``) and releases ONE summed stream per
chunk.

The switch reducer and the ring's per-step fold are numpy in and numpy
out (the simulator's buffers are host memory), so each fold copies its
stack to the device, launches the kernel and copies the result back:
one round trip per fragment on the offload path, one per chunk and
ring step on the ring path.

Bit-identity contract
---------------------
float32 addition commutes but does not associate, so the fold order is
pinned: chunk ``c`` is reduced as the left fold over ranks
``(c+1, c+2, ..., c+N-1, c)`` — the order the ring schedule produces
naturally, the order the switch reducer replays (``coll_src`` is the
fold position; the owner folds its own contribution last), and the
order ``allreduce_oracle`` computes in plain numpy.  Ring, offload and
oracle are therefore bit-identical, under loss and retransmission too
(tests/test_torch_collectives.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.netsim import SwitchReducer
from repro_torch.core.rdma import RdmaNode, check_epoch_mode, run_network
from repro_torch.core.services import ParallelPathService
from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.kernels import ops

_DTYPES = {"float32": np.float32, "int32": np.int32}


def _fold_on(device, stack: np.ndarray, dtype: str,
             impl: Optional[str]) -> np.ndarray:
    """(K, L) uint8 host stack -> (L,) uint8 host fold, through the
    segmented-reduce kernel on ``device`` (its plain version on the
    CPU or with ``impl="ref"``)."""
    out = ops.chunk_reduce(to_device(np.asarray(stack, np.uint8), device),
                           dtype=dtype, impl=impl)
    return out.cpu().numpy()


class AllreduceService(ParallelPathService):
    """Control-plane handle of the in-fabric reduction offload.

    Architecturally a parallel-path service (paper Fig. 1 ②) whose tap
    point is the *switch* rather than the endpoint pipeline: the
    ``SwitchReducer`` it owns observes the CHUNK stream at the fabric
    hop and feeds the decision — the folded payload — back into the
    forwarding path.  This object carries the service-chain face (name,
    ``describe``) plus the control plane: the reduce kernel on
    ``device`` (default the card) for the group's dtype, and the QP
    registrations that let the switch synthesize transport ACKs for
    absorbed contributions.  Placed in a node's chain it observes and
    flags nothing — the offload's effect arrives as summed payloads, not
    flag bits.
    """

    name = "allreduce-offload"

    def __init__(self, fabric, *, dtype: str = "float32",
                 impl: Optional[str] = None, device: DeviceLike = None):
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported collective dtype {dtype!r}")
        if impl not in ops.IMPLS:
            raise ValueError(f"unknown impl {impl!r}; choose from "
                             f"{ops.IMPLS}")
        self.dtype = dtype
        self.impl = impl
        self.device = resolve_device(device)
        self.reducer = SwitchReducer(self._reduce)
        fabric.attach_reducer(self.reducer)

    def _reduce(self, stack: np.ndarray) -> np.ndarray:
        return _fold_on(self.device, stack, self.dtype, self.impl)

    def register_qp(self, src_node: int, dst_node: int, src_qpn: int):
        self.reducer.register_qp(src_node, dst_node, src_qpn)

    def describe(self) -> str:
        r = self.reducer
        return (f"{self.name}[{self.dtype}/{self.impl or 'auto'}@"
                f"{self.device}]: absorbed={r.absorbed} "
                f"forwarded={r.reduced_forwarded} "
                f"acks={r.acks_synthesized}")
    # node-side placement inherits the observe-nothing ParallelPathService
    # __call__ — the offload's feedback arrives as summed payloads, not
    # flag bits


@dataclasses.dataclass
class CollectiveStats:
    ticks: int = 0               # fabric ticks spent inside collectives
    transfers: int = 0           # _transfer barriers executed
    bytes_moved: int = 0         # payload bytes submitted to rdma_write

    def snapshot(self) -> dict:
        """Common telemetry shape (the reference's ``MetricRegistry``)."""
        return dataclasses.asdict(self)


class CollectiveGroup:
    """N ranks on one fabric, full-mesh connected, running ring/tree
    collectives over the verbs.

    ``nodes`` are caller-built ``RdmaNode``s (so congestion control,
    engines and service chains compose freely); rank ``r`` is
    ``nodes[r]``, and the folds run on rank 0's device.  ``max_bytes``
    sizes the registered buffers — it must hold the largest (padded)
    tensor exchanged.  ``offload=True`` requires a ``SwitchedFabric``
    and installs the ``AllreduceService`` reduction offload for the
    reduce phase; the allgather phase always rides the ring.
    """

    def __init__(self, nodes: Sequence[RdmaNode], max_bytes: int, *,
                 dtype: str = "float32", offload: bool = False,
                 impl: Optional[str] = None, max_ticks: int = 300_000,
                 epoch_mode: Optional[str] = None):
        if len(nodes) < 2:
            raise ValueError("a collective group needs at least 2 ranks")
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported collective dtype {dtype!r}")
        check_epoch_mode(epoch_mode)
        self.nodes = list(nodes)
        self.world = len(nodes)
        self.net = nodes[0].net
        self.device = nodes[0].device
        self.max_bytes = max_bytes
        self.dtype = dtype
        self.impl = impl
        self.offload = offload
        self.max_ticks = max_ticks
        self.epoch_mode = epoch_mode    # None = env BALBOA_EPOCH_MODE;
                                        # "fused" = whole-epoch kernel
                                        # transfers (core.fused)
        self.stats = CollectiveStats()
        self.recorder = None
        self._op_seq = 0
        # full QP mesh: _qpn[i][j] = rank i's QP toward rank j; writes on
        # it land in rank j's registered buffer for _qpn[j][i]
        self._qpn: List[Dict[int, int]] = [{} for _ in nodes]
        for i in range(self.world):
            for j in range(i + 1, self.world):
                qpn_ij, _, _ = nodes[i].init_rdma(max_bytes, nodes[j])
                qpn_ji = int(nodes[i].qp.tables.remote_qpn[qpn_ij])
                self._qpn[i][j] = qpn_ij
                self._qpn[j][i] = qpn_ji
        self.service: Optional[AllreduceService] = None
        if offload:
            if not hasattr(self.net, "attach_reducer"):
                raise ValueError("offload=True needs a SwitchedFabric")
            self.service = AllreduceService(self.net, dtype=dtype, impl=impl,
                                            device=self.device)
            for i in range(self.world):
                for j in range(self.world):
                    if i != j:
                        self.service.register_qp(
                            nodes[i].node_id, nodes[j].node_id,
                            self._qpn[i][j])

    # ------------------------------------------------------------ telemetry
    def attach_recorder(self, rec):
        """Wire a flight recorder through the fabric and every rank;
        collective barriers show up as ``coll_transfer`` spans on the
        group's track."""
        self.recorder = rec
        self.net.attach_recorder(rec)
        for n in self.nodes:
            n.attach_recorder(rec)

    def snapshot(self) -> dict:
        """Common telemetry shape (the reference's ``MetricRegistry``)."""
        out = self.stats.snapshot()
        out["world"] = self.world
        if self.service is not None:
            out["reducer"] = self.service.reducer.snapshot()
        return out

    # ------------------------------------------------------------ plumbing
    def _recv_buf(self, rank: int, src: int) -> np.ndarray:
        return self.nodes[rank]._buffer_for(self._qpn[rank][src])

    def _transfer(self, sends):
        """One bulk-synchronous exchange: issue every ``(src, dst, data,
        remote_addr, coll)`` write, drive the network until quiescent,
        then verify via completion polling that every stream that should
        reach its receiver did (absorbed offload contributions complete
        at the switch, not at the receiver)."""
        expect: Dict[tuple, int] = {}
        for src, dst, data, addr, coll in sends:
            key = (dst, src)
            if key not in expect:
                expect[key] = self.nodes[dst].check_completed(
                    self._qpn[dst][src])
            delivered = coll is None or coll[1] == coll[2] - 1  # carrier?
            if delivered:
                expect[key] += self.nodes[src].expected_completions(len(data))
            self.stats.bytes_moved += len(data)
            self.nodes[src].rdma_write(self._qpn[src][dst], data,
                                       remote_addr=addr, coll=coll)
        t0 = self.net.now
        run_network(self.nodes, max_ticks=self.max_ticks,
                    epoch_mode=self.epoch_mode)
        self.stats.ticks += self.net.now - t0
        self.stats.transfers += 1
        if self.recorder is not None:
            self.recorder.record(
                t0, "coll_transfer", ("coll", f"world{self.world}"),
                dur=self.net.now - t0, sends=len(sends))
        for (dst, src), want in expect.items():
            got = self.nodes[dst].check_completed(self._qpn[dst][src])
            if got < want:
                raise RuntimeError(
                    f"collective transfer incomplete: rank {dst} polled "
                    f"{got} completions from rank {src}, expected {want} "
                    f"(QP died? {self.nodes[src].qp_errors})")

    def _fold2(self, acc_in: np.ndarray, own: np.ndarray) -> np.ndarray:
        """acc_in + own through the segmented-reduce kernel (continuing
        the canonical left fold)."""
        stack = np.stack([np.asarray(acc_in, np.uint8),
                          np.asarray(own, np.uint8)])
        return _fold_on(self.device, stack, self.dtype, self.impl)

    def _layout(self, xs: Sequence[np.ndarray]):
        npdt = _DTYPES[self.dtype]
        shape = np.asarray(xs[0]).shape
        flats = []
        for x in xs:
            a = np.asarray(x, npdt)
            if a.shape != shape:
                raise ValueError("ranks must contribute equal shapes")
            flats.append(np.ravel(a))
        n_elems = flats[0].size
        if n_elems == 0:
            raise ValueError("empty collective")
        chunk_elems = -(-n_elems // self.world)
        width = np.dtype(npdt).itemsize
        chunk_bytes = chunk_elems * width
        padded_bytes = chunk_bytes * self.world
        if padded_bytes > self.max_bytes:
            raise ValueError(f"tensor needs {padded_bytes} B buffers, "
                             f"group registered {self.max_bytes} B")
        work = []
        for f in flats:
            buf = np.zeros(padded_bytes, np.uint8)
            buf[:n_elems * width] = f.view(np.uint8)
            work.append(buf)
        return work, shape, n_elems, chunk_bytes

    def _region(self, c: int, chunk_bytes: int) -> slice:
        return slice(c * chunk_bytes, (c + 1) * chunk_bytes)

    # ------------------------------------------------------------ phases
    def _reduce_scatter_ring(self, work: List[np.ndarray], chunk_bytes: int):
        """N-1 neighbor steps; afterwards rank r holds chunk r fully
        reduced in canonical order (the fold travels c+1 -> ... -> c)."""
        n = self.world
        for s in range(n - 1):
            sends = []
            for r in range(n):
                c = (r - 1 - s) % n
                sends.append((r, (r + 1) % n,
                              work[r][self._region(c, chunk_bytes)],
                              c * chunk_bytes, None))
            self._transfer(sends)
            for r in range(n):
                c = (r - 2 - s) % n
                reg = self._region(c, chunk_bytes)
                inc = self._recv_buf(r, (r - 1) % n)[reg]
                work[r][reg] = self._fold2(inc, work[r][reg])

    def _reduce_scatter_offload(self, work: List[np.ndarray],
                                chunk_bytes: int):
        """One parallel shot: every rank sends each non-owned chunk to
        its owner, tagged with its canonical fold position; the switch
        folds ranks c+1..c+N-1 and the owner folds itself in last."""
        n = self.world
        self._op_seq += 1
        sends = []
        for r in range(n):
            for c in range(n):
                if c == r:
                    continue
                pos = (r - c - 1) % n
                tag = (self._op_seq << 16) | c | 0x8000_0000  # never zero
                sends.append((r, c, work[r][self._region(c, chunk_bytes)],
                              c * chunk_bytes, (tag, pos, n - 1)))
        self._transfer(sends)
        for r in range(n):
            reg = self._region(r, chunk_bytes)
            inc = self._recv_buf(r, (r - 1) % n)[reg]
            work[r][reg] = self._fold2(inc, work[r][reg])
        self.service.reducer.clear()     # fabric is quiescent: safe to gc

    def _allgather_ring(self, work: List[np.ndarray], chunk_bytes: int):
        """N-1 neighbor steps propagating each owner's chunk around."""
        n = self.world
        for s in range(n - 1):
            sends = []
            for r in range(n):
                c = (r - s) % n
                sends.append((r, (r + 1) % n,
                              work[r][self._region(c, chunk_bytes)],
                              c * chunk_bytes, None))
            self._transfer(sends)
            for r in range(n):
                c = (r - 1 - s) % n
                reg = self._region(c, chunk_bytes)
                work[r][reg] = self._recv_buf(r, (r - 1) % n)[reg].copy()

    # ------------------------------------------------------------ verbs
    def reduce_scatter(self, xs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Rank r gets its owned reduced shard (chunk r, trimmed to the
        unpadded element range)."""
        work, _, n_elems, chunk_bytes = self._layout(xs)
        if self.offload:
            self._reduce_scatter_offload(work, chunk_bytes)
        else:
            self._reduce_scatter_ring(work, chunk_bytes)
        npdt = _DTYPES[self.dtype]
        width = np.dtype(npdt).itemsize
        out = []
        for r in range(self.world):
            lo = r * chunk_bytes
            hi = min((r + 1) * chunk_bytes, n_elems * width)
            out.append(work[r][lo:max(hi, lo)].copy().view(npdt))
        return out

    def allgather(self, xs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Every rank contributes an equal-shaped shard; every rank gets
        the rank-order concatenation."""
        npdt = _DTYPES[self.dtype]
        shards = [np.ravel(np.asarray(x, npdt)) for x in xs]
        n = self.world
        if any(s.size != shards[0].size for s in shards):
            raise ValueError("allgather shards must be equal-sized")
        chunk_bytes = shards[0].size * np.dtype(npdt).itemsize
        if chunk_bytes * n > self.max_bytes:
            raise ValueError("allgather result exceeds registered buffers")
        work = []
        for r in range(n):
            buf = np.zeros(chunk_bytes * n, np.uint8)
            buf[self._region(r, chunk_bytes)] = shards[r].view(np.uint8)
            work.append(buf)
        self._allgather_ring(work, chunk_bytes)
        return [w.view(npdt).copy() for w in work]

    def allreduce(self, xs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Element-wise sum across ranks, every rank gets the result —
        ring reduce-scatter (or the in-fabric offload) + ring allgather.
        Bit-identical to ``allreduce_oracle`` in either mode."""
        work, shape, n_elems, chunk_bytes = self._layout(xs)
        if self.offload:
            self._reduce_scatter_offload(work, chunk_bytes)
        else:
            self._reduce_scatter_ring(work, chunk_bytes)
        self._allgather_ring(work, chunk_bytes)
        npdt = _DTYPES[self.dtype]
        width = np.dtype(npdt).itemsize
        return [w[:n_elems * width].copy().view(npdt).reshape(shape)
                for w in work]

    def allreduce_bucketed(self, xs: Sequence[np.ndarray],
                           bucket_elems: int) -> List[np.ndarray]:
        """``allreduce`` of a tensor larger than the registered buffers,
        as a run of allreduces of at most ``bucket_elems`` elements (a
        multiple of the world size), bit-identical to ``allreduce_oracle``
        of the whole tensor.

        Consecutive slices would not be: each element is folded in the
        rotation of the ring chunk it falls in, and a slice's chunks are
        not the whole tensor's.  So bucket ``k`` is the ``k``-th slice of
        each of the whole tensor's N chunks, laid side by side: its ring
        chunk ``c`` is a piece of the whole tensor's chunk ``c`` and
        folds in that chunk's rotation."""
        n = self.world
        npdt = _DTYPES[self.dtype]
        shape = np.asarray(xs[0]).shape
        flats = [np.ravel(np.asarray(x, npdt)) for x in xs]
        if any(f.size != flats[0].size for f in flats):
            raise ValueError("ranks must contribute equal shapes")
        n_elems = flats[0].size
        if bucket_elems < n or bucket_elems % n:
            raise ValueError(f"bucket_elems must be a positive multiple of "
                             f"the world size {n}")
        chunk = -(-n_elems // n)           # the whole tensor's ring chunk
        piece = bucket_elems // n
        outs = [np.empty(n_elems, npdt) for _ in range(n)]
        for lo in range(0, chunk, piece):
            w = min(piece, chunk - lo)
            bucket = [np.zeros(n * w, npdt) for _ in range(n)]
            for c in range(n):
                a = min(c * chunk + lo, n_elems)
                b = min(c * chunk + lo + w, n_elems)
                for r in range(n):
                    bucket[r][c * w:c * w + b - a] = flats[r][a:b]
            summed = self.allreduce(bucket)
            for c in range(n):
                a = min(c * chunk + lo, n_elems)
                b = min(c * chunk + lo + w, n_elems)
                for r in range(n):
                    outs[r][a:b] = summed[r][c * w:c * w + b - a]
        return [o.reshape(shape) for o in outs]

    def broadcast(self, x: np.ndarray, root: int = 0) -> List[np.ndarray]:
        """Binary-tree broadcast from ``root``; returns every rank's
        copy (bit-identical to the input)."""
        npdt = _DTYPES[self.dtype]
        data = np.ravel(np.asarray(x, npdt))
        nbytes = data.size * np.dtype(npdt).itemsize
        if nbytes > self.max_bytes:
            raise ValueError("broadcast tensor exceeds registered buffers")
        n = self.world
        actual = lambda v: (root + v) % n        # virtual rank -> rank
        have: Dict[int, np.ndarray] = {0: data.view(np.uint8)}
        frontier = [0]
        while frontier:
            sends, recvs = [], []
            for v in frontier:
                for child in (2 * v + 1, 2 * v + 2):
                    if child < n:
                        sends.append((actual(v), actual(child),
                                      have[v], 0, None))
                        recvs.append((child, v))
            if not sends:
                break
            self._transfer(sends)
            frontier = []
            for child, parent in recvs:
                have[child] = self._recv_buf(
                    actual(child), actual(parent))[:nbytes].copy()
                frontier.append(child)
        shape = np.asarray(x).shape
        return [have[(r - root) % n].view(npdt).reshape(shape).copy()
                for r in range(n)]


def allreduce_oracle(xs: Sequence[np.ndarray], dtype: str = "float32"
                     ) -> np.ndarray:
    """The oracle the transport must reproduce bit for bit, in plain
    numpy on the host: chunk ``c`` (of N = len(xs) chunks) is the left
    fold of the ranks in rotation order ``c+1, ..., c+N-1, c`` — exactly
    the association the ring schedule and the switch reducer compute.
    Each add is one IEEE float32 (or wrapping int32) add, as on the
    card, so the bits agree.  For int32 this equals a plain sum."""
    npdt = _DTYPES[dtype]
    n = len(xs)
    flats = [np.ravel(np.asarray(x, npdt)) for x in xs]
    n_elems = flats[0].size
    chunk_elems = -(-n_elems // n)
    padded = chunk_elems * n
    cols = np.stack([np.pad(f, (0, padded - n_elems)) for f in flats])
    chunks = []
    with np.errstate(over="ignore"):
        for c in range(n):
            reg = cols[:, c * chunk_elems:(c + 1) * chunk_elems]
            acc = reg[(c + 1) % n].copy()
            for k in range(2, n + 1):
                acc = acc + reg[(c + k) % n]
            chunks.append(acc)
    out = np.concatenate(chunks)[:n_elems]
    return out.reshape(np.asarray(xs[0]).shape)


def make_ring_group(world: int, max_bytes: int, *,
                    fabric_cfg=None, dtype: str = "float32",
                    offload: bool = False,
                    congestion_control: str = "ack_clocked",
                    engine: str = "batched", fc_window: int = 16,
                    impl: Optional[str] = None,
                    max_ticks: int = 300_000,
                    rx_mode: str = "go_back_n",
                    path_select: Optional[str] = None,
                    epoch_mode: Optional[str] = None,
                    device: DeviceLike = None):
    """Convenience constructor: ``world`` nodes on a fresh fabric
    (ports = ranks), mesh-connected into a ``CollectiveGroup``, with
    every node's RX tables and the folds on ``device`` (default the
    card).  Returns the group (nodes at ``group.nodes``).

    ``fabric_cfg`` may be a ``FabricConfig`` (single-switch star, the
    default) or a ``ClosConfig`` (leaf-spine multipath — pair it with
    ``rx_mode="selective_repeat"`` / ``path_select="spray"`` so the
    collective's neighbor exchanges tolerate the fabric's reorder).
    """
    from repro_torch.core.flow_control import DcqcnConfig
    from repro_torch.core.netsim import (ClosConfig, ClosFabric,
                                         FabricConfig, SwitchedFabric,
                                         _per_port)

    check_epoch_mode(epoch_mode)
    dev = resolve_device(device)
    cfg = fabric_cfg if fabric_cfg is not None else FabricConfig(
        port_bandwidth=4, port_delay=2, queue_capacity=48, seed=7)
    if isinstance(cfg, ClosConfig):
        fabric = ClosFabric(world, cfg)
    else:
        fabric = SwitchedFabric(world, cfg)
    line = float(_per_port(cfg.port_bandwidth, world)[0])
    dcqcn = DcqcnConfig(line_rate=line, initial_rate=line / 4)
    nodes = [RdmaNode(i, fabric, fc_window=fc_window, engine=engine,
                      congestion_control=congestion_control, dcqcn=dcqcn,
                      rx_mode=rx_mode, path_select=path_select, device=dev)
             for i in range(world)]
    return CollectiveGroup(nodes, max_bytes, dtype=dtype, offload=offload,
                           impl=impl, max_ticks=max_ticks,
                           epoch_mode=epoch_mode)
