"""Queue-pair state (paper §4.1).

Three tables, exactly as in the packet-processing pipeline of Fig. 2:

  * connection table — remote IP / UDP port / remote QPN (static per QP)
  * state table     — expected PSN (ePSN, RX) and next PSN (nPSN, TX),
                      last-acked PSN, retransmit timer deadline
  * MSN table       — message sequence number + remaining bytes of the
                      in-flight multi-packet message (fine-grained
                      sequence control for large buffer transmissions)

Tables default to 500 QPs (paper: "per default, these tables support up
to 500 QPs, but can be configured").

FPGA -> TPU design dual: on the FPGA these tables live in BRAM and are
read/written by the pipeline in flight, one packet per cycle; here they
are arrays-of-fields so the torch engines update them functionally — the
scan oracle one packet at a time, the batched engine one *wave* (one
packet per QP) at a time, gathered/scattered by QP index.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

DEFAULT_NUM_QPS = 500


@dataclasses.dataclass
class QPTables:
    """Array-of-fields per-QP state.  All arrays shape (n_qps,)."""
    # connection table
    remote_ip: np.ndarray
    remote_port: np.ndarray
    remote_qpn: np.ndarray
    local_key: np.ndarray          # AES key id for the crypto service
    active: np.ndarray
    # state table
    epsn: np.ndarray               # next expected PSN (RX)
    npsn: np.ndarray               # next PSN to assign (TX)
    last_acked: np.ndarray         # cumulative acked PSN (TX)
    # MSN table
    msn: np.ndarray
    bytes_left: np.ndarray         # remaining bytes of in-flight message
    cur_vaddr: np.ndarray          # write cursor of in-flight message

    @staticmethod
    def create(n_qps: int = DEFAULT_NUM_QPS) -> "QPTables":
        z = lambda dt=np.int64: np.zeros(n_qps, dt)
        return QPTables(
            remote_ip=z(), remote_port=z(), remote_qpn=z(), local_key=z(),
            active=z(np.int32), epsn=z(np.int32), npsn=z(np.int32),
            last_acked=np.full(n_qps, -1, np.int64),
            msn=z(np.int32), bytes_left=z(), cur_vaddr=z(),
        )

    @property
    def n_qps(self) -> int:
        return self.epsn.shape[0]

    def as_dict(self) -> Dict[str, np.ndarray]:
        return dataclasses.asdict(self)


class QPManager:
    """Host-side QP lifecycle: setup via out-of-band exchange (the paper
    exchanges QP info over TCP sockets before the RDMA flow starts),
    teardown, and re-establishment after peer failure."""

    def __init__(self, n_qps: int = DEFAULT_NUM_QPS, node_id: int = 0):
        self.tables = QPTables.create(n_qps)
        self.node_id = node_id
        self._next_qpn = 1          # QPN 0 reserved
        self.buffers: Dict[int, np.ndarray] = {}    # rkey -> registered mem
        self._next_rkey = 1

    # ---- memory registration (initRDMA returns a remote-visible buffer)
    def register_buffer(self, size: int) -> Tuple[int, np.ndarray]:
        rkey = self._next_rkey
        self._next_rkey += 1
        buf = np.zeros(size, np.uint8)
        self.buffers[rkey] = buf
        return rkey, buf

    # ---- out-of-band QP exchange -------------------------------------
    def create_qp(self, remote_ip: int, remote_port: int,
                  start_psn: int = 0) -> int:
        qpn = self._next_qpn
        self._next_qpn += 1
        if qpn >= self.tables.n_qps:
            raise RuntimeError("QP table exhausted")
        t = self.tables
        t.remote_ip[qpn] = remote_ip
        t.remote_port[qpn] = remote_port
        t.active[qpn] = 1
        t.epsn[qpn] = start_psn
        t.npsn[qpn] = start_psn
        t.last_acked[qpn] = start_psn - 1
        return qpn

    def connect(self, qpn: int, remote_qpn: int, key_id: int = 0):
        self.tables.remote_qpn[qpn] = remote_qpn
        self.tables.local_key[qpn] = key_id

    def destroy_qp(self, qpn: int):
        t = self.tables
        t.active[qpn] = 0
        t.epsn[qpn] = t.npsn[qpn] = 0
        t.msn[qpn] = 0
        t.bytes_left[qpn] = 0

    def reestablish(self, qpn: int, start_psn: int = 0):
        """QP recovery after peer failure (framework-level fault
        tolerance reuses this together with checkpoint restore)."""
        t = self.tables
        t.active[qpn] = 1
        t.epsn[qpn] = start_psn
        t.npsn[qpn] = start_psn
        t.last_acked[qpn] = start_psn - 1
        t.msn[qpn] = 0
        t.bytes_left[qpn] = 0
