"""RoCE BALBOA core, ported module for module from ``repro.core``.

packet / qp / pipeline   — RoCE v2 framing, per-QP tables, RX/TX FSMs
flow_control             — ACK-clocked windows + RX crediting (§4.3/4.4)
retransmit / netsim      — reliability under loss (§4.2); netsim also
                           models a switched fabric (incast/congestion)
services                 — on-path & parallel-path enhancements (§5)
rdma                     — the full endpoint (verbs of §4.6)
sniffer                  — PCAP traffic capture (§4.7)
ingest                   — §8 streaming ingest: storage -> RDMA -> device
collectives              — ring / in-fabric-offloaded allreduce and friends
telemetry                — metric registry + flight recorder
fused                    — whole epochs as one launch of the epoch kernel

``packet``, ``qp``, ``chaos``, ``flow_control``, ``retransmit``,
``netsim``, ``sniffer`` and ``telemetry`` are pure numpy/Python in the
reference and are kept here as copies (the port imports nothing of
``repro``); the wire-format and scenario tests hold them equal.  ``pipeline``,
``services`` and ``rdma`` are rewritten on torch tensors; ``ingest`` and
``collectives`` keep the reference's host-side control logic around
device tensors and the port's kernels; ``fused`` keeps the reference's
packing and unpacking around the epoch kernel.
"""
