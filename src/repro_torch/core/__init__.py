"""RoCE BALBOA core, ported module for module from ``repro.core``.

packet / qp / pipeline   — RoCE v2 framing, per-QP tables, RX/TX FSMs
flow_control             — ACK-clocked windows + RX crediting (§4.3/4.4)
retransmit / netsim      — reliability under loss (§4.2); netsim also
                           models a switched fabric (incast/congestion)
services                 — on-path & parallel-path enhancements (§5)
rdma                     — the full endpoint (verbs of §4.6)
sniffer                  — PCAP traffic capture (§4.7)

``packet``, ``qp``, ``chaos``, ``flow_control``, ``retransmit``,
``netsim`` and ``sniffer`` are pure numpy/Python in the reference and
are kept here as copies (the port imports nothing of ``repro``); the
wire-format and scenario tests hold them equal.  ``pipeline``,
``services`` and ``rdma`` are rewritten on torch tensors.
"""
