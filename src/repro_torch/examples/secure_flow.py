"""Service-enhanced RDMA flow (paper §5 end to end): the sender encrypts
on its TX path, the receiver decrypts on-path and runs ML-DPI on the
parallel path; the traffic sniffer (paper §4.7) captures the ciphertext
wire traffic into a PCAP you can open in Wireshark.  The DPI model is
trained first, on the same device, as the reference's example trains
it (``train_dpi_params`` on ``make_dataset(2048, seed=0)``, 200 steps).

  python -m repro_torch.examples.secure_flow [--cpu] [PCAP]
"""
from __future__ import annotations

import os
import sys
import tempfile
from typing import Dict, Optional

import numpy as np

from repro_torch.core.netsim import LinkConfig, Network
from repro_torch.core.rdma import RdmaNode, run_network
from repro_torch.core.services import AesService, DpiService, ServiceChain
from repro_torch.core.sniffer import TrafficSniffer
from repro_torch.data.dpi_dataset import (make_dataset,
                                          payload_with_embedded_malware)
from repro_torch.device import DeviceLike, resolve_device, to_device
from repro_torch.kernels.dpi_mlp import train_dpi_params

KEY = np.arange(16, dtype=np.uint8)


def main(device: DeviceLike = None, pcap: Optional[str] = None) -> Dict:
    """Two 64 KiB flows (benign, 20 % malware) over a lossy link on
    ``device`` (default the card); writes the sender's capture to
    ``pcap`` (default ``balboa_flow.pcap`` in the temporary directory).
    Returns the per-flow DPI flags and the packets captured."""
    dev = resolve_device(device)
    pcap = pcap or os.path.join(tempfile.gettempdir(), "balboa_flow.pcap")
    # train the DPI model (paper: CSV/PNG/TXT vs executables)
    x, y = make_dataset(2048, seed=0)
    dpi_params = train_dpi_params(x, y, steps=200, device=dev)

    rng = np.random.default_rng(0)
    benign = payload_with_embedded_malware(65536, 0.0, rng)  # text/CSV/PNG
    evil = payload_with_embedded_malware(65536, 0.2, rng)    # 20% malware

    net = Network(2, LinkConfig(loss_prob=0.02, latency_ticks=3, seed=1))
    sniffer = TrafficSniffer(capture_payload=True)
    # DPI must inspect the *decrypted* stream -> parallel_after placement
    recv_chain = ServiceChain(
        on_path=[AesService(key=KEY, decrypt=True, device=dev)],
        parallel_after=[DpiService(params=dpi_params, device=dev)])
    a = RdmaNode(0, net, sniffer=sniffer, device=dev)
    b = RdmaNode(1, net, services=recv_chain, device=dev)
    qpn_a, _, _ = a.init_rdma(1 << 18, b)

    enc = AesService(key=KEY, device=dev)
    flagged = {}
    for name, data in (("benign", benign), ("malicious", evil)):
        blocks = data.reshape(-1, 4096)
        plen = np.full(len(blocks), 4096, np.int32)
        ct = enc(to_device(blocks, dev), to_device(plen, dev)).cpu().numpy()
        flagged_before = b.stats.dpi_flagged
        a.rdma_write(qpn_a, ct.reshape(-1))
        run_network([a, b], max_ticks=50_000)
        got = b._qp_buffer[1][1][:len(data)]
        ok = bool((got == data).all())
        flagged[name] = b.stats.dpi_flagged - flagged_before
        print(f"[secure] {name:10s} delivered={ok} "
              f"dpi_flagged_packets={flagged[name]}/{len(data)//4096}")
        assert ok
    assert b.stats.dpi_flagged > 0, "DPI missed the malicious flow"

    n = sniffer.write_pcap(pcap)
    print(f"[secure] wrote {n} packets to {pcap} "
          f"(RoCE v2 BTH frames; wire payloads are AES ciphertext)")
    print("secure_flow OK")
    return {"flagged": flagged, "pcap_packets": n, "device": str(dev)}


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    main("cpu" if "--cpu" in sys.argv[1:] else None,
         args[0] if args else None)
