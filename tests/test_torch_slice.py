"""The port's main path end to end against the JAX reference, on the CPU.

* ``examples/secure_flow.py`` as written (2 x 64 KiB over a lossy link,
  sender-side AES, receiver-side decrypt + DPI, a sniffer on the
  sender) runs through both packages with the same trained DPI model
  (the committed fixture): ticks, every node snapshot, the engine
  counters, the delivered bytes, ``dpi_flagged`` and the PCAP bytes
  must be equal.
* The port reproduces the committed tick baselines of
  ``BENCH_fig6_multipath.json`` exactly: the incast rows (8:1
  ack-clocked on the DCQCN-marking fabric named on its own) and the
  Clos multipath rows.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import netsim as jnet
from repro.core import rdma as jrdma
from repro.core import services as jsvc
from repro.core import sniffer as jsniff
from repro.data import dpi_dataset as jdata
from repro_torch.core import netsim as tnet
from repro_torch.core import rdma as trdma
from repro_torch.core import services as tsvc
from repro_torch.core import sniffer as tsniff
from repro_torch.data import dpi_dataset as tdata
from repro_torch.data import load_dpi_params_seed0

torch.set_num_threads(1)

KEY = np.arange(16, dtype=np.uint8)
ROOT = Path(__file__).resolve().parents[1]
FIG6 = json.loads((ROOT / "BENCH_fig6_multipath.json").read_text())


def _secure_flow(port: bool, params, pcap: Path, engine="batched"):
    """examples/secure_flow.py's scenario through one package."""
    net_m, rdma_m, svc_m, sniff_m, data_m = (
        (tnet, trdma, tsvc, tsniff, tdata) if port else
        (jnet, jrdma, jsvc, jsniff, jdata))
    kw = {"device": "cpu"} if port else {}
    rng = np.random.default_rng(0)
    benign = data_m.payload_with_embedded_malware(65536, 0.0, rng)
    evil = data_m.payload_with_embedded_malware(65536, 0.2, rng)
    net = net_m.Network(2, net_m.LinkConfig(loss_prob=0.02, latency_ticks=3,
                                            seed=1))
    sniffer = sniff_m.TrafficSniffer(capture_payload=True)
    p = params if port else {k: jnp.asarray(v) for k, v in params.items()}
    chain = svc_m.ServiceChain(
        on_path=[svc_m.AesService(key=KEY, decrypt=True, **kw)],
        parallel_after=[svc_m.DpiService(params=p, **kw)])
    a = rdma_m.RdmaNode(0, net, sniffer=sniffer, engine=engine, **kw)
    b = rdma_m.RdmaNode(1, net, services=chain, engine=engine, **kw)
    qpn_a, _, _ = a.init_rdma(1 << 18, b)
    enc = svc_m.AesService(key=KEY, **kw)
    out = {"ticks": [], "flagged": []}
    for data in (benign, evil):
        blocks = data.reshape(-1, 4096)
        plen = np.full(len(blocks), 4096, np.int32)
        if port:
            ct = enc(torch.from_numpy(blocks.copy()),
                     torch.from_numpy(plen)).numpy()
        else:
            ct = np.asarray(enc(jnp.asarray(blocks), jnp.asarray(plen)))
        before = b.stats.dpi_flagged
        a.rdma_write(qpn_a, ct.reshape(-1))
        out["ticks"].append(rdma_m.run_network([a, b], max_ticks=50_000))
        out["flagged"].append(b.stats.dpi_flagged - before)
        np.testing.assert_array_equal(b._qp_buffer[1][1][:len(data)], data)
    out["snapshots"] = [a.snapshot(), b.snapshot()]
    out["engine"] = [{k: v.tolist() for k, v in n.engine_counters().items()}
                     for n in (a, b)]
    out["buffer"] = b._qp_buffer[1][1].copy()
    out["pcap_packets"] = sniffer.write_pcap(str(pcap))
    out["pcap"] = pcap.read_bytes()
    out["now"] = net.now
    return out


@pytest.fixture(scope="module")
def dpi_params():
    return load_dpi_params_seed0()


def test_secure_flow_matches_reference(dpi_params, tmp_path):
    ref = _secure_flow(False, dpi_params, tmp_path / "ref.pcap")
    got = _secure_flow(True, dpi_params, tmp_path / "port.pcap")
    assert got["ticks"] == ref["ticks"]
    assert got["flagged"] == ref["flagged"]
    assert got["flagged"][0] == 0 and got["flagged"][1] > 0
    assert got["snapshots"] == ref["snapshots"]
    assert got["engine"] == ref["engine"]
    np.testing.assert_array_equal(got["buffer"], ref["buffer"])
    assert got["pcap_packets"] == ref["pcap_packets"]
    assert got["pcap"] == ref["pcap"]
    assert got["now"] == ref["now"]


def test_secure_flow_scan_engine_matches_batched(dpi_params, tmp_path):
    """The per-packet oracle drives the same node to the same state."""
    scan = _secure_flow(True, dpi_params, tmp_path / "s.pcap", engine="scan")
    bat = _secure_flow(True, dpi_params, tmp_path / "b.pcap")
    for k in ("ticks", "flagged", "snapshots", "engine", "pcap", "now"):
        assert scan[k] == bat[k], k


def incast_row(res) -> dict:
    """The fields of a ``BENCH_fig6_multipath.json`` incast row, from a
    finished ``incast_scenario`` run (as benchmarks/fig6_multiqp.py
    reads them)."""
    hot = res.fabric.port_stats[0]
    return {
        "ticks": res.ticks,
        "tail_dropped": hot.tail_dropped,
        "ecn_marked": hot.ecn_marked,
        "max_queue": hot.max_depth,
        "retransmissions": sum(s.stats.retransmissions for s in res.senders),
        "cnp_tx": res.receiver.stats.cnp_tx,
        "cnp_rx": sum(s.stats.cnp_rx for s in res.senders),
        "qp_deaths": sum(len(s.retx.exhausted) for s in res.senders),
    }


def test_incast_8to1_reproduces_committed_baseline():
    want = next(r for r in FIG6["incast_cc"]
                if r["fan_in"] == 8 and r["cc"] == "ack_clocked")
    res = tnet.incast_scenario(8, message_bytes=want["message_bytes"],
                               fabric_cfg=tnet.dcqcn_fabric_profile(),
                               congestion_control="ack_clocked",
                               device="cpu")
    got = incast_row(res)
    assert got == {k: want[k] for k in got}
    assert (got["ticks"], got["tail_dropped"], got["retransmissions"],
            got["cnp_rx"]) == (209, 112, 112, 6)
    for i, data in enumerate(res.payloads):
        np.testing.assert_array_equal(
            res.receiver._qp_buffer[i + 1][1][:len(data)], data)


@pytest.mark.parametrize("row", FIG6["incast_cc"], ids=[
    f"{r['fan_in']}to1-{r['cc']}" for r in FIG6["incast_cc"]])
def test_incast_rows_reproduce_committed_baseline(row):
    """Every incast row, ack-clocked and DCQCN, on the CPU."""
    res = tnet.incast_scenario(row["fan_in"],
                               message_bytes=row["message_bytes"],
                               fabric_cfg=tnet.dcqcn_fabric_profile(),
                               congestion_control=row["cc"], device="cpu")
    got = incast_row(res)
    assert got == {k: row[k] for k in got}


@pytest.mark.parametrize("row", FIG6["multipath"], ids=[
    f"{r['rx_mode']}-{r['path_select']}-fail{r['fail_spine_at']}"
    for r in FIG6["multipath"]])
def test_multipath_rows_reproduce_committed_baseline(row):
    """The Clos multipath rows (GBN vs SR, spray vs ECMP, a mid-transfer
    spine failure) as benchmarks/fig6_multiqp.py reads them."""
    res = tnet.clos_incast_scenario(
        row["fan_in"], message_bytes=row["message_bytes"],
        rx_mode=row["rx_mode"], path_select=row["path_select"],
        fail_spine_at=row["fail_spine_at"], device="cpu")
    fab = res.fabric
    got = {
        "ticks": res.ticks,
        "spine_pkts": list(fab.spine_pkts),
        "tail_dropped": fab.total_tail_dropped,
        "retransmissions": sum(s.stats.retransmissions for s in res.senders),
        "ooo_naks": sum(s.stats.ooo_nak for s in res.senders)
        + res.receiver.stats.ooo_nak,
        "sacked": sum(s.stats.sacked for s in res.senders),
        "alive_spines": len(fab.alive_paths),
        "failure_dropped": fab.failure_dropped,
    }
    assert got == {k: row[k] for k in got}
    for i, data in enumerate(res.payloads):
        assert res.receiver.check_completed(i + 1) == \
            res.senders[i].expected_completions(len(data))
        np.testing.assert_array_equal(
            res.receiver._qp_buffer[i + 1][1][:len(data)], data)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    net = tnet.Network(2, tnet.LinkConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trdma.RdmaNode(0, net)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnet.incast_scenario(2, message_bytes=4096)


def test_fused_epochs_are_not_ported_yet(monkeypatch):
    """Fused epochs are ported now: BALBOA_EPOCH_MODE=fused runs the
    transfer in fused epochs (one each time a world packs) and delivers
    the same bytes in the same ticks as per-tick stepping; an unknown
    mode raises, as in the reference."""
    from repro_torch.core import fused

    def transfer():
        net = tnet.Network(2, tnet.LinkConfig(latency_ticks=1))
        a = trdma.RdmaNode(0, net, device="cpu")
        b = trdma.RdmaNode(1, net, device="cpu")
        qpn, _, _ = a.init_rdma(8192, b)
        a.rdma_write(qpn, np.arange(8192, dtype=np.uint8))
        return a, b

    a, b = transfer()
    ticks = trdma.run_network([a, b], epoch_mode="tick")
    monkeypatch.setenv("BALBOA_EPOCH_MODE", "fused")
    a, b = transfer()
    fused.STATS.reset()
    assert trdma.run_network([a, b]) == ticks > 0
    assert fused.STATS.epochs >= 1
    np.testing.assert_array_equal(b._qp_buffer[1][1],
                                  np.arange(8192, dtype=np.uint8))
    with pytest.raises(ValueError, match="epoch_mode"):
        trdma.run_network([a, b], epoch_mode="epoch")
    monkeypatch.setenv("BALBOA_EPOCH_MODE", "epoch")
    with pytest.raises(ValueError, match="epoch_mode"):
        trdma.run_network([a, b])
