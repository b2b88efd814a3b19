"""The port's main path end to end against the JAX reference, on the CPU.

* ``examples/secure_flow.py`` as written (2 x 64 KiB over a lossy link,
  sender-side AES, receiver-side decrypt + DPI, a sniffer on the
  sender), run in-process against
  ``repro_torch.examples.secure_flow.main`` on the CPU, each with the
  committed DPI fixture in place of the model it trains: ticks, every
  node snapshot, the engine counters, the delivered bytes,
  ``dpi_flagged`` and the PCAP bytes must be equal.
* The port reproduces the committed tick baselines of
  ``BENCH_fig6_multipath.json`` exactly: the incast rows (8:1
  ack-clocked on the DCQCN-marking fabric named on its own) and the
  Clos multipath rows.
"""
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import netsim as tnet
from repro_torch.core import rdma as trdma
from repro_torch.data import load_dpi_params_seed0
from repro_torch.examples import secure_flow

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIG6 = json.loads((ROOT / "BENCH_fig6_multipath.json").read_text())


def _reference_example(name: str):
    """``examples/<name>.py`` loaded as a module, to run in-process."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_secure_flow(mod, monkeypatch, capture: Path, engine="batched",
                     **kw):
    """Run a secure-flow example's ``main`` in-process (``mod`` is the
    reference's or the port's module), recording its two nodes (built
    with ``engine``), each ``run_network``'s ticks and the receiver's
    DPI flags after it, with the capture written to ``capture``."""
    rec = {"nodes": [], "ticks": [], "flagged_total": []}
    node_cls, sniffer_cls, run = (mod.RdmaNode, mod.TrafficSniffer,
                                  mod.run_network)

    class Node(node_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, engine=engine, **k)
            rec["nodes"].append(self)

    class Sniffer(sniffer_cls):
        def write_pcap(self, path):
            rec["pcap_packets"] = super().write_pcap(str(capture))
            return rec["pcap_packets"]

    def run_network(nodes, **k):
        rec["ticks"].append(run(nodes, **k))
        rec["flagged_total"].append(nodes[1].stats.dpi_flagged)
        return rec["ticks"][-1]

    with monkeypatch.context() as mp:
        mp.setattr(mod, "RdmaNode", Node)
        mp.setattr(mod, "TrafficSniffer", Sniffer)
        mp.setattr(mod, "run_network", run_network)
        rec["returned"] = mod.main(**kw)
    a, b = rec["nodes"]
    assert a.engine == b.engine == engine
    tot = rec["flagged_total"]
    return {"ticks": rec["ticks"],
            "flagged": [tot[0], tot[1] - tot[0]],
            "snapshots": [a.snapshot(), b.snapshot()],
            "engine": [{k: v.tolist() for k, v in n.engine_counters().items()}
                       for n in (a, b)],
            "buffer": b._qp_buffer[1][1].copy(),
            "pcap_packets": rec["pcap_packets"],
            "pcap": capture.read_bytes(),
            "now": a.net.now,
            "returned": rec["returned"]}


def _secure_flow_reference(monkeypatch, pcap: Path, params):
    """``examples/secure_flow.py`` as written, with the committed DPI
    fixture in place of the model it trains (the fixture is that
    training's result)."""
    mod = _reference_example("secure_flow")
    monkeypatch.setattr(mod, "train_dpi_params", lambda *a, **k: {
        k: jnp.asarray(v) for k, v in params.items()})
    return _run_secure_flow(mod, monkeypatch, pcap)


def _secure_flow_port(monkeypatch, pcap: Path, engine="batched"):
    """``repro_torch.examples.secure_flow.main(device="cpu")``, with the
    committed DPI fixture in place of the model it trains (the port's
    own training is held to the reference's in
    ``test_torch_placement_dpi.py``), so that both examples run on the
    same weights."""
    params = load_dpi_params_seed0()
    monkeypatch.setattr(secure_flow, "train_dpi_params",
                        lambda *a, **k: dict(params))
    return _run_secure_flow(secure_flow, monkeypatch, pcap, engine,
                            device="cpu", pcap=str(pcap))


@pytest.fixture(scope="module")
def dpi_params():
    return load_dpi_params_seed0()


def test_secure_flow_matches_reference(dpi_params, monkeypatch, tmp_path):
    ref = _secure_flow_reference(monkeypatch, tmp_path / "ref.pcap",
                                 dpi_params)
    got = _secure_flow_port(monkeypatch, tmp_path / "port.pcap")
    assert got["ticks"] == ref["ticks"]
    assert got["flagged"] == ref["flagged"]
    assert got["flagged"][0] == 0 and got["flagged"][1] > 0
    assert got["returned"]["flagged"] == dict(zip(("benign", "malicious"),
                                                  ref["flagged"]))
    assert got["returned"]["pcap_packets"] == ref["pcap_packets"]
    assert got["snapshots"] == ref["snapshots"]
    assert got["engine"] == ref["engine"]
    np.testing.assert_array_equal(got["buffer"], ref["buffer"])
    assert got["pcap_packets"] == ref["pcap_packets"]
    assert got["pcap"] == ref["pcap"]
    assert got["now"] == ref["now"]


def test_secure_flow_scan_engine_matches_batched(monkeypatch, tmp_path):
    """The per-packet oracle drives the same node to the same state."""
    scan = _secure_flow_port(monkeypatch, tmp_path / "s.pcap", engine="scan")
    bat = _secure_flow_port(monkeypatch, tmp_path / "b.pcap")
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
