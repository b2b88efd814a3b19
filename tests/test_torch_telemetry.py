"""The port's observability plane (``repro_torch.core.telemetry``) against
the reference's (``repro.core.telemetry``), on the CPU.

Typed metrics, the registry, the recorder's ring bounds and the
Chrome-trace export's phases and tracks, as tests/test_telemetry.py
holds the reference's; then the system through it:
BENCH_fig6_multipath.json's ``traced_incast`` (an 8:1 Clos incast,
selective repeat and spray, spine 0 failing at tick 10, flight-recorded)
run by the port: its ``flat()`` equals the committed row's telemetry and
the reference's, and its Chrome trace equals the reference's byte for
byte; and the reference suite's reconciliation properties under random
loss and spray (injected == inject + wire_drop events, retransmit events
== the stats, enqueue == dequeue + flush).
"""
import json
from pathlib import Path

import pytest

from _hyp import given, settings, st
from repro.core import netsim as jnet
from repro.core import telemetry as jtm
from repro_torch.core import netsim as tnet
from repro_torch.core import telemetry as tm

ROOT = Path(__file__).resolve().parents[1]


def test_typed_metrics():
    c = tm.Counter()
    c.inc()
    c.inc(4)
    assert c.snapshot() == 5
    g = tm.Gauge()
    g.set(2.5)
    assert g.snapshot() == 2.5
    h = tm.Histogram(bounds=(1, 4, 16))
    for v in (0, 1, 3, 20, 1000):
        h.observe(v)
    s = h.snapshot()
    assert s == {"count": 5, "sum": 1024, "min": 0, "max": 1000,
                 "buckets": [2, 1, 0, 2]}
    assert tm.Histogram().snapshot() == jtm.Histogram().snapshot()


def test_registry_register_snapshot_flat_diff():
    reg = tm.MetricRegistry()
    c = reg.counter("net/tx")
    with pytest.raises(ValueError):
        reg.counter("net/tx")                     # duplicate
    for bad in ("", "/x", "x/"):
        with pytest.raises(ValueError):
            reg.register(bad, tm.Counter())
    reg.gauge("net/depth", 7)
    reg.histogram("net/lat", bounds=(2,)).observe(3)
    reg.register("node", lambda: {"stats": {"rx": 2, "lst": [1, 2]}})
    c.inc(10)
    snap = reg.snapshot()
    assert snap == {"net": {"tx": 10, "depth": 7,
                            "lat": {"count": 1, "sum": 3, "min": 3,
                                    "max": 3, "buckets": [0, 1]}},
                    "node": {"stats": {"rx": 2, "lst": [1, 2]}}}
    flat = reg.flat(snap)
    assert flat["node/stats/lst/1"] == 2 and flat["net/lat/buckets/1"] == 1
    assert flat == jtm.flatten(snap)
    c.inc(5)
    d = reg.diff(snap, reg.snapshot())
    assert d["net/tx"] == 5 and d["node/stats/rx"] == 0
    reg.deregister("node")
    assert reg.paths() == ["net/depth", "net/lat", "net/tx"]
    reg.register("net/tx/x", tm.Counter())
    with pytest.raises(ValueError, match="collides"):
        reg.snapshot()


def test_recorder_ring_bounds_and_counts():
    with pytest.raises(ValueError):
        tm.FlightRecorder(capacity=0)
    rec = tm.FlightRecorder(capacity=4)
    for i in range(10):
        rec.record(i, "inject", ("node", 0), psn=i)
    rec.record(10, "nak", ("qp", "0:1"))
    assert rec.total_events == 11 and rec.dropped_events == 7
    assert [e.tick for e in rec.events()] == [7, 8, 9, 10]
    assert [e.tick for e in rec.events("nak")] == [10]
    assert rec.counts == {"inject": 10, "nak": 1}      # wrap-independent
    assert rec.snapshot() == {"events_total": 11, "events_dropped": 7,
                              "events_retained": 4,
                              "by_kind": {"inject": 10, "nak": 1}}
    rec.clear()
    assert rec.total_events == 0 and not rec.events() and not rec.counts


def test_chrome_trace_phases_and_tracks():
    """Every phase and track rule, and the export, byte for byte the
    reference's on the same events."""
    recs = (tm.FlightRecorder(), jtm.FlightRecorder())
    for rec in recs:
        rec.record(1, "enqueue", ("port", 0), qpn=1, psn=0)
        rec.record(1, "qdepth", ("port", 0), depth=3)
        rec.record(2, "coll_transfer", ("coll", "world4"), dur=5, sends=2)
        rec.record(3, "retransmit", ("qp", "1:7"), psn=9)
        rec.record(3, "retransmit", ("qp", "1:8"), psn=2)
        rec.record(4, "custom", ("widget", "w"))
    doc = recs[0].chrome_trace(tick_us=2)
    by_ph = {}
    for e in doc["traceEvents"]:
        by_ph.setdefault(e["ph"], []).append(e)
    procs = {e["args"]["name"]: e["pid"] for e in by_ph["M"]
             if e["name"] == "process_name"}
    assert procs == {"port": 1, "coll": 2, "qp": 3, "widget": 4}
    sort = {e["pid"]: e["args"]["sort_index"] for e in by_ph["M"]
            if e["name"] == "process_sort_index"}
    assert sort == {1: 0, 2: 8, 3: 6, 4: 9}      # unknown category last
    threads = [(e["pid"], e["tid"], e["args"]["name"]) for e in by_ph["M"]
               if e["name"] == "thread_name"]
    assert threads == [(1, 1, "port 0"), (2, 1, "coll world4"),
                       (3, 1, "qp 1:7"), (3, 2, "qp 1:8"), (4, 1, "widget w")]
    [cnt] = by_ph["C"]
    assert cnt["name"] == "qdepth" and cnt["args"] == {"depth": 3}
    [span] = by_ph["X"]
    assert span["ts"] == 4 and span["dur"] == 10 and span["args"] == \
        {"sends": 2}
    assert [e["name"] for e in by_ph["i"]] == ["enqueue", "retransmit",
                                               "retransmit", "custom"]
    assert all(e["s"] == "t" for e in by_ph["i"])
    assert doc["otherData"] == {"clock": "sim_ticks", "tick_us": 2,
                                "events_dropped": 0}
    assert recs[0].chrome_trace_json(tick_us=3) == \
        recs[1].chrome_trace_json(tick_us=3)


def test_export_chrome_trace_roundtrip(tmp_path):
    rec = tm.FlightRecorder()
    tnet.incast_scenario(2, message_bytes=8192, recorder=rec, device="cpu")
    path = tmp_path / "trace.json"
    n = rec.export_chrome_trace(str(path))
    assert n == len(rec.events()) > 0
    assert path.read_text() == rec.chrome_trace_json()
    doc = json.loads(path.read_text())
    assert any(e["ph"] == "C" for e in doc["traceEvents"])


# ---------------------------------------------------------------------------
# the system through the plane
# ---------------------------------------------------------------------------

def _traced_incast(netsim, telemetry, **kw):
    """benchmarks/fig6_multiqp.py:traced_incast at the committed row's
    size (8:1, 16 KiB): the registry's flat snapshot, the ticks and the
    recorder."""
    rec = telemetry.FlightRecorder(capacity=1 << 20)
    res = netsim.clos_incast_scenario(
        8, message_bytes=16384, rx_mode="selective_repeat",
        path_select="spray", fail_spine_at=10, recorder=rec, **kw)
    reg, _ = telemetry.instrument(fabric=res.fabric,
                                  nodes=[res.receiver] + res.senders,
                                  recorder=rec)
    return reg.flat(), res.ticks, rec


@pytest.fixture(scope="module")
def traced():
    return (_traced_incast(tnet, tm, device="cpu"),
            _traced_incast(jnet, jtm))


def test_traced_incast_flat_equals_committed_row_and_reference(traced):
    (flat, ticks, rec), (jflat, jticks, _) = traced
    row = json.loads((ROOT / "BENCH_fig6_multipath.json").read_text())[
        "traced_incast"]
    assert len(row["telemetry"]) == 386
    assert flat == row["telemetry"] == jflat
    assert ticks == row["ticks"] == jticks == 31
    assert len(rec.events()) == row["trace_events"] == 745
    assert rec.dropped_events == 0
    by = {k.split("/")[-1]: v for k, v in flat.items()
          if k.startswith("flight/by_kind/")}
    assert by["inject"] + by.get("wire_drop", 0) == flat["fabric/injected"]
    assert by["enqueue"] == by["dequeue"] + by.get("flush", 0)
    assert by["spine_fail"] == 1


def test_traced_incast_trace_byte_identical_to_reference(traced):
    (_, _, rec), (_, _, jrec) = traced
    assert rec.chrome_trace_json() == jrec.chrome_trace_json()
    assert rec.chrome_trace_json(tick_us=5) == jrec.chrome_trace_json(
        tick_us=5)


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 2**31), st.integers(2, 4),
       st.sampled_from([0.0, 0.02, 0.05]),
       st.sampled_from(["spray", "ecmp"]),
       st.sampled_from(["selective_repeat", "go_back_n"]))
def test_counters_reconcile_random_loss_spray(seed, fan_in, loss, path,
                                              rx_mode):
    """Packet conservation and event reconciliation in the port:
    injected == inject + wire_drop events == delivered + dropped + in
    flight; retransmit events == the nodes' retransmission stats;
    enqueue == dequeue + flush."""
    rec = tm.FlightRecorder(capacity=1 << 18)
    cfg = tnet.ClosConfig(nodes_per_leaf=1, n_spines=2, port_bandwidth=4,
                          port_delay=1, queue_capacity=48,
                          spine_delay=(1, 5), loss_prob=loss,
                          seed=seed % 997, path_mode=path)
    res = tnet.clos_incast_scenario(fan_in, message_bytes=8192,
                                    clos_cfg=cfg, rx_mode=rx_mode,
                                    path_select=path, recorder=rec,
                                    device="cpu")
    reg, _ = tm.instrument(fabric=res.fabric,
                           nodes=[res.receiver] + res.senders, recorder=rec)
    snap = reg.snapshot()
    fab = snap["fabric"]
    dropped = (fab["ports"]["wire_dropped"] + fab["ports"]["tail_dropped"]
               + fab["uplinks"]["wire_dropped"]
               + fab["uplinks"]["tail_dropped"]
               + fab["spine_down"]["wire_dropped"]
               + fab["spine_down"]["tail_dropped"]
               + fab["failure_dropped"])
    assert fab["injected"] == (dropped + fab["ports"]["delivered"]
                               + fab["in_flight"])
    by = snap["flight"]["by_kind"]
    assert by.get("inject", 0) + by.get("wire_drop", 0) == fab["injected"]
    assert by.get("retransmit", 0) == sum(
        n.stats.retransmissions for n in [res.receiver] + res.senders)
    assert by.get("enqueue", 0) == by.get("dequeue", 0) + by.get("flush", 0)
    assert rec.dropped_events == 0
