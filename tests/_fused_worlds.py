"""World constructors and the full-world snapshot diff for the fused epoch
core's tests, for either package.

``pkg`` is the ``core`` package of the reference (``repro.core``) or of
the port (``repro_torch.core``); ``device`` is passed to the port's
nodes only.  One numpy seed builds the same world in both.  The snapshot
is the reference suite's (tests/test_fused_core.py), with the RX tables
read to numpy from torch columns too.  No JAX is imported here, so the
card's tests can use it.
"""
import importlib

import numpy as np

MTU = 256                     # small MTU => multi-packet, multi-chunk plans


def _mods(pkg):
    return (importlib.import_module(f"{pkg}.netsim"),
            importlib.import_module(f"{pkg}.rdma"))


def _dev(pkg, device):
    return {"device": device} if pkg.startswith("repro_torch") else {}


def build_star(pkg, seed, *, sr=False, loss=0.0, kmax=0, nbytes=2000,
               n_senders=2, bw=3, cap=16, window=16, presteps=0,
               extra_qps=0, qps=1, device="cpu"):
    netsim, rdma = _mods(pkg)
    cfg = netsim.FabricConfig(port_bandwidth=bw, port_delay=2,
                              queue_capacity=cap, loss_prob=loss,
                              ecn_kmin=4, ecn_kmax=kmax, seed=seed % 1000,
                              chaos_seed=seed if (loss or kmax) else None)
    fab = netsim.SwitchedFabric(n_senders + 1, cfg)
    mode = "selective_repeat" if sr else "go_back_n"
    kw = dict(fc_window=window, rx_mode=mode,
              n_qps=max(32, n_senders * qps + extra_qps + 1), mtu=MTU,
              **_dev(pkg, device))
    recv = rdma.RdmaNode(0, fab, **kw)
    senders = [rdma.RdmaNode(i + 1, fab, **kw) for i in range(n_senders)]
    rng = np.random.default_rng(seed)
    for i, s in enumerate(senders):
        for j in range(qps + (extra_qps if i == 0 else 0)):
            q, _rk, _buf = s.init_rdma(1 << 16, recv)
            s.rdma_write(q, rng.integers(
                0, 256, max(nbytes + 777 * i - 301 * j, 1),
                dtype=np.uint8))
    nodes = [recv] + senders
    for _ in range(presteps):
        rdma.step_network(nodes)
    return nodes


def build_p2p(pkg, seed, *, sr=False, loss=0.0, reorder=0.0, jitter=0,
              nbytes=2000, latency=2, bw=0, window=16, presteps=0,
              n_flows=2, device="cpu"):
    netsim, rdma = _mods(pkg)
    chaos = seed if (loss or reorder or jitter) else None
    cfg = netsim.LinkConfig(loss_prob=loss, reorder_prob=reorder,
                            jitter_ticks=jitter, latency_ticks=latency,
                            bandwidth_pkts_per_tick=bw, seed=seed % 1000,
                            chaos_seed=chaos)
    net = netsim.Network(2, cfg)
    mode = "selective_repeat" if sr else "go_back_n"
    kw = dict(fc_window=window, rx_mode=mode, n_qps=32, mtu=MTU,
              **_dev(pkg, device))
    a, b = rdma.RdmaNode(0, net, **kw), rdma.RdmaNode(1, net, **kw)
    rng = np.random.default_rng(seed)
    for i in range(n_flows):
        q, _rk, _buf = a.init_rdma(1 << 16, b)
        a.rdma_write(q, rng.integers(0, 256, nbytes + 501 * i,
                                     dtype=np.uint8))
    nodes = [a, b]
    for _ in range(presteps):
        rdma.step_network(nodes)
    return nodes


# the worlds the property suites draw from, by name: (constructor, fixed
# keywords) — the randomised keywords come from each suite
SUITES = {
    "star_gbn_loss": (build_star, {}),
    "star_sr_loss": (build_star, {"sr": True}),
    "star_ecn": (build_star, {"n_senders": 2, "bw": 2, "cap": 14}),
    "p2p_gbn_spray": (build_p2p, {}),
    "p2p_sr_spray": (build_p2p, {"sr": True, "bw": 3}),
}

# one fixed world of each suite (shape keys the card tests reuse)
FIXED = {
    "star_gbn_loss": {"seed": 7, "loss": 0.08, "nbytes": 2200,
                      "presteps": 6, "extra_qps": 1},
    "star_sr_loss": {"seed": 9, "loss": 0.1, "nbytes": 2600, "presteps": 5},
    "star_ecn": {"seed": 11, "kmax": 8, "nbytes": 3000, "presteps": 6},
    "p2p_gbn_spray": {"seed": 5, "loss": 0.08, "reorder": 0.25,
                      "jitter": 3, "presteps": 4},
    "p2p_sr_spray": {"seed": 13, "loss": 0.05, "reorder": 0.3,
                     "jitter": 2, "presteps": 5},
}


def build(pkg, suite, device="cpu", **kw):
    fn, fixed = SUITES[suite]
    return fn(pkg, **{**fixed, **kw}, device=device)


def overflow_world(pkg, device="cpu"):
    """A p2p world whose 4000-tick links hold every timeout
    retransmission in flight: more packets than the wire's slots, so the
    fused epoch aborts (wire overflow) and returns None."""
    return build_p2p(pkg, 3, latency=4000, nbytes=3000, n_flows=2,
                     device=device)


def wide_world(pkg, device="cpu"):
    """A star of 4 senders x 5 QPs (20 messages of 84-94 packets, a
    window of 8) into one receiver, 2 % loss: 40 directed flows, plan
    rows bucketed to 128, a blob of over 227 KB, past what a block's
    shared memory holds, so the fused epoch runs on the blob in device
    memory."""
    return build_star(pkg, 29, loss=0.02, nbytes=21_500, n_senders=4,
                      qps=5, window=8, device=device)


# ---------------------------------------------------------------------------
# full-world snapshot / structural diff (tests/test_fused_core.py's)
# ---------------------------------------------------------------------------

def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _pkt_tuple(p):
    pay = None if p.payload is None or p.payload.size == 0 \
        else bytes(np.asarray(p.payload, np.uint8).tobytes())
    return (p.src_ip, p.dst_ip, p.src_port, p.dst_port, p.opcode, p.qpn,
            p.psn, bool(p.ack_req), p.vaddr, p.rkey, p.dma_len, p.ack_psn,
            p.msn, p.sack_bits, p.path_id, p.icrc, bool(p.dpi_flag),
            bool(p.ecn), p.coll_tag, p.coll_src, p.coll_nsrc, p.coll_frag,
            pay)


def snap_node(n):
    d = {}
    d["stats"] = dict(vars(n.stats))
    d["rx_tables"] = {f: _np(getattr(n.rx_tables, f)).copy()
                      for f in n.rx_tables._fields}
    d["npsn"] = list(n.qp.tables.npsn)
    d["retx_slots"] = {q: {psn: (_pkt_tuple(s.packet), s.deadline,
                                 s.retries)
                           for psn, s in slots.items()}
                       for q, slots in n.retx.slots.items()}
    d["retx_retrans"] = n.retx.retransmissions
    d["fc"] = (list(n.fc.budget), list(n.fc.outstanding),
               [len(q) for q in n.fc.pending], n.fc.total_passed)
    d["credits"] = (list(n.credits.credits), n.credits.accepted,
                    n.credits.granted, n.credits.dropped_no_credit,
                    list(n.credits.accepted_per_qp),
                    list(n.credits.dropped_per_qp))
    d["rx_progress"] = dict(n._rx_progress)
    d["completions"] = dict(n._completions)
    d["sr_pending_last"] = {k: list(v)
                            for k, v in n._sr_pending_last.items()}
    d["sr_pend"] = {k: dict(v) for k, v in n._sr_pend.items()}
    d["last_nak"] = dict(n._last_nak_resend)
    d["last_gap"] = dict(n._last_gap_resend)
    d["last_cnp"] = dict(n._last_cnp_sent)
    d["qp_errors"] = sorted(n.qp_errors)
    d["bufs"] = {q: bytes(b.tobytes())
                 for q, (_rk, b) in n._qp_buffer.items()}
    return d


def snap_net(net):
    d = {"now": net.now}
    if hasattr(net, "egress"):
        d["seq"] = net._seq
        d["injected"] = net.injected
        d["wire"] = sorted((a, s, dst, _pkt_tuple(p))
                           for a, s, dst, p in net._wire)
        d["rings"] = [[_pkt_tuple(p) for p, _m in eg._q]
                      for eg in net.egress]
        d["port_stats"] = [dict(vars(st_)) for st_ in net.port_stats]
    else:
        d["links"] = {
            k: {"seq": lk._seq, "sent": lk.sent, "dropped": lk.dropped,
                "heap": sorted((a, s, _pkt_tuple(p))
                               for a, s, p in lk._heap)}
            for k, lk in net.links.items()}
    return d


def snap(nodes):
    return {"nodes": [snap_node(n) for n in nodes],
            "net": snap_net(nodes[0].net)}


def diff(a, b, path=""):
    """Recursive structural diff; mismatch lines (empty == identical)."""
    out = []
    if isinstance(a, dict):
        for k in sorted(set(a) | set(b), key=repr):
            if k not in a:
                out.append(f"{path}.{k}: missing in oracle")
            elif k not in b:
                out.append(f"{path}.{k}: missing in fused")
            else:
                out += diff(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            out.append(f"{path}: len {len(a)} vs {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            out += diff(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        if not np.array_equal(a, b):
            idx = np.nonzero(a != b)[0][:5]
            out.append(f"{path}: arrays differ at {idx} "
                       f"a={a[idx]} b={b[idx]}")
    elif a != b:
        out.append(f"{path}: {a!r} vs {b!r}")
    return out
