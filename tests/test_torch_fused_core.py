"""The port's fused epoch core (``repro_torch.core.fused`` and
``repro_torch.kernels.fused_epoch``) against the reference
(``repro.core.fused``) and against per-tick stepping, on the CPU.

* Packing: the same worlds, built in both packages from one numpy seed,
  pack to the same shape key and the same blob (``vec0``), word for
  word; both packages refuse the same unfusable worlds.
* The epoch: ``epoch_ref``'s output blob equals the reference's jitted
  ``make_epoch_fn(skey)(vec0)`` bit for bit on fixed worlds that share
  three shape keys (star with loss in both RX modes, star with ECN and
  a watermark exit, p2p spray in both RX modes, and a full wire's
  abort).
* The kernel's epoch body (csrc/fused_epoch.cu outside its CUDA block),
  compiled for the host with g++, against the plain version, in both
  residencies (the blob copied into the shared-memory buffer, or where
  it lies): every suite, ragged scan tails, two flows' timers in one
  tick, a gap resend of several rows, a full wire, and a world too wide
  for shared memory; the size rule that picks the residency; a bump
  that writes only its own plan row.
* Property suites (tests/test_fused_core.py's, port only): a fused epoch
  leaves the ENTIRE world bit-identical to stepping it per tick, and
  never silently falls back.
* The entry points: ``run_network(epoch_mode="fused")``,
  ``BALBOA_EPOCH_MODE``, the ingest's watermark micro-epochs, and the
  committed fused rows of BENCH_fig10_dlrm.json and
  BENCH_fig11_allreduce.json.

MTU 256, as tests/test_fused_core.py.  The reference's epoch compiles
once per shape key (several seconds each), so few keys are used.
"""
import copy
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _hyp import given, settings, st
import _fused_worlds as W

from repro.core import fused as jfused
from repro_torch.core import fused as tfused
from repro_torch.core import netsim as tnet
from repro_torch.core import rdma as trdma
from repro_torch.kernels import fused_epoch as fe

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = "repro.core", "repro_torch.core"


def _pair(suite, **kw):
    return W.build(REF, suite, **kw), W.build(PORT, suite, **kw)


def _epoch_ref(world):
    blob = torch.from_numpy(world.vec0.copy())
    fe.epoch_ref(blob, world.skey)
    return blob.numpy()


def _jax_epoch(world):
    return np.asarray(jfused.make_epoch_fn(world.skey)(
        jnp.asarray(world.vec0)))


def _same_blob(lay, got, want):
    bad = [n for n in lay.index
           if not np.array_equal(lay.get(got, n), lay.get(want, n))]
    assert not bad, f"fields differ: {bad}"


# ---------------------------------------------------------------------------
# the kernel's interface: field table, constants, launch parameters
# ---------------------------------------------------------------------------

def test_kernel_field_enum_and_constants_match_the_layout():
    """The CUDA source's ``Field`` enum lists ``FIELDS`` in order, every
    layout field is among them, and its opcode classes and constants are
    the port's."""
    src = (ROOT / "src/repro_torch/csrc/fused_epoch.cu").read_text()
    body = re.search(r"enum Field \{(.*?)NUM_FIELDS", src, re.S).group(1)
    enum = [t.strip().lower() for t in body.split(",") if t.strip()]
    assert tuple(enum) == fe.FIELDS
    for mode in ("star", "p2p"):
        skey = fe.ShapeKey(mode=mode, N=3, P=3 if mode == "star" else 0,
                           L=0 if mode == "star" else 2, G=3, F=4, PC=8,
                           CC=4, WCAP=64, RCAP=16, DEL=(3, 3, 3),
                           LDST=(), loss_on=True, ecn_on=True,
                           jit_on=False, reo_on=False, wm_on=False)
        lay = fe.layout_for(skey)
        assert set(lay.index) <= set(fe.FIELDS)
        prm = fe.params(skey)
        offs = prm[17:17 + len(fe.FIELDS)]
        for name, off in zip(fe.FIELDS, offs):
            assert off == (lay.index[name][0] if name in lay.index else -1)
        assert prm[16] == lay.size and prm[15] == 3
        assert prm.size == 17 + len(fe.FIELDS) + 2 * fe.MAX_G

    def ops(fn):
        m = re.search(rf"bool {fn}\(int op\) \{{(.*?)\}}", src, re.S)
        return {int(x, 16) for x in re.findall(r"0x[0-9A-F]+", m.group(1))}
    from repro_torch.core import packet as pk
    assert ops("payload_op") == set(pk.PAYLOAD_OPS)
    assert ops("reth_op") == set(pk.RETH_OPS)
    assert ops("last_op") == {pk.WRITE_LAST, pk.WRITE_ONLY,
                              pk.READ_RESP_LAST, pk.READ_RESP_ONLY}
    assert f"kMask = 0x{pk.PSN_MASK:08X}u" in src
    for name, val in (("kMaxRetries", fe.MAX_RETRIES),
                      ("kNakHoldoff", fe.NAK_HOLDOFF),
                      ("kCnpHoldoff", fe.CNP_HOLDOFF),
                      ("kSrWindow", fe.SR_WINDOW), ("kMaxG", fe.MAX_G)):
        assert f"{name} = {val};" in src


def test_layout_is_the_references():
    for mode in ("star", "p2p"):
        kw = dict(mode=mode, N=3, P=3 if mode == "star" else 0,
                  L=0 if mode == "star" else 2, G=3, F=4, PC=16, CC=4,
                  WCAP=128, RCAP=24, DEL=(3, 3, 3), LDST=(1, 0),
                  loss_on=True, ecn_on=False, jit_on=True, reo_on=False,
                  wm_on=True)
        assert fe.layout_for(fe.ShapeKey(**kw)).index == \
            jfused._layout_for(jfused.ShapeKey(**kw)).index


# ---------------------------------------------------------------------------
# packing against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suite", sorted(W.FIXED))
def test_vec0_matches_reference(suite):
    """The same world (star and p2p, go-back-N and selective repeat,
    loss, ECN, spray, jitter, reorder), packed mid-flight by both
    packages: equal shape keys and equal blobs."""
    a, b = _pair(suite, **W.FIXED[suite])
    wa = jfused.try_pack(a, 100_000, 8)
    wb = tfused.try_pack(b, 100_000, 8)
    assert dataclasses.asdict(wb.skey) == dataclasses.asdict(wa.skey)
    np.testing.assert_array_equal(wb.vec0, wa.vec0)
    # watermarks pack the same way (GBN only, as in the reference)
    rq = next(iter(a[0]._peer))
    wm = {(0, rq): 512}
    wa = jfused.try_pack(a, 50, 4, wm)
    wb = tfused.try_pack(b, 50, 4, wm)
    assert (wa is None) == (wb is None)
    if wa is not None:
        np.testing.assert_array_equal(wb.vec0, wa.vec0)


def _unfusable(pkg):
    """Worlds the fused core does not model, one per gate."""
    netsim = __import__(f"{pkg}.netsim", fromlist=["x"])
    rdma = __import__(f"{pkg}.rdma", fromlist=["x"])
    kw = {"device": "cpu"} if pkg == PORT else {}
    out = {}
    net = netsim.Network(2, netsim.LinkConfig(latency_ticks=2))
    a = rdma.RdmaNode(0, net, congestion_control="dcqcn", mtu=W.MTU, **kw)
    b = rdma.RdmaNode(1, net, congestion_control="dcqcn", mtu=W.MTU, **kw)
    q, _, _ = a.init_rdma(1 << 14, b)
    a.rdma_write(q, np.arange(900, dtype=np.uint8) % 251)
    out["dcqcn_rate"] = [a, b]
    nodes = W.build_p2p(pkg, 3)
    nodes[0].attach_recorder(object())
    out["recorder"] = nodes
    net = netsim.Network(2, netsim.LinkConfig(latency_ticks=2, loss_prob=0.1,
                                              seed=3))
    a = rdma.RdmaNode(0, net, mtu=W.MTU, **kw)
    b = rdma.RdmaNode(1, net, mtu=W.MTU, **kw)
    q, _, _ = a.init_rdma(1 << 14, b)
    a.rdma_write(q, np.arange(900, dtype=np.uint8) % 251)
    out["loss_without_chaos_seed"] = [a, b]
    net = netsim.Network(2, netsim.LinkConfig(latency_ticks=2))
    a = rdma.RdmaNode(0, net, mtu=W.MTU, **kw)
    b = rdma.RdmaNode(1, net, mtu=W.MTU, **kw)
    q, _, _ = a.init_rdma(1 << 14, b)
    a.rdma_read(q, 900)
    out["read_request_in_flight"] = [a, b]
    out["no_flows"] = [rdma.RdmaNode(0, netsim.Network(
        1, netsim.LinkConfig()), mtu=W.MTU, **kw)]
    return out


def test_unfusable_worlds_refused_by_both():
    ref, port = _unfusable(REF), _unfusable(PORT)
    for name in ref:
        assert jfused.try_pack(ref[name], 100, 8) is None, name
        assert tfused.try_pack(port[name], 100, 8) is None, name
        before = W.snap(port[name])
        assert tfused.run_fused_epoch(port[name]) is None, name
        assert not W.diff(before, W.snap(port[name])), name


# ---------------------------------------------------------------------------
# the epoch against the reference's jitted epoch, bit for bit
# ---------------------------------------------------------------------------

# (suite, world keywords, watermark): three shape keys in all — star
# with loss (both RX modes), star with ECN and an armed watermark (one
# never reached, one that ends the epoch), p2p spray (both RX modes)
_ECN = dict(seed=11, kmax=8, nbytes=3000, presteps=6)
JAX_WORLDS = [
    ("star_gbn_loss", dict(seed=7, loss=0.08, nbytes=2200, presteps=6), None),
    ("star_sr_loss", dict(seed=9, loss=0.08, nbytes=2200, presteps=5), None),
    ("star_ecn", _ECN, 1 << 30),
    ("star_ecn", {**_ECN, "presteps": 1}, 2900),
    ("p2p_gbn_spray", dict(seed=5, loss=0.08, reorder=0.25, jitter=3,
                           presteps=4, bw=3), None),
    ("p2p_sr_spray", dict(seed=13, loss=0.05, reorder=0.3, jitter=2,
                          presteps=5), None),
]


@pytest.mark.parametrize("i", range(len(JAX_WORLDS)))
def test_epoch_ref_matches_jax_epoch(i):
    suite, kw, wm = JAX_WORLDS[i]
    nodes = W.build(PORT, suite, **kw)
    wms = {(0, next(iter(nodes[0]._peer))): wm} if wm else None
    world = tfused.try_pack(nodes, 100_000, 8, wms)
    got, want = _epoch_ref(world), _jax_epoch(world)
    _same_blob(world.layout, got, want)
    lay = world.layout
    assert lay.get(got, "steps") > 1 and not lay.get(got, "abort")
    assert lay.get(got, "wm_hit") == int(wm == 2900)
    assert (lay.get(got, "idle") >= 8) == (wm != 2900)


def test_wire_overflow_abort_matches_jax_epoch():
    """A full wire: the first push takes slot 0 and sets ``abort``
    (``argmin`` of an all-valid ``w_valid``), and the epoch stops at the
    end of that tick — in both, bit for bit (on a blob whose every wire
    slot is held by a packet due far in the future, and a timer due
    now)."""
    nodes = W.build(PORT, "p2p_gbn_spray", **JAX_WORLDS[4][1])
    world = tfused.try_pack(nodes, 100_000, 8)
    c = world.layout.views(world.vec0)
    free = c["w_valid"] == 0
    c["w_arr"][free] = c["now"][0] + 10 ** 6
    c["w_valid"][:] = 1
    held = np.argwhere(c["p_held"] > 0)
    assert held.size
    c["p_dl"][tuple(held[0])] = 0
    got, want = _epoch_ref(world), _jax_epoch(world)
    _same_blob(world.layout, got, want)
    assert world.layout.get(got, "abort") == 1
    assert world.layout.get(got, "steps") == 1


def test_overflowing_world_returns_none_untouched():
    nodes = W.overflow_world(PORT)
    world = tfused.try_pack(nodes, 100_000, 8)
    out = _epoch_ref(world)
    assert world.layout.get(out, "abort") == 1
    before = W.snap(nodes)
    tfused.STATS.reset()
    assert tfused.run_fused_epoch(nodes) is None
    assert not W.diff(before, W.snap(nodes))
    assert tfused.STATS.snapshot() == {"epochs": 1, "ticks":
                                       world.layout.get(out, "steps"),
                                       "refusals": 0, "aborts": 1}


def test_wrapper_checks_and_max_ticks():
    world = tfused.try_pack(W.build(PORT, "star_ecn", **W.FIXED["star_ecn"]),
                            1, 8)
    out = _epoch_ref(world)
    assert world.layout.get(out, "steps") == 1
    blob = torch.from_numpy(world.vec0.copy())
    with pytest.raises(ValueError, match="int32"):
        fe.epoch_ref(blob.long(), world.skey)
    with pytest.raises(ValueError, match="layout"):
        fe.epoch_ref(blob[:-1].clone(), world.skey)
    with pytest.raises(ValueError, match="CUDA"):
        fe.fused_epoch_cuda(blob, world.skey)
    assert fe.fused_epoch_cuda.launches == 0


# the kernel's epoch body compiled for the host (everything outside the
# ``#ifdef __CUDACC__`` block of csrc/fused_epoch.cu is plain C++; its
# lane abstraction evaluates a step's 32 lanes in a loop), run through
# its own ``read_params`` / ``epoch_body`` on a copy of the blob, in
# either residency: the blob copied into the shared-memory buffer, or
# worked on where it lies
_HOST_RUNNER = """
#include <vector>
#include "fused_epoch.cu"
extern "C" int host_epoch(int* blob, const int* meta, int len, int resident) {
  Params prm;
  if (!read_params(&prm, meta, len)) return -1;
  std::vector<int> smem(smem_words(prm, resident != 0));
  return resident ? epoch_body<true>(blob, &prm, smem.data())
                  : epoch_body<false>(blob, &prm, smem.data());
}
extern "C" long host_smem_words(const int* meta, int len, int resident) {
  Params prm;
  if (!read_params(&prm, meta, len)) return -1;
  return smem_words(prm, resident != 0);
}
extern "C" int host_bump(int* blob, const int* meta, int len, int f, int row) {
  Params prm;
  if (!read_params(&prm, meta, len)) return -1;
  std::vector<int> smem(smem_words(prm, false));
  Epoch e;
  e.init(blob, &prm, smem.data());
  e.bump_send(f, row);
  e.finish();
  return e.faults();
}
"""
WHERE = ("shared", "global")
H100_SMEM = 232_448       # an H100 block's opt-in shared memory, bytes


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    import ctypes
    import shutil
    import subprocess
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("fused_epoch_host")
    (d / "runner.cpp").write_text(_HOST_RUNNER)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(ROOT / "src/repro_torch/csrc"),
                    "-o", str(d / "runner.so"), str(d / "runner.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(d / "runner.so"))
    lib.host_epoch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int]
    lib.host_epoch.restype = ctypes.c_int
    lib.host_smem_words.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
    lib.host_smem_words.restype = ctypes.c_long
    lib.host_bump.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.host_bump.restype = ctypes.c_int
    return lib


def _host_epoch(lib, world, where="shared", vec=None):
    """The host-built body's output blob; it must report no break of the
    lane discipline (a lane-wide step inside a lane-0 block, a tally
    also read as shared state)."""
    blob = (world.vec0 if vec is None else vec).copy()
    prm = fe.params(world.skey)
    assert lib.host_epoch(blob.ctypes.data, prm.ctypes.data, prm.size,
                          int(where == "shared")) == 0
    return blob


def _host_and_ref(lib, world, where):
    got, want = _host_epoch(lib, world, where), _epoch_ref(world)
    _same_blob(world.layout, got, want)
    return got


@pytest.mark.parametrize("where", WHERE)
def test_kernel_body_on_host_matches_epoch_ref(host_kernel, where):
    """csrc/fused_epoch.cu's epoch body, compiled for the host, against
    the plain version, bit for bit, with the blob resident in the
    shared-memory buffer and where it lies: random worlds of every
    property suite (some cut to 1 tick), a watermark exit and a full
    wire."""
    rng = np.random.default_rng(18)
    worlds = []
    for suite in sorted(W.SUITES):
        for _ in range(4):
            kw = {"seed": int(rng.integers(1, 2 ** 31)),
                  "presteps": int(rng.integers(0, 24))}
            if suite == "star_ecn":
                kw["kmax"] = int(rng.choice([6, 8, 12]))
            elif suite.startswith("star"):
                kw["loss"] = float(rng.choice([0.02, 0.08, 0.15]))
            else:
                kw.update(loss=float(rng.choice([0.02, 0.08])),
                          reorder=float(rng.choice([0.1, 0.3])),
                          jitter=int(rng.integers(1, 4)))
            worlds.append(tfused.try_pack(
                W.build(PORT, suite, **kw), int(rng.choice([1, 100_000])),
                8))
    nodes = W.build_star(PORT, 11, nbytes=3000, bw=2)
    worlds.append(tfused.try_pack(nodes, 100_000, 8,
                                  {(0, next(iter(nodes[0]._peer))): 512}))
    worlds.append(tfused.try_pack(W.overflow_world(PORT), 100_000, 8))
    for world in worlds:
        _same_blob(world.layout, _host_epoch(host_kernel, world, where),
                   _epoch_ref(world))
    last = worlds[-2:]
    assert last[0].layout.get(_epoch_ref(last[0]), "wm_hit") == 1
    assert last[1].layout.get(_epoch_ref(last[1]), "abort") == 1


def _reshape(world, *, WCAP, PC):
    """The world on another shape key: ``WCAP`` wire slots (the packed
    ones that are taken all lie below it; any new ones free) and ``PC``
    plan rows a flow (no fewer than packed; the new ones empty), every
    other word as packed."""
    skey = dataclasses.replace(world.skey, WCAP=WCAP, PC=PC)
    old, lay = world.layout, fe.layout_for(skey)
    assert PC >= world.skey.PC
    assert not old.get(world.vec0, "w_valid")[WCAP:].any()
    vec = np.zeros(lay.size, np.int32)
    for name, (off, shape, n) in lay.index.items():
        src = np.asarray(old.get(world.vec0, name))
        dst = vec[off:off + n].reshape(shape or (1,))
        if name.startswith("w_"):
            k = min(WCAP, src.size)
            dst[:k] = src[:k]
        elif name.startswith("p_"):
            dst[:, :src.shape[1]] = src
        else:
            dst[...] = src.reshape(dst.shape)
    return dataclasses.replace(world, skey=skey, layout=lay, vec0=vec)


@pytest.mark.parametrize("where", WHERE)
def test_kernel_body_scans_with_ragged_tails(host_kernel, where):
    """Wire and plan sizes that are not a multiple of the warp's 32
    lanes (WCAP 70, 27 and 17, PC 45, 19 and 23; F is 4 to 6), so
    every scan ends in a partial chunk: the free-slot search, the due
    slots, the timer rows flattened over flows, the ACK's release masks
    and the idle test.  The tight wires fill and abort in three of the
    fifteen."""
    aborts = 0
    for suite in sorted(W.FIXED):
        world = tfused.try_pack(W.build(PORT, suite, **W.FIXED[suite]),
                                100_000, 8)
        for wcap, pc in ((70, 45), (27, 19), (17, 23)):
            got = _host_and_ref(host_kernel,
                                _reshape(world, WCAP=wcap, PC=pc), where)
            aborts += fe.layout_for(dataclasses.replace(
                world.skey, WCAP=wcap, PC=pc)).get(got, "abort")
    assert aborts == 3


@pytest.mark.parametrize("where", WHERE)
def test_kernel_body_two_flows_timers_in_one_tick(host_kernel, where):
    """Two flows' retransmission timers fall due in the same tick: the
    rows are bumped in T_ORDER, then row order, as the oracle steps."""
    world = tfused.try_pack(W.build(PORT, "star_gbn_loss",
                                    **W.FIXED["star_gbn_loss"]), 1, 8)
    c = world.layout.views(world.vec0)
    held = np.argwhere(c["p_held"] > 0)
    flows = sorted({int(f) for f, _ in held})[:2]
    assert len(flows) == 2
    picked = [tuple(next(h for h in held if h[0] == f)) for f in flows]
    for f, row in picked:
        c["p_dl"][f, row] = c["now"][0] + 1
    got = _host_and_ref(host_kernel, world, where)
    lay = world.layout
    for f, row in picked:
        assert lay.get(got, "p_retr")[f, row] == c["p_retr"][f, row] + 1
    assert lay.get(got, "n_retx").sum() >= c["n_retx"].sum() + 2


@pytest.mark.parametrize("where", WHERE)
def test_kernel_body_gap_resend_bumps_several_rows(host_kernel, where):
    """One ACK whose SACK leaves a gap of several held rows: the gap's
    mask is taken once and each of its rows bumped, in row order (a
    p2p go-back-N world, the ACK put on the wire due next tick)."""
    world = tfused.try_pack(W.build(PORT, "p2p_gbn_spray",
                                    **W.FIXED["p2p_gbn_spray"]), 1, 8)
    c = world.layout.views(world.vec0)
    held = c["p_held"] > 0
    f = int(np.argmax(held.sum(1)))
    rows = np.flatnonzero(held[f])
    assert rows.size >= 3
    now = int(c["now"][0])
    ap = (int(c["f_base"][f]) + int(rows[0]) - 1) & fe.MASK
    link = int(c["f_lctrl"][f])
    slot = int(np.flatnonzero(c["w_valid"] == 0)[0])
    c["l_seq"][link] += 1
    for name, v in (("w_valid", 1), ("w_arr", now + 1),
                    ("w_seq", c["l_seq"][link]), ("w_dst", link),
                    ("w_flow", f), ("w_pidx", 0), ("w_kind", 1),
                    ("w_ap", ap), ("w_sack", 1 << 20)):
        c[name][slot] = v
    c["f_last_gap"][f] = fe.NEG
    got = _host_and_ref(host_kernel, world, where)
    lay = world.layout
    assert lay.get(got, "f_last_gap")[f] == now + 1
    bumped = lay.get(got, "p_retr")[f] > c["p_retr"][f]
    assert bumped.sum() >= 2


@pytest.mark.parametrize("where", WHERE)
def test_kernel_body_due_ties_pop_in_slot_order(host_kernel, where):
    """A link's wire packets due in one tick with equal (arrival, seq):
    they pop in slot order, as the oracle's stable sort leaves them (the
    kernel appends the due slots in slot order and ranks them)."""
    world = tfused.try_pack(W.build(PORT, "p2p_gbn_spray",
                                    **W.FIXED["p2p_gbn_spray"]), 1, 8)
    c = world.layout.views(world.vec0)
    valid = np.flatnonzero(c["w_valid"] > 0)
    link = c["w_dst"][valid[0]]
    tied = valid[c["w_dst"][valid] == link]
    assert len(tied) >= 3 and len(tied) <= world.skey.DEL[link]
    c["w_arr"][tied] = c["now"][0] + 1
    c["w_seq"][tied] = 7
    got = _host_and_ref(host_kernel, world, where)
    assert world.layout.get(got, "n_rx").sum() >= \
        c["n_rx"].sum() + len(tied)


@pytest.mark.parametrize("where", WHERE)
def test_kernel_body_zero_latency_links(host_kernel, where):
    """Links of latency 0 (a blob ``try_pack`` would not pack): a packet
    sent in a tick can be due on a later link in the same tick, so the
    kernel's one due scan a tick no longer holds and each link after such
    a send scans the wire again."""
    for seed in (5, 21, 33):
        world = tfused.try_pack(W.build(PORT, "p2p_gbn_spray", seed=seed,
                                        loss=0.05, reorder=0.3, jitter=2,
                                        presteps=4), 100_000, 8)
        world.layout.views(world.vec0)["l_lat"][:] = 0
        got = _host_and_ref(host_kernel, world, where)
        assert world.layout.get(got, "steps") > 1


@pytest.mark.parametrize("where", WHERE)
def test_kernel_body_full_wire_takes_slot_0(host_kernel, where):
    """Every wire slot taken: the first push finds no free slot in any
    chunk, takes slot 0 and sets ``abort``; the epoch stops that tick."""
    world = tfused.try_pack(W.build(PORT, "p2p_gbn_spray",
                                    **W.FIXED["p2p_gbn_spray"]), 100_000, 8)
    c = world.layout.views(world.vec0)
    c["w_arr"][c["w_valid"] == 0] = c["now"][0] + 10 ** 6
    c["w_valid"][:] = 1
    c["p_dl"][tuple(np.argwhere(c["p_held"] > 0)[0])] = 0
    got = _host_and_ref(host_kernel, world, where)
    assert world.layout.get(got, "abort") == 1
    assert world.layout.get(got, "steps") == 1
    assert world.layout.get(got, "w_seq")[0] != c["w_seq"][0]


def test_wide_world_runs_on_the_blob_in_device_memory(host_kernel):
    """A world whose blob and scratch exceed an H100 block's 227 KB of
    shared memory (40 flows, 128 plan rows a flow, more than 32 flows so
    the flow scans take two chunks): the wrapper's size rule picks the
    device-memory instantiation, whose body the host build runs against
    the plain version over the whole epoch (7,302 ticks: timeouts after
    quiet spells, when no row was held, test the timer bound)."""
    world = tfused.try_pack(W.wide_world(PORT), 100_000, 8)
    assert world.skey.F == 40 and world.skey.PC == 128
    assert 4 * world.layout.size > H100_SMEM
    assert fe.residency(world.skey, H100_SMEM) == "global"
    got = _host_and_ref(host_kernel, world, "global")
    lay = world.layout
    assert lay.get(got, "steps") > 1000 and lay.get(got, "idle") == 8
    assert lay.get(got, "n_retx").sum() > lay.get(world.vec0, "n_retx").sum()


def test_residency_by_size_matches_the_kernels_rule(host_kernel):
    """``smem_words`` is the kernel's ``smem_words`` (blob rounded up to
    16 bytes, then the scratch) in both residencies, and ``residency``
    keeps every suite's world in shared memory on an H100 and puts the
    wide world in device memory."""
    worlds = [tfused.try_pack(W.build(PORT, s, **W.FIXED[s]), 100_000, 8)
              for s in sorted(W.FIXED)]
    worlds.append(tfused.try_pack(W.wide_world(PORT), 100_000, 8))
    for world in worlds:
        prm = fe.params(world.skey)
        for resident in (True, False):
            assert fe.smem_words(world.skey, resident) == \
                host_kernel.host_smem_words(prm.ctypes.data, prm.size,
                                            int(resident))
        limit = 4 * fe.smem_words(world.skey, True)
        assert fe.residency(world.skey, limit) == "shared"
        assert fe.residency(world.skey, limit - 1) == "global"
    assert [fe.residency(w.skey, H100_SMEM) for w in worlds] == \
        ["shared"] * 5 + ["global"]


def test_bump_writes_only_its_own_plan_row(host_kernel):
    """What lets a scan take its mask before the rows it picks are
    bumped: ``bump_send`` (the kernel's, run alone on the host, and the
    plain version's) changes, of the plan rows, only its own row's
    ``p_retr`` and ``p_dl``, and the two agree on the whole blob."""
    world = tfused.try_pack(W.build(PORT, "star_gbn_loss",
                                    **W.FIXED["star_gbn_loss"]), 100_000, 8)
    lay = world.layout
    prm = fe.params(world.skey)
    held = np.argwhere(lay.get(world.vec0, "p_held") > 0)
    assert len(held) >= 4
    for f, row in held[::max(1, len(held) // 4)]:
        got = world.vec0.copy()
        assert host_kernel.host_bump(got.ctypes.data, prm.ctypes.data,
                                     prm.size, int(f), int(row)) == 0
        want = world.vec0.copy()
        fe._Epoch(want, world.skey).bump_send(int(f), int(row))
        _same_blob(lay, got, want)
        for name in ("p_op", "p_plen", "p_vaddr", "p_dlen", "p_ackreq",
                     "p_rkey", "p_held", "p_retr", "p_dl", "p_acc",
                     "p_aseq", "p_aaddr"):
            changed = np.argwhere(lay.get(got, name)
                                  != lay.get(world.vec0, name))
            if name in ("p_retr", "p_dl"):
                assert changed.tolist() == [[f, row]], name
            else:
                assert changed.size == 0, name


# ---------------------------------------------------------------------------
# property suites: fused epoch == per-tick stepping, whole world
# ---------------------------------------------------------------------------

def assert_fused_matches_oracle(nodes, max_ticks=100_000, idle_done=8,
                                watermarks=None):
    """One fused epoch on ``nodes`` and the same number of per-tick
    steps on a deep copy: the two worlds must be bit-identical, and the
    world must have fused (no silent fallback)."""
    oracle = copy.deepcopy(nodes)
    res = tfused.run_fused_epoch(nodes, max_ticks=max_ticks,
                                 idle_done=idle_done, watermarks=watermarks)
    assert res is not None, "schedule was expected to pack+fuse"
    for _ in range(res["steps"]):
        trdma.step_network(oracle)
    d = W.diff(W.snap(oracle), W.snap(nodes))
    assert not d, "fused epoch diverged from per-tick oracle:\n  " \
        + "\n  ".join(d[:40])
    return res


@settings(max_examples=5, deadline=None)
@given(st.integers(1, 2 ** 31), st.sampled_from([0.02, 0.08, 0.15]),
       st.integers(200, 3200), st.integers(0, 24), st.integers(0, 2))
def test_star_gbn_loss_bit_identical(seed, loss, nbytes, presteps,
                                     extra_qps):
    assert_fused_matches_oracle(W.build(
        PORT, "star_gbn_loss", seed=seed, loss=loss, nbytes=nbytes,
        presteps=presteps, extra_qps=extra_qps))


@settings(max_examples=5, deadline=None)
@given(st.integers(1, 2 ** 31), st.sampled_from([0.02, 0.1]),
       st.integers(200, 3200), st.integers(0, 24))
def test_star_sr_loss_bit_identical(seed, loss, nbytes, presteps):
    assert_fused_matches_oracle(W.build(
        PORT, "star_sr_loss", seed=seed, loss=loss, nbytes=nbytes,
        presteps=presteps))


@settings(max_examples=5, deadline=None)
@given(st.integers(1, 2 ** 31), st.sampled_from([6, 8, 12]),
       st.integers(500, 3200), st.integers(0, 16))
def test_star_ecn_thresholds_bit_identical(seed, kmax, nbytes, presteps):
    assert_fused_matches_oracle(W.build(
        PORT, "star_ecn", seed=seed, kmax=kmax, nbytes=nbytes,
        presteps=presteps))


@settings(max_examples=5, deadline=None)
@given(st.integers(1, 2 ** 31), st.sampled_from([0.02, 0.08]),
       st.sampled_from([0.1, 0.25]), st.integers(1, 3),
       st.integers(0, 24))
def test_p2p_gbn_spray_bit_identical(seed, loss, reorder, jitter,
                                     presteps):
    assert_fused_matches_oracle(W.build(
        PORT, "p2p_gbn_spray", seed=seed, loss=loss, reorder=reorder,
        jitter=jitter, presteps=presteps))


@settings(max_examples=5, deadline=None)
@given(st.integers(1, 2 ** 31), st.sampled_from([0.02, 0.08]),
       st.sampled_from([0.15, 0.3]), st.integers(1, 3),
       st.integers(0, 24))
def test_p2p_sr_spray_bit_identical(seed, loss, reorder, jitter,
                                    presteps):
    assert_fused_matches_oracle(W.build(
        PORT, "p2p_sr_spray", seed=seed, loss=loss, reorder=reorder,
        jitter=jitter, presteps=presteps))


@settings(max_examples=5, deadline=None)
@given(st.integers(1, 2 ** 31), st.sampled_from([2, 4, 6]),
       st.sampled_from([0.05, 0.15, 0.25]), st.integers(1500, 4000),
       st.integers(0, 10), st.sampled_from(["star_gbn_loss", "star_sr_loss",
                                            "p2p_gbn_spray"]))
def test_small_window_bit_identical(seed, window, loss, nbytes, presteps,
                                    suite):
    """Windows of a few packets under heavy loss: duplicate ACKs that
    release nothing still return one unit of budget (``max(n1 + n2,
    1)``), and queued chunks wait on the budget."""
    kw = {"reorder": 0.2, "jitter": 2} if suite.startswith("p2p") else {}
    assert_fused_matches_oracle(W.build(
        PORT, suite, seed=seed, window=window, loss=loss, nbytes=nbytes,
        presteps=presteps, **kw))


def test_zero_tick_roundtrip_is_identity():
    res = assert_fused_matches_oracle(
        W.build_star(PORT, 3), max_ticks=0)
    assert res["steps"] == 0 and not res["idle_exit"]


def test_epoch_runs_to_idle_exit():
    nodes = W.build_star(PORT, 5)
    res = assert_fused_matches_oracle(nodes)
    assert res["idle_exit"] and res["steps"] == res["ticks"] + 1
    for s in nodes[1:]:
        for sq, dst in s._peer.items():
            assert dst == 0 and s.retx.slots.get(sq, {}) == {}


def test_watermark_exit_partial_epoch():
    nodes = W.build_star(PORT, 11, nbytes=3000, bw=2)
    recv, snd = nodes[0], nodes[1]
    rq = next(iter(recv._peer))
    res = assert_fused_matches_oracle(nodes, watermarks={(0, rq): 512})
    assert res["wm_hit"] and not res["idle_exit"]
    assert recv.rx_progress(rq) >= 512
    assert any(snd.retx.slots.get(q) for q in snd._peer) \
        or any(len(p) for p in snd.fc.pending)


def test_engine_counter_contract_rides_the_blob():
    nodes = W.build_star(PORT, 23, loss=0.1, nbytes=2600)
    oracle = copy.deepcopy(nodes)
    res = tfused.run_fused_epoch(nodes)
    assert res is not None
    for _ in range(res["steps"]):
        trdma.step_network(oracle)
    for nd_o, nd_f in zip(oracle, nodes):
        assert nd_o.engine_totals() == nd_f.engine_totals()
        assert vars(nd_o.stats) == vars(nd_f.stats)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_run_network_fused_mode_equivalent(monkeypatch):
    """run_network in fused mode (by argument and by BALBOA_EPOCH_MODE)
    delivers the same bytes, stats and ticks as per-tick stepping, and
    ``fused.STATS`` counts its epochs."""
    results = {}
    for mode in ("tick", "fused", "env"):
        nodes = W.build_star(PORT, 17, loss=0.08, nbytes=2800)
        tfused.STATS.reset()
        if mode == "env":
            monkeypatch.setenv("BALBOA_EPOCH_MODE", "fused")
            t = trdma.run_network(nodes)
        else:
            t = trdma.run_network(nodes, epoch_mode=mode)
        results[mode] = (t, W.snap(nodes), tfused.STATS.epochs)
    assert results["tick"][0] == results["fused"][0] == results["env"][0]
    for mode in ("fused", "env"):
        d = W.diff(results["tick"][1], results[mode][1])
        assert not d, "run_network fused diverged:\n  " + "\n  ".join(d[:40])
        assert results[mode][2] >= 1
    assert results["tick"][2] == 0


def test_bench_fig11_fused_ring_row_reproduced():
    """BENCH_fig11_allreduce.json's ring row, in fused epochs
    (benchmarks/fig11_allreduce.py's fused arm): 66 ticks, busbw
    1489.45, in 6 fused epochs, bit-identical to the oracle."""
    from repro_torch.core.collectives import allreduce_oracle, make_ring_group
    want = next(r for r in json.loads(
        (ROOT / "BENCH_fig11_allreduce.json").read_text())["allreduce"]
        if r["mode"] == "ring")
    rng = np.random.default_rng(13)
    xs = [rng.standard_normal(16_384).astype(np.float32) for _ in range(4)]
    tfused.STATS.reset()
    g = make_ring_group(4, 16_384 * 4 + 16, fabric_cfg=tnet.FabricConfig(
        port_bandwidth=4, port_delay=2, queue_capacity=48, seed=7),
        epoch_mode="fused", device="cpu")
    out = g.allreduce(xs)
    oracle = allreduce_oracle(xs)
    for o in out:
        np.testing.assert_array_equal(o.view(np.uint8), oracle.view(np.uint8))
    nbytes = 16_384 * 4
    assert g.stats.ticks == want["ticks"] == 66
    assert round(2 * 3 / 4 * nbytes / g.stats.ticks, 2) == \
        want["busbw_B_per_tick"]
    assert tfused.STATS.snapshot() == {"epochs": 6, "ticks": 66,
                                       "refusals": 0, "aborts": 0}


def _shard_fn(n_pkts):
    from repro_torch.data import synthetic as syn
    return lambda i: syn.encode_dlrm_packets(
        syn.dlrm_shard(i, 26 * n_pkts, 13, 26))


def _stream(n_pkts, replicas, epoch_mode, **kw):
    from repro_torch.core import ingest as ting
    ing = ting.BalboaIngest(
        ting.IngestConfig(batch_bytes=n_pkts * 4096,
                          n_storage_nodes=replicas, link_bw_pkts_per_tick=1,
                          tile_pkts=2, epoch_mode=epoch_mode, **kw),
        None, _shard_fn(n_pkts),
        tile_to_batch=ting.make_dlrm_tile_decoder(13, 26, 100_000),
        device="cpu")
    batch, rep = ing.fetch_shard_streaming(0)
    return ing, batch, rep


def test_bench_fig10_streamed_fused_row_reproduced():
    """BENCH_fig10_dlrm.json's ``streamed_fused`` r4 row (16 ticks,
    overlap 0.75, 16 tiles).  At its window (64 packets a QP) every world
    overflows the wire's bucket or holds a READ request, so the
    reference's gate refuses every epoch and the row runs on per-tick
    steps; the port refuses the same 16 worlds."""
    rows = json.loads((ROOT / "BENCH_fig10_dlrm.json").read_text())["ingest"]
    tfused.STATS.reset()
    ing, _, rep = _stream(rows["n_pkts"], 4, "fused")
    got = {"ticks": rep.ticks, "nbytes": rep.nbytes,
           "goodput": rep.goodput_bytes_per_tick,
           "overlap": rep.overlap_efficiency, "tiles": rep.tiles,
           "stripes": len(rep.stripes), "host_bytes": ing.host_payload_bytes}
    assert got == {k: rows["streamed_fused"]["4"][k] for k in got}
    assert tfused.STATS.snapshot() == {"epochs": 0, "ticks": 0,
                                       "refusals": 16, "aborts": 0}


def test_ingest_watermark_micro_epochs_match_tick():
    """At a window of 16 the ingest's worlds fuse: the stream advances in
    watermark-bounded micro-epochs (one per tile boundary) and lands the
    same bytes, tiles, ticks and events as per-tick stepping."""
    out = {}
    for mode in ("tick", "fused"):
        tfused.STATS.reset()
        _, batch, rep = _stream(16, 2, mode, fc_window=16)
        out[mode] = (rep.ticks, rep.tiles, rep.overlap_efficiency,
                     rep.events, batch["dense"].numpy().tobytes(),
                     batch["sparse"].numpy().tobytes(),
                     tfused.STATS.epochs)
    assert out["tick"][:-1] == out["fused"][:-1]
    assert out["fused"][-1] > 0 and out["tick"][-1] == 0
