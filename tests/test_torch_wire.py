"""The port's wire format and host-side modules against the JAX
reference, and the port's import boundary.

``repro_torch`` keeps its own copies of the reference's pure-numpy
modules (packet, qp, chaos, ...); these tests hold the copies equal:
opcodes and constants, ``Packet`` fields, ``fragment_message`` (with and
without ``addr_per_pkt``), ``batch_from_packets`` columns, the control
frames, and the chaos draws.  A subprocess imports every port module and
checks that neither ``jax`` nor ``repro`` was loaded.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import chaos as jchaos
from repro.core import packet as jpk
from repro.core import qp as jqp
from repro_torch.core import chaos
from repro_torch.core import packet as pk
from repro_torch.core import qp

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _packets_equal(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        da, db = dataclasses.asdict(p), dataclasses.asdict(q)
        pa, pb = da.pop("payload"), db.pop("payload")
        assert da == db
        if pa is None or pb is None:
            assert pa is None and pb is None
        else:
            assert pa.dtype == pb.dtype
            np.testing.assert_array_equal(pa, pb)


def test_opcodes_and_constants():
    names = [n for n in dir(jpk) if n.isupper()]
    assert names == [n for n in dir(pk) if n.isupper()]
    for n in names:
        assert getattr(pk, n) == getattr(jpk, n), n


def test_packet_fields():
    fa = [(f.name, f.default) for f in dataclasses.fields(jpk.Packet)]
    fb = [(f.name, f.default) for f in dataclasses.fields(pk.Packet)]
    assert fa == fb


@pytest.mark.parametrize("size,mtu,addr_per_pkt,op,coll", [
    (0, 4096, False, "write", None),
    (1, 4096, False, "write", None),
    (4096, 4096, False, "read_resp", None),
    (10_000, 4096, False, "write", (7, 1, 3, 4)),
    (10_000, 1024, True, "write", None),
    (5000, 256, True, "read_resp", (2, 0, 2, 0)),
])
def test_fragment_message(size, mtu, addr_per_pkt, op, coll):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8)
    args = (9, pk.PSN_MASK - 1, 4096, 77, data)          # PSN wraps
    kw = dict(op=op, mtu=mtu, src_ip=3, dst_ip=4, coll=coll,
              addr_per_pkt=addr_per_pkt)
    _packets_equal(pk.fragment_message(*args, **kw),
                   jpk.fragment_message(*args, **kw))


def test_batch_from_packets_columns():
    rng = np.random.default_rng(1)
    pkts = pk.fragment_message(3, 5, 128, 11,
                               rng.integers(0, 256, 3000, dtype=np.uint8),
                               mtu=512)
    pkts[1].ecn = True
    pkts.append(pk.make_ack(3, 7))
    jpkts = [jpk.Packet(**dataclasses.asdict(p)) for p in pkts]
    a, b = pk.batch_from_packets(pkts, 512), jpk.batch_from_packets(jpkts, 512)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_control_frames():
    pairs = [
        (pk.make_ack(5, pk.PSN_MASK + 3, msn=2, sack=0b1011),
         jpk.make_ack(5, pk.PSN_MASK + 3, msn=2, sack=0b1011)),
        (pk.make_ack(5, 9, nak=True), jpk.make_ack(5, 9, nak=True)),
        (pk.make_nak_prot(4, 12), jpk.make_nak_prot(4, 12)),
        (pk.make_cnp(6, src_ip=1, dst_ip=2, path_id=1),
         jpk.make_cnp(6, src_ip=1, dst_ip=2, path_id=1)),
        (pk.make_read_request(2, 3, 64, 9, 5000, 1, 2),
         jpk.make_read_request(2, 3, 64, 9, 5000, 1, 2)),
    ]
    _packets_equal([p for p, _ in pairs], [q for _, q in pairs])
    assert pk.read_resp_npkts(0) == jpk.read_resp_npkts(0) == 1
    assert pk.read_resp_npkts(8193, 4096) == jpk.read_resp_npkts(8193, 4096)
    data = np.arange(10, dtype=np.uint8)
    a = pk.fragment_message(1, 0, 0, 1, data)[0]
    c = a.clone()
    assert c.payload is not a.payload
    _packets_equal([c], [jpk.fragment_message(1, 0, 0, 1, data)[0].clone()])


def test_chaos_draws():
    rng = np.random.default_rng(2)
    for _ in range(200):
        seed, tag, tick, idx = (int(v) for v in rng.integers(0, 2**32, 4))
        tag %= 5
        assert chaos.hash32(seed, tag, tick, idx) == \
            jchaos.hash32(seed, tag, tick, idx)
        depth = int(rng.integers(0, 40))
        assert chaos.red_mark(seed, tick, idx, depth, 8, 24, 0.05) == \
            jchaos.red_mark(seed, tick, idx, depth, 8, 24, 0.05)
    for p in (0.0, 0.02, 0.5, 1.0, 1.5):
        assert chaos.u32_prob(p) == jchaos.u32_prob(p)
    assert chaos.link_stream(7, 1, 2) == jchaos.link_stream(7, 1, 2)
    np.testing.assert_array_equal(chaos.red_thresholds(8, 24, 0.05, 48),
                                  jchaos.red_thresholds(8, 24, 0.05, 48))


def test_qp_manager_tables():
    ops = [("register", 4096), ("create", (1, 4791)), ("connect", (1, 5, 2)),
           ("register", 100), ("create", (2, 4791)), ("reestablish", (1, 9)),
           ("destroy", 2)]
    mgrs = [qp.QPManager(8, 3), jqp.QPManager(8, 3)]
    for m in mgrs:
        for op, arg in ops:
            if op == "register":
                m.register_buffer(arg)
            elif op == "create":
                m.create_qp(*arg)
            elif op == "connect":
                m.connect(*arg)
            elif op == "reestablish":
                m.reestablish(*arg)
            else:
                m.destroy_qp(arg)
    a, b = mgrs[0].tables.as_dict(), mgrs[1].tables.as_dict()
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port loads no jax and no repro."""
    mods = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'repro' or "
              "m.startswith('repro.')]\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 17


def test_no_import_lines_of_jax_or_reference():
    """The port and chip_smoke.py carry no import of jax or repro."""
    pat = re.compile(
        r"^\s*(import jax|from jax|from repro(\.|\s)|import repro(\.|\s|$))")
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files if f.exists()
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits
