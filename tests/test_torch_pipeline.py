"""The port's RX/TX engines against the JAX reference, on the CPU.

Randomized multi-QP traces (the generators of tests/test_fabric.py and
tests/test_multipath.py, copied here and extended with ECN marks and
rkey checks) go through the same engine of both packages, in both RX
modes.  Every table column and every ``RxResult`` field must be
bit-identical, padding lanes included.  Tables are cloned per engine
call, as the reference's donating engines require.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packet as jpk
from repro.core import pipeline as jpipe
from repro_torch.core import packet as pk
from repro_torch.core import pipeline as pipe

torch.set_num_threads(1)


def _random_trace(rng, n_qps, n_pkts):
    """A randomized multi-QP header trace with in-seq / dup / gap mix
    (tests/test_fabric.py), plus random CE marks and rkeys."""
    pkts, psn = [], {}
    for _ in range(n_pkts):
        q = int(rng.integers(0, n_qps))
        p0 = psn.get(q, 0)
        r = rng.random()
        if r < 0.6:
            use, psn[q] = p0, p0 + 1                 # in sequence
        elif r < 0.8:
            use = max(0, p0 - int(rng.integers(1, 3)))   # duplicate
        else:
            use = p0 + int(rng.integers(1, 3))           # gap -> NAK
        plen = int(rng.integers(1, 200))
        op = int(rng.choice([pk.WRITE_ONLY, pk.WRITE_FIRST,
                             pk.WRITE_MIDDLE, pk.WRITE_LAST,
                             pk.READ_RESP_ONLY, pk.ACK]))
        pkts.append(pk.Packet(opcode=op, qpn=q, psn=use,
                              payload=np.zeros(plen, np.uint8),
                              vaddr=int(rng.integers(0, 4096)),
                              rkey=int(rng.integers(0, 3)),
                              ecn=bool(rng.random() < 0.3),
                              ack_req=bool(rng.random() < 0.2),
                              dma_len=plen))
    return pkts


def _sr_trace(rng, n_pkts, n_qps=1, mtu=64):
    """A randomized out-of-order trace (tests/test_multipath.py):
    in-window shuffles, duplicates and occasional beyond-window jumps,
    every packet self-contained; spread over ``n_qps`` QPs."""
    order = np.arange(n_pkts)
    for i in range(0, n_pkts, 8):
        blk = order[i:i + 8].copy()
        rng.shuffle(blk)
        order[i:i + 8] = blk
    pkts = []
    for idx, psn in enumerate(order):
        psn = int(psn)
        r = rng.random()
        if r < 0.15 and idx > 0:                       # duplicate
            psn = int(order[int(rng.integers(0, idx))])
        elif r < 0.22:                                 # beyond-window jump
            psn = psn + pipe.SR_WINDOW + int(rng.integers(1, 5))
        plen = int(rng.integers(1, mtu + 1))
        op = int(rng.choice([pk.WRITE_ONLY, pk.WRITE_FIRST,
                             pk.WRITE_MIDDLE, pk.WRITE_LAST]))
        pkts.append(pk.Packet(opcode=op, qpn=int(rng.integers(0, n_qps)),
                              psn=psn, ack_req=bool(rng.random() < 0.2),
                              payload=np.zeros(plen, np.uint8),
                              rkey=int(rng.integers(0, 3)),
                              ecn=bool(rng.random() < 0.2),
                              vaddr=psn * mtu, dma_len=plen))
    return pkts


def _batch(pkts, mtu, pad):
    b = pk.batch_from_packets(pkts, mtu=mtu)
    if pad:                                # trailing invalid lanes
        for k, v in b.items():
            b[k] = np.concatenate([v, np.zeros((pad,) + v.shape[1:],
                                               v.dtype)])
        b["valid"][len(pkts):] = 0
    return b


def _tables(rng, n_qps, credits, sr):
    """Equal starting tables for both packages: random credits, some QPs
    armed with rkey 1 (the rest unarmed), random ePSN offsets."""
    cols = {f: np.zeros(n_qps, np.int32) for f in pipe.RxTables._fields}
    cols["credits"] = rng.integers(0, credits + 1, n_qps).astype(np.int32)
    cols["rkey"] = (rng.random(n_qps) < 0.5).astype(np.int32)
    cols["epsn"] = rng.integers(0, 2, n_qps).astype(np.int32)
    cols["sr"][:] = int(sr)
    jt = jpipe.RxTables(**{k: jnp.asarray(v) for k, v in cols.items()})
    tt = pipe.RxTables(**{k: torch.from_numpy(v.copy())
                          for k, v in cols.items()})
    return jt, tt


def _assert_same(jt, jr, tt, tr):
    for f in pipe.RxTables._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)),
                                      getattr(tt, f).numpy(),
                                      err_msg=f"tables.{f}")
        assert getattr(tt, f).dtype == torch.int32, f
    for f in pipe.RxResult._fields:
        want = np.asarray(getattr(jr, f))
        got = getattr(tr, f).numpy()
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(want, got, err_msg=f"result.{f}")


def _run_both(engine, jt, tt, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jt2, jr = jpipe.RX_ENGINES[engine](jpipe.clone_tables(jt), jb)
    tt2, tr = pipe.RX_ENGINES[engine](pipe.clone_tables(tt), batch)
    _assert_same(jt2, jr, tt2, tr)
    return tt2, tr


@pytest.mark.parametrize("engine", ["scan", "batched"])
@pytest.mark.parametrize("seed,n_qps,n_pkts,pad", [
    (0, 1, 17, 0), (1, 5, 48, 3), (2, 32, 60, 8), (3, 3, 96, 0)])
def test_go_back_n_engines_bit_identical(engine, seed, n_qps, n_pkts, pad):
    rng = np.random.default_rng(seed)
    batch = _batch(_random_trace(rng, n_qps, n_pkts), 256, pad)
    jt, tt = _tables(rng, n_qps, credits=6, sr=False)
    _run_both(engine, jt, tt, batch)


@pytest.mark.parametrize("engine", ["scan", "batched"])
@pytest.mark.parametrize("seed,n_qps,n_pkts,pad", [
    (10, 1, 40, 0), (11, 1, 80, 5), (12, 4, 64, 2)])
def test_selective_repeat_engines_bit_identical(engine, seed, n_qps, n_pkts,
                                                pad):
    rng = np.random.default_rng(seed)
    batch = _batch(_sr_trace(rng, n_pkts, n_qps), 64, pad)
    jt, tt = _tables(rng, n_qps, credits=64, sr=True)
    _run_both(engine, jt, tt, batch)


def test_engines_chain_across_batches():
    """State carried from one batch into the next stays identical (the
    batched engine returns new tables and leaves its input alone)."""
    rng = np.random.default_rng(21)
    jt, tt = _tables(rng, 6, credits=64, sr=False)
    for _ in range(3):
        batch = _batch(_random_trace(rng, 6, 40), 256, 4)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        before = pipe.clone_tables(tt)
        jt, jr = jpipe.rx_pipeline_batched(jt, jb)
        tt2, tr = pipe.rx_pipeline_batched(tt, batch)
        for f in pipe.RxTables._fields:
            assert torch.equal(getattr(tt, f), getattr(before, f))
        _assert_same(jt, jr, tt2, tr)
        tt = tt2


def test_scan_oracle_masks_out_of_range_qpns():
    """JAX clamps out-of-range gathers and drops out-of-range scatters;
    the port's scan oracle masks explicitly to the same effect."""
    rng = np.random.default_rng(5)
    pkts = _random_trace(rng, 4, 30)
    for p in pkts[::4]:
        p.qpn = 6                                  # past the 4-QP table
    batch = _batch(pkts, 256, 0)
    jt, tt = _tables(rng, 4, credits=8, sr=False)
    _run_both("scan", jt, tt, batch)


def test_header_columns_default_and_wrap():
    """Batches lacking the ECN / rkey columns default them to 0, and an
    int64 ``vaddr`` wraps to int32 as the reference's conversion does."""
    rng = np.random.default_rng(3)
    batch = _batch(_random_trace(rng, 3, 20), 256, 0)
    del batch["ecn"], batch["rkey"]
    batch["vaddr"] = batch["vaddr"] + np.int64(2**32 + 5)
    jt, tt = _tables(rng, 3, credits=64, sr=False)
    _run_both("batched", jt, tt, batch)


def test_popcount_and_logical_shift():
    """The SWAR popcount and the masked logical shift that replace JAX's
    ``population_count`` and ``shift_right_logical`` on int32, including
    negative lanes, where torch's ``>>`` would sign-extend."""
    rng = np.random.default_rng(0)
    x = rng.integers(-2**31, 2**31, 4000, dtype=np.int64).astype(np.int32)
    x[:4] = [0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    s = rng.integers(0, 32, x.size).astype(np.int32)
    got = pipe._popcount32(torch.from_numpy(x)).numpy()
    want = [bin(int(v) & 0xFFFFFFFF).count("1") for v in x]
    np.testing.assert_array_equal(got, want)
    got = pipe._srl32(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    want = (x.view(np.uint32) >> s.astype(np.uint32)).view(np.int32)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("seed,n_qps,n_cmds", [(0, 1, 5), (1, 7, 40),
                                               (2, 16, 60)])
def test_tx_engines_bit_identical(seed, n_qps, n_cmds):
    rng = np.random.default_rng(seed)
    qpn = rng.integers(0, n_qps, n_cmds).astype(np.int32)
    n_pkts = rng.integers(1, 9, n_cmds).astype(np.int32)
    npsn0 = rng.integers(pk.PSN_MASK - 20, pk.PSN_MASK + 1,
                         n_qps).astype(np.int32)   # wraps the PSN space
    jt0 = jpipe.TxTables(npsn=jnp.asarray(npsn0),
                         msn=jnp.zeros(n_qps, jnp.int32))
    jcmds = {"qpn": jnp.asarray(qpn), "n_pkts": jnp.asarray(n_pkts)}
    cmds = {"qpn": torch.from_numpy(qpn), "n_pkts": torch.from_numpy(n_pkts)}
    for engine in ("scan", "batched"):
        jt, jo = jpipe.TX_ENGINES[engine](jpipe.clone_tables(jt0), jcmds)
        tt, to = pipe.TX_ENGINES[engine](
            pipe.TxTables(npsn=torch.from_numpy(npsn0.copy()),
                          msn=torch.zeros(n_qps, dtype=torch.int32)), cmds)
        np.testing.assert_array_equal(np.asarray(jo["start_psn"]),
                                      to["start_psn"].numpy(), err_msg=engine)
        np.testing.assert_array_equal(np.asarray(jt.npsn), tt.npsn.numpy())
        np.testing.assert_array_equal(np.asarray(jt.msn), tt.msn.numpy())


def test_fresh_tables_match_reference():
    jt = jpipe.make_rx_tables(7, 5)
    tt = pipe.make_rx_tables(7, 5, device="cpu")
    for f in pipe.RxTables._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)),
                                      getattr(tt, f).numpy())
        assert getattr(tt, f).dtype == torch.int32
    assert pipe.RxTables._fields == jpipe.RxTables._fields
    assert pipe.RxResult._fields == jpipe.RxResult._fields
    assert pipe.COUNTER_FIELDS == jpipe.COUNTER_FIELDS
    assert pipe.SR_WINDOW == jpipe.SR_WINDOW
    assert jpk.PAYLOAD_OPS == pk.PAYLOAD_OPS
