"""The port's §8 streaming ingest and its preprocessing kernel against
the JAX reference, on the CPU.

The same numpy-seeded records go through ``repro`` and ``repro_torch``:

  * the preprocessing's plain version (which a CPU tensor dispatches to)
    against ``repro.kernels.ref.preproc_ref`` and ``preproc_pallas`` in
    interpret mode: sparse words exact (negatives, INT32_MIN and
    INT32_MAX included), dense words within 1 ulp, the worst printed —
    ``log1p`` is not bit-identical across the two libraries;
  * ``PreprocService`` against the reference's service, trailing words
    passed through untouched;
  * the streamed fetch: the report (ticks, tiles, overlap, refetches),
    the ``events`` list and the landed arrays, lossless, under loss,
    with a short final tile over odd striping, with a replica dying
    mid-stream, and with the preprocessing on-path;
  * the synchronous plane's ``host_payload_bytes`` and the committed
    ``BENCH_fig10_dlrm.json`` rows, exactly.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ingest as jing
from repro.core import services as jsvc
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import ingest as ting
from repro_torch.core import services as tsvc
from repro_torch.core.rdma import step_network
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_DENSE, N_SPARSE, MOD = 13, 26, 1000
REC_W = N_DENSE + N_SPARSE
RPP = (4096 // 4) // REC_W            # records per packet
MTU = 4096


def _recs(seed, m, n_dense=N_DENSE, rec_w=REC_W):
    """Raw records with the full int32 range in the sparse words."""
    rng = np.random.default_rng(seed)
    recs = rng.integers(-2**31, 2**31, (m, rec_w), dtype=np.int64)
    recs[:, :n_dense] = rng.integers(-100, 100_000, (m, n_dense))
    recs[0, n_dense:n_dense + 4] = (-2**31, 2**31 - 1, -1, -MOD)
    return recs.astype(np.int32)


def _check_records(got, want, n_dense=N_DENSE, what=""):
    """Sparse words exact, dense float32 bit patterns within 1 ulp
    (non-negative floats: the ulp distance is the bit-pattern distance).
    Prints the worst ulp and how many words differ."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got[:, n_dense:], want[:, n_dense:])
    d = np.abs(got[:, :n_dense].astype(np.int64)
               - want[:, :n_dense].astype(np.int64))
    worst = int(d.max()) if d.size else 0
    print(f"{what} dense: worst {worst} ulp, {int((d > 0).sum())} of "
          f"{d.size} words differ")
    assert worst <= 1


def _landed_records(batch):
    """A landed batch as the (M, rec_w) int32 record matrix."""
    dense = np.asarray(batch["dense"], np.float32).view(np.int32)
    return np.concatenate([dense, np.asarray(batch["sparse"])], axis=1)


# ---------------------------------------------------------------------------
# the preprocessing kernel's plain version and the service
# ---------------------------------------------------------------------------

def test_synthetic_records_are_the_references():
    for i in (0, 3):
        np.testing.assert_array_equal(syn.dlrm_shard(i, 100),
                                      jsyn.dlrm_shard(i, 100))
        recs = syn.dlrm_shard(i, 60)
        np.testing.assert_array_equal(syn.encode_dlrm_packets(recs),
                                      jsyn.encode_dlrm_packets(recs))
        np.testing.assert_array_equal(syn.dlrm_labels(recs, 13, MOD),
                                      jsyn.dlrm_labels(recs, 13, MOD))


@pytest.mark.parametrize("m,n_dense,rec_w,modulus",
                         [(1, 13, 39, 1000), (52, 13, 39, 100_000),
                          (700, 13, 39, 7), (97, 3, 8, 100)])
def test_preproc_matches_reference(m, n_dense, rec_w, modulus):
    recs = _recs(m, m, n_dense, rec_w)
    got = ops.preproc(torch.from_numpy(recs.copy()), n_dense, modulus)
    assert got.dtype == torch.int32 and not got.is_cuda
    j = jnp.asarray(recs)
    _check_records(got.numpy(), jref.preproc_ref(j, n_dense, modulus),
                   n_dense, "vs preproc_ref")
    _check_records(got.numpy(),
                   jops.preproc(j, n_dense, modulus, impl="pallas"),
                   n_dense, "vs preproc_pallas")
    # the floor-mod: the sign follows the divisor, exactly as numpy's %
    np.testing.assert_array_equal(got.numpy()[:, n_dense:],
                                  recs[:, n_dense:] % modulus)


def test_preproc_negative_modulus_and_zero():
    recs = _recs(2, 40)
    for mod in (-7, -1):
        got = ops.preproc(torch.from_numpy(recs.copy()), 13, mod)
        _check_records(got.numpy(),
                       jref.preproc_ref(jnp.asarray(recs), 13, mod),
                       what=f"modulus {mod}")
        np.testing.assert_array_equal(got.numpy()[:, 13:],
                                      recs[:, 13:] % mod)
    with pytest.raises(ValueError, match="modulus"):
        ops.preproc(torch.from_numpy(recs), 13, 0)


def test_preproc_tile_and_packet_rows_match_one_shot():
    """The tile entry needs no padding, and the packet-strided form the
    tile decoder uses (whole records at the head of each packet, read
    through the packet stride) gives the one-shot result row for row."""
    recs = _recs(4, 3 * RPP)
    want = ops.preproc(torch.from_numpy(recs.copy()), 13, MOD)
    tiles = [ops.preproc_tile(torch.from_numpy(recs[lo:lo + 32].copy()), 13,
                              MOD, tile_recs=32)
             for lo in range(0, len(recs), 32)]
    assert torch.equal(torch.cat(tiles), want)
    pkts = np.frombuffer(syn.encode_dlrm_packets(recs).tobytes(),
                         np.int32).reshape(3, MTU // 4)
    words = torch.from_numpy(pkts.copy())[:, :RPP * REC_W]
    assert not words.is_contiguous()
    assert torch.equal(ops.preproc(words, 13, MOD, rec_w=REC_W), want)
    with pytest.raises(ValueError, match="tile_recs"):
        ops.preproc_tile(torch.from_numpy(recs), 13, MOD, tile_recs=32)
    with pytest.raises(ValueError, match="whole number"):
        ops.preproc(words, 13, MOD, rec_w=40)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_preproc_service_matches_reference(use_pallas):
    """Whole packets through the on-path service: the records rewritten,
    the 10 words past the 26th record passed through untouched."""
    rng = np.random.default_rng(8)
    pay = rng.integers(0, 256, (5, MTU), dtype=np.uint8)
    plen = np.full(5, MTU, np.int32)
    j = jsvc.PreprocService(n_dense=13, n_sparse=26, modulus=MOD,
                            use_pallas=use_pallas)(jnp.asarray(pay),
                                                   jnp.asarray(plen))
    t = tsvc.PreprocService(n_dense=13, n_sparse=26, modulus=MOD,
                            device="cpu")(torch.from_numpy(pay.copy()),
                                          torch.from_numpy(plen))
    assert t.dtype == torch.uint8 and t.shape == pay.shape
    tw = t.numpy().view(np.int32)
    _check_records(tw[:, :RPP * REC_W].reshape(-1, REC_W),
                   np.asarray(j).view(np.int32)[:, :RPP * REC_W]
                   .reshape(-1, REC_W), what="PreprocService")
    np.testing.assert_array_equal(tw[:, RPP * REC_W:],
                                  pay.view(np.int32)[:, RPP * REC_W:])


# ---------------------------------------------------------------------------
# the streamed fetch against the reference
# ---------------------------------------------------------------------------

def _shard_fn(n_pkts):
    return lambda i: syn.encode_dlrm_packets(
        syn.dlrm_shard(i, RPP * n_pkts, N_DENSE, N_SPARSE))


def _pair(cfg_kw, n_pkts, onpath=False):
    """The same ingest built in both packages."""
    jchain = tchain = None
    if onpath:
        jchain = jsvc.ServiceChain(on_path=[jsvc.PreprocService(
            n_dense=N_DENSE, n_sparse=N_SPARSE, modulus=MOD)])
        tchain = tsvc.ServiceChain(on_path=[tsvc.PreprocService(
            n_dense=N_DENSE, n_sparse=N_SPARSE, modulus=MOD, device="cpu")])
    mod = None if onpath else MOD
    j = jing.BalboaIngest(
        jing.IngestConfig(batch_bytes=n_pkts * MTU, **cfg_kw), jchain,
        _shard_fn(n_pkts),
        tile_to_batch=jing.make_dlrm_tile_decoder(N_DENSE, N_SPARSE, mod))
    t = ting.BalboaIngest(
        ting.IngestConfig(batch_bytes=n_pkts * MTU, **cfg_kw), tchain,
        _shard_fn(n_pkts),
        tile_to_batch=ting.make_dlrm_tile_decoder(N_DENSE, N_SPARSE, mod),
        decode_fn=_poison, device="cpu")
    return j, t


def _poison(raw):
    raise AssertionError("decode_fn touched payload bytes on the host")


def _report(rep):
    return dict(index=rep.index, nbytes=rep.nbytes, ticks=rep.ticks,
                transport_done_tick=rep.transport_done_tick, tiles=rep.tiles,
                tiles_overlapped=rep.tiles_overlapped,
                refetches=rep.refetches, events=rep.events,
                stripes=[(s.sid, s.pkt_start, s.n_pkts, s.nbytes, s.node,
                          s.resume, s.tiles_emitted, s.refetches, s.attempts,
                          s.done) for s in rep.stripes],
                ledgers={k: v.snapshot() for k, v in rep.ledgers.items()})


STREAM_CASES = {
    "lossless": (dict(n_storage_nodes=2, tile_pkts=2), 16, 3),
    "loss": (dict(n_storage_nodes=2, tile_pkts=2, loss_prob=0.2), 12, 4),
    "short_final_tile_odd_striping": (dict(n_storage_nodes=2, tile_pkts=2),
                                      7, 11),
    "striped_4x2_shaped": (dict(n_storage_nodes=4, qps_per_node=2,
                                tile_pkts=2, link_bw_pkts_per_tick=1), 20, 0),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streamed_fetch_matches_reference(case):
    cfg_kw, n_pkts, index = STREAM_CASES[case]
    j, t = _pair(cfg_kw, n_pkts)
    jb, jrep = j.fetch_shard_streaming(index)
    tb, trep = t.fetch_shard_streaming(index)
    assert _report(trep) == _report(jrep)
    assert set(tb) == {"dense", "sparse"}
    assert tb["dense"].dtype == torch.float32
    assert tb["sparse"].dtype == torch.int32
    _check_records(_landed_records(tb), _landed_records(jb), what=case)
    # and both equal the one-shot oracle on the raw records
    raw = syn.dlrm_shard(index, RPP * n_pkts, N_DENSE, N_SPARSE)
    _check_records(_landed_records(tb)[:len(raw)],
                   jref.preproc_ref(jnp.asarray(raw), N_DENSE, MOD),
                   what=f"{case} vs one-shot")
    assert t.host_payload_bytes == 0
    if case == "short_final_tile_odd_striping":
        assert [s.n_pkts for s in trep.stripes] == [4, 3]
    if case == "loss":
        nodes = [t.trainer] + [s.node for s in t.storage]
        assert sum(n.stats.retransmissions + n.stats.ooo_nak
                   for n in nodes) > 0, "no loss hit the stream"


def test_onpath_preproc_stream_matches_reference():
    j, t = _pair(dict(n_storage_nodes=2, tile_pkts=2), 8, onpath=True)
    jb, jrep = j.fetch_shard_streaming(3)
    tb, trep = t.fetch_shard_streaming(3)
    assert _report(trep) == _report(jrep)
    _check_records(_landed_records(tb), _landed_records(jb), what="on-path")
    # the same bytes as the tile-decoder arm, bit for bit
    _, t2 = _pair(dict(n_storage_nodes=2, tile_pkts=2), 8)
    tb2, _ = t2.fetch_shard_streaming(3)
    np.testing.assert_array_equal(_landed_records(tb), _landed_records(tb2))


def _kill_node0_at(ing, when, clear=False):
    dead = ing.storage[0].node

    def kill(t):
        if t == when:
            for (src, dst), link in ing.net.links.items():
                if src == dead.node_id:
                    link.cfg.loss_prob = 1.0
                    if clear:
                        link._heap.clear()
    return kill


@pytest.mark.parametrize("when,clear", [(3, False), (12, True)])
def test_midstream_replica_death_matches_reference(when, clear):
    """A replica dies mid-stream: only its stripe refetches, resuming at
    the last emitted tile, and the port does exactly what the reference
    does, tick for tick."""
    cfg_kw = dict(n_storage_nodes=2, link_bw_pkts_per_tick=1, tile_pkts=2,
                  stall_ticks=150)
    j, t = _pair(cfg_kw, 16)
    tiles, reps = {}, {}
    for name, ing in (("jax", j), ("torch", t)):
        ing.trainer.retx.MAX_RETRIES = 2
        ing.trainer.retx.timeout = 20
        got = tiles[name] = {}

        def consume(stripe, tidx, dev, nv, got=got):
            got[(stripe.sid, tidx)] = (np.asarray(dev), nv, stripe.pkt_start)
        reps[name] = ing.stream_shard(
            7, consume, on_tick=_kill_node0_at(ing, when, clear))
    assert _report(reps["torch"]) == _report(reps["jax"])
    by_sid = {s.sid: s for s in reps["torch"].stripes}
    assert reps["torch"].refetches == 1
    assert by_sid[0].refetches == 1 and by_sid[0].attempts == (0, 1)
    assert by_sid[1].refetches == 0 and by_sid[1].attempts == (1,)
    if clear:
        assert by_sid[0].resume > 0 and by_sid[0].resume % (2 * MTU) == 0
    jt, tt = tiles["jax"], tiles["torch"]
    assert sorted(jt) == sorted(tt)
    out = np.zeros(16 * MTU, np.uint8)
    for key, (arr, nv, pkt_start) in tt.items():
        np.testing.assert_array_equal(arr, jt[key][0])
        lo = (pkt_start + key[1] * 2) * MTU
        out[lo:lo + nv * MTU] = arr.reshape(-1)[:nv * MTU]
    np.testing.assert_array_equal(out, _shard_fn(16)(7))
    assert t.host_payload_bytes == 0


def test_sync_plane_counts_host_copies():
    """The store-and-forward baseline: the host decode copy is exactly
    what ``host_payload_bytes`` counts, as in the reference."""
    n_pkts = 4
    decode = lambda raw: {"raw": np.frombuffer(raw.tobytes(),  # noqa: E731
                                               np.uint8).copy()}
    j = jing.BalboaIngest(jing.IngestConfig(batch_bytes=n_pkts * MTU,
                                            n_storage_nodes=2),
                          None, _shard_fn(n_pkts), decode_fn=decode)
    t = ting.BalboaIngest(ting.IngestConfig(batch_bytes=n_pkts * MTU,
                                            n_storage_nodes=2),
                          None, _shard_fn(n_pkts), decode_fn=decode,
                          device="cpu")
    jg, tg = j.fetch_shard(6), t.fetch_shard(6)
    np.testing.assert_array_equal(tg["raw"].numpy(), np.asarray(jg["raw"]))
    np.testing.assert_array_equal(tg["raw"].numpy(), _shard_fn(n_pkts)(6))
    assert t.host_payload_bytes == j.host_payload_bytes == n_pkts * MTU
    assert t.snapshot() == j.snapshot()
    assert [b["raw"].shape for b in t.batches(2)] == [(n_pkts * MTU,)] * 2


def test_bench_fig10_rows_reproduced():
    """BENCH_fig10_dlrm.json's smoke rows with benchmarks/fig10_dlrm.py's
    settings (sync baseline, streamed over 1 and 4 replicas), exactly."""
    rows = json.loads((ROOT / "BENCH_fig10_dlrm.json").read_text())["ingest"]
    n_pkts = rows["n_pkts"]
    nbytes = n_pkts * MTU
    ing = ting.BalboaIngest(
        ting.IngestConfig(batch_bytes=nbytes, n_storage_nodes=1,
                          link_bw_pkts_per_tick=1),
        None, _shard_fn(n_pkts), decode_fn=lambda raw: {}, device="cpu")
    qp, st = ing.qps[0], ing.storage[0]
    st.load_shard(st.node._qp_buffer[qp.qpn_r][1], 0)
    t0 = ing.net.now
    ing.trainer.rdma_read(qp.qpn_l, nbytes)
    while ing.trainer.rx_progress(qp.qpn_l) < nbytes:
        step_network([ing.trainer, st.node])
    ing.host_payload_bytes += nbytes
    assert {"ticks": ing.net.now - t0, "host_bytes": ing.host_payload_bytes,
            "goodput": nbytes / (ing.net.now - t0)} == \
        {k: rows["sync"][k] for k in ("ticks", "host_bytes", "goodput")}
    for r in ("1", "4"):
        ing = ting.BalboaIngest(
            ting.IngestConfig(batch_bytes=nbytes, n_storage_nodes=int(r),
                              link_bw_pkts_per_tick=1, tile_pkts=2),
            None, _shard_fn(n_pkts),
            tile_to_batch=ting.make_dlrm_tile_decoder(13, 26, 100_000),
            device="cpu")
        _, rep = ing.fetch_shard_streaming(0)
        got = {"ticks": rep.ticks, "nbytes": rep.nbytes,
               "goodput": rep.goodput_bytes_per_tick,
               "overlap": rep.overlap_efficiency, "tiles": rep.tiles,
               "stripes": len(rep.stripes),
               "host_bytes": ing.host_payload_bytes}
        assert got == {k: rows["streamed"][r][k] for k in got}, r


# ---------------------------------------------------------------------------
# what is not ported, and the device rule
# ---------------------------------------------------------------------------

def test_fused_epochs_shardings_and_the_card_rule(monkeypatch):
    monkeypatch.setenv("BALBOA_EPOCH_MODE", "fused")
    cfg = ting.IngestConfig(batch_bytes=4 * MTU)
    ing = ting.BalboaIngest(cfg, None, _shard_fn(4), device="cpu")
    assert ing.cfg.epoch_mode is None      # read when the stream advances
    ting.BalboaIngest(ting.IngestConfig(epoch_mode="fused"), None,
                      _shard_fn(4), device="cpu")
    with pytest.raises(ValueError, match="epoch_mode"):
        ting.BalboaIngest(ting.IngestConfig(epoch_mode="epoch"), None,
                          _shard_fn(4), device="cpu")
    with pytest.raises(TypeError, match="shardings"):
        ting.BalboaIngest(cfg, None, _shard_fn(4), shardings={"dense": 0},
                          device="cpu")
    with pytest.raises(ValueError, match="tile_to_batch"):
        ing.fetch_shard_streaming(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ting.BalboaIngest(cfg, None, _shard_fn(4))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ting.DeviceLandingZone({})


def test_landing_zone_places_in_place_and_refuses_overflow():
    zone = ting.DeviceLandingZone({"x": ((6, 2), torch.int32)},
                                  device="cpu")
    buf = zone.bufs["x"]
    zone.place("x", torch.ones((2, 2), dtype=torch.int32), 4)
    assert zone.arrays()["x"] is buf                 # no reallocation
    assert buf[:, 0].tolist() == [0, 0, 0, 0, 1, 1]
    with pytest.raises(ValueError, match="outside"):
        zone.place("x", torch.ones((2, 2), dtype=torch.int32), 5)


def test_duplicate_read_fault_is_the_references():
    """A fault of the reference, kept bit for bit: two QPs share one
    storage node's shaped link, the second QP's READ response queues
    behind the first's 32-packet burst, the trainer's retransmit timer
    re-sends its READ_REQUEST, and the responder serves the READ a
    second time under fresh PSNs.  The duplicate stream is still in
    flight when the next shard's READ is issued, so the shard after
    next lands the previous shard's bytes on that QP.  Port and
    reference deliver the same (stale) bytes, tick for tick."""
    n_pkts = 64
    kw = dict(batch_bytes=n_pkts * MTU, n_storage_nodes=1, qps_per_node=2,
              tile_pkts=2, link_bw_pkts_per_tick=1)
    j = jing.BalboaIngest(jing.IngestConfig(**kw), None, _shard_fn(n_pkts),
                          tile_to_batch=lambda t: {"b": t})
    t = ting.BalboaIngest(ting.IngestConfig(**kw), None, _shard_fn(n_pkts),
                          tile_to_batch=lambda t: {"b": t}, device="cpu")
    stale = []
    for i in range(3):
        jb, jrep = j.fetch_shard_streaming(i)
        tb, trep = t.fetch_shard_streaming(i)
        assert _report(trep) == _report(jrep)
        got = tb["b"].numpy().reshape(n_pkts, MTU)
        np.testing.assert_array_equal(got, np.asarray(jb["b"]).reshape(
            n_pkts, MTU))
        bad = (got != _shard_fn(n_pkts)(i).reshape(n_pkts, MTU)).any(1)
        stale.append(int(bad.sum()))
        if bad.any():
            prev = _shard_fn(n_pkts)(i - 1).reshape(n_pkts, MTU)
            np.testing.assert_array_equal(got[bad], prev[bad])
    assert stale == [0, 0, 32]
    assert t.trainer.stats.retransmissions == j.trainer.stats.retransmissions
    assert t.trainer.stats.retransmissions > 0
