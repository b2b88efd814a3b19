"""The port's collectives and its segmented-reduce kernel against the JAX
reference, on the CPU.

The same numpy-seeded tensors go through ``repro`` and ``repro_torch``:

  * the fold's plain version (which a CPU tensor dispatches to) against
    ``repro.kernels.reduce``'s oracle and Pallas kernel (interpret
    mode), bit for bit: float32 and int32, K in {1, 2, 3, 8}, NaN, +-inf,
    -0.0 and int32 overflow;
  * ring and offloaded allreduce, reduce-scatter, allgather and tree
    broadcast: outputs bit-identical to the reference's, with equal tick
    counts and switch-reducer statistics, on a lossless and a lossy
    fabric;
  * the committed ``BENCH_fig11_allreduce.json`` 4-node rows, exactly.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collectives as jcol
from repro.core.netsim import FabricConfig as JFabricConfig
from repro.kernels import ops as jops
from repro.kernels import reduce as jred
from repro_torch.core import collectives as tcol
from repro_torch.core.netsim import FabricConfig, SwitchedFabric
from repro_torch.kernels import ops

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSSY = dict(port_bandwidth=4, port_delay=2, queue_capacity=48,
             loss_prob=0.05, seed=21)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _fold_inputs(k, lanes, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        x = rng.standard_normal((k, lanes)).astype(np.float32)
        x[0, :6] = [np.nan, np.inf, -np.inf, -0.0, 3e38, -0.0]
        x[-1, :6] = [1.0, 1.0, 5.0, -0.0, 3e38, 0.0]
        return x
    x = rng.integers(-2**31, 2**31, (k, lanes), dtype=np.int64)
    x[:, 0] = 2**31 - 1                         # overflows for k >= 2
    return x.astype(np.int32)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_chunk_reduce_matches_reference(k, dtype):
    x = _fold_inputs(k, 1000, dtype, seed=k)
    u8 = np.ascontiguousarray(x).view(np.uint8)              # (k, 4000)
    got = ops.chunk_reduce(torch.from_numpy(u8.copy()), dtype=dtype)
    assert got.dtype == torch.uint8 and got.shape == (u8.shape[1],)
    for impl in ("ref", "pallas"):
        want = jops.chunk_reduce(jnp.asarray(u8), dtype=dtype, impl=impl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=impl)
    fold = ops.reduce_fold(torch.from_numpy(x.copy()))
    np.testing.assert_array_equal(
        _bits(fold.numpy()), _bits(jred.reduce_fold_pallas(jnp.asarray(x))))
    if dtype == "int32" and k >= 2:
        assert fold[0] != 2**31 - 1                         # it wrapped


def test_fold_order_is_pinned():
    """Row order is the contract: reversing the rows changes float32
    bits, and the port follows the reference either way."""
    x = np.array([[1.0], [1e8], [-1e8]], np.float32)
    u8 = x.view(np.uint8)
    for rows in (u8, u8[::-1].copy()):
        np.testing.assert_array_equal(
            ops.chunk_reduce(torch.from_numpy(rows.copy())).numpy(),
            np.asarray(jops.chunk_reduce(jnp.asarray(rows), impl="ref")))
    a = ops.chunk_reduce(torch.from_numpy(u8.copy())).numpy()
    b = ops.chunk_reduce(torch.from_numpy(u8[::-1].copy())).numpy()
    assert not np.array_equal(a, b)
    with pytest.raises(ValueError, match="dtype"):
        ops.chunk_reduce(torch.from_numpy(u8.copy()), dtype="float16")


def _tensors(world, n_elems, seed=7, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return [rng.standard_normal(n_elems).astype(dtype)
                for _ in range(world)]
    return [rng.integers(-2**31, 2**31, n_elems, dtype=np.int64)
            .astype(dtype) for _ in range(world)]


def _groups(world, max_bytes, **kw):
    fab = kw.pop("fabric", None)
    j = jcol.make_ring_group(
        world, max_bytes, fabric_cfg=JFabricConfig(**fab) if fab else None,
        **kw)
    t = tcol.make_ring_group(
        world, max_bytes, fabric_cfg=FabricConfig(**fab) if fab else None,
        device="cpu", **kw)
    return j, t


def _same_run(j, t):
    assert t.stats.snapshot() == j.stats.snapshot()
    assert t.snapshot() == j.snapshot()
    assert [n.snapshot() for n in t.nodes] == [n.snapshot() for n in j.nodes]


@pytest.mark.parametrize("world,offload,n_elems",
                         [(2, False, 1002), (4, False, 1004), (4, True, 1004),
                          (8, True, 1008), (3, True, 5)])
def test_allreduce_matches_reference(world, offload, n_elems):
    xs = _tensors(world, n_elems, seed=world)
    j, t = _groups(world, 1 << 16, offload=offload)
    jo, to = j.allreduce(xs), t.allreduce(xs)
    oracle = tcol.allreduce_oracle(xs)
    np.testing.assert_array_equal(_bits(oracle),
                                  _bits(jcol.allreduce_oracle(xs)))
    for r in range(world):
        np.testing.assert_array_equal(_bits(to[r]), _bits(jo[r]))
        np.testing.assert_array_equal(_bits(to[r]), _bits(oracle))
    _same_run(j, t)
    if offload:
        assert t.service.reducer.absorbed > 0


@pytest.mark.parametrize("offload", [False, True])
def test_allreduce_lossy_fabric_matches_reference(offload):
    xs = _tensors(4, 20_000, seed=3)
    j, t = _groups(4, 1 << 18, offload=offload, fabric=LOSSY)
    jo, to = j.allreduce(xs), t.allreduce(xs)
    assert sum(n.stats.retransmissions for n in t.nodes) > 0, \
        "lossy fabric produced no retransmissions — test is vacuous"
    for r in range(4):
        np.testing.assert_array_equal(_bits(to[r]), _bits(jo[r]))
    np.testing.assert_array_equal(_bits(to[0]),
                                  _bits(tcol.allreduce_oracle(xs)))
    _same_run(j, t)


def test_int32_allreduce_wraps_like_a_plain_sum():
    xs = _tensors(3, 777, dtype=np.int32)
    j, t = _groups(3, 1 << 14, dtype="int32", offload=False)
    jo, to = j.allreduce(xs), t.allreduce(xs)
    with np.errstate(over="ignore"):
        want = np.sum(xs, axis=0, dtype=np.int32)
    for r in range(3):
        np.testing.assert_array_equal(to[r], jo[r])
        np.testing.assert_array_equal(to[r], want)
    np.testing.assert_array_equal(tcol.allreduce_oracle(xs, "int32"), want)


def test_reduce_scatter_allgather_broadcast_match_reference():
    xs = _tensors(4, 1002, seed=9)
    for offload in (False, True):
        j, t = _groups(4, 1 << 14, offload=offload)
        for a, b in zip(t.reduce_scatter(xs), j.reduce_scatter(xs)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        _same_run(j, t)
    shards = _tensors(4, 251, seed=13)
    j, t = _groups(4, 1 << 14)
    for a, b in zip(t.allgather(shards), j.allgather(shards)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    _same_run(j, t)
    x = np.random.default_rng(1).standard_normal((17, 9)).astype(np.float32)
    j, t = _groups(5, 1 << 12, fabric=dict(LOSSY, loss_prob=0.15))
    to, jo = t.broadcast(x, root=4), j.broadcast(x, root=4)
    assert all(np.array_equal(_bits(a), _bits(x)) for a in to)
    assert [a.shape for a in to] == [a.shape for a in jo]
    _same_run(j, t)


def test_bench_fig11_rows_reproduced():
    """BENCH_fig11_allreduce.json's 4-node smoke rows (ring and offload on
    benchmarks/fig11_allreduce.py's base fabric, numpy seed 13),
    exactly, and bit-identical to the oracle."""
    rows = json.loads((ROOT / "BENCH_fig11_allreduce.json").read_text())
    base = FabricConfig(port_bandwidth=4, port_delay=2, queue_capacity=48,
                        seed=7)
    for want in rows["allreduce"]:
        world, nbytes = want["world"], want["message_bytes"]
        rng = np.random.default_rng(13)
        xs = [rng.standard_normal(nbytes // 4).astype(np.float32)
              for _ in range(world)]
        offload = want["mode"] == "offload"
        g = tcol.make_ring_group(world, nbytes + world * 4, fabric_cfg=base,
                                 offload=offload, device="cpu")
        out = g.allreduce(xs)
        oracle = tcol.allreduce_oracle(xs)
        assert all(np.array_equal(_bits(o), _bits(oracle)) for o in out)
        ticks = g.stats.ticks
        got = {"world": world, "message_bytes": nbytes, "mode": want["mode"],
               "cc": "ack_clocked", "lossy": False, "ticks": ticks,
               "algbw_B_per_tick": round(nbytes / ticks, 2),
               "busbw_B_per_tick": round(2 * (world - 1) / world * nbytes
                                         / ticks, 2),
               "retransmissions": sum(n.stats.retransmissions
                                      for n in g.nodes),
               "tail_dropped": g.net.total_tail_dropped}
        if offload:
            red = g.service.reducer
            got.update(switch_absorbed=red.absorbed,
                       switch_forwarded=red.reduced_forwarded,
                       switch_acks=red.acks_synthesized,
                       switch_naks=red.naks_synthesized,
                       switch_peak_slots=red.peak_slots)
        assert got == want


def test_offload_service_control_plane_and_the_card_rule(monkeypatch):
    fab = SwitchedFabric(2, FabricConfig())
    svc = tcol.AllreduceService(fab, dtype="float32", device="cpu")
    assert "absorbed=0" in svc.describe()
    with pytest.raises(RuntimeError, match="already has a reducer"):
        tcol.AllreduceService(fab, dtype="int32", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        tcol.AllreduceService(SwitchedFabric(2, FabricConfig()),
                              dtype="float16", device="cpu")
    g = tcol.make_ring_group(2, 1 << 10, device="cpu")
    with pytest.raises(ValueError):
        g.allreduce([np.zeros(3, np.float32), np.zeros(4, np.float32)])
    with pytest.raises(ValueError):
        g.allreduce([np.zeros(1 << 12, np.float32)] * 2)
    with pytest.raises(ValueError):
        tcol.CollectiveGroup(g.nodes[:1], 1024)
    monkeypatch.setenv("BALBOA_EPOCH_MODE", "fused")
    # None defers to the environment when the network runs, as in the
    # reference; an explicit unknown mode is refused up front
    assert tcol.make_ring_group(2, 1 << 10, device="cpu").epoch_mode is None
    assert tcol.make_ring_group(2, 1 << 10, epoch_mode="fused",
                                device="cpu").epoch_mode == "fused"
    with pytest.raises(ValueError, match="epoch_mode"):
        tcol.make_ring_group(2, 1 << 10, epoch_mode="epoch", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcol.make_ring_group(2, 1 << 10)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcol.AllreduceService(SwitchedFabric(2, FabricConfig()))
