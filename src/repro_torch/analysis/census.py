"""Host-sync census: count, per simulated tick, how often the port's data
plane crosses between host and device.

The reference (``repro.analysis.census``) counts JAX's transfer calls;
this counts the port's own call sites:

* D2H — ``Tensor.cpu``, ``Tensor.numpy``, ``Tensor.item``,
  ``Tensor.tolist``, the scalar reads ``int()``/``float()``/``bool()``/
  ``operator.index`` of a tensor, and ``Tensor.to`` from the card to
  the host;
* H2D — ``Tensor.to`` of host memory onto a device, and
  ``torch.as_tensor`` with a device.  ``repro_torch.device.to_device``
  (every caller hands it a numpy array) is one ``torch.as_tensor``
  without a device, which marks a host tensor, and one ``Tensor.to``
  of it, which counts; its count goes to the caller's line.

It counts **calls, whatever the device**, so a run on the CPU gives the
counts a run on the card would: a tensor made from host memory
(``torch.from_numpy``, ``torch.as_tensor``/``torch.tensor`` without a
device, the result of a counted ``.cpu()``) is a host tensor, and
reading one back is not a sync; every other tensor is taken to live on
the run's device.  A kernel's plain version (a ``*_ref`` function of
``repro_torch/kernels``), which the CPU runs where the card runs the
kernel, counts nothing.  What the two runs can still see differently:
``.to`` of a tensor made from a host tensor by further ops (a device
move on the card, a no-op on the CPU), and what a kernel's wrapper
copies up on the card (its constant tables, once a process).
``sites`` names every counted call site, so two runs' counts can be
told apart site by site.  Counting only: values pass through
untouched.

Workloads mirror the reference's fig benches at smoke scale, each in
per-tick and fused-epoch mode; the ticks equal
``BENCH_sync_census.json``'s:

* ``fig6``  — 4:1 incast through the drop-tail switch (batched
  engine), counted over the ``step_network`` drain loop only;
* ``fig10`` — streamed DLRM ingest, 2 replicas, counted over
  ``fetch_shard_streaming``;
* ``fig11`` — 3-node ring allreduce, counted over ``allreduce``.
"""
from __future__ import annotations

import collections
import contextlib
import sys
import weakref
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.analysis.violations import relpath
from repro_torch.device import DeviceLike, resolve_device

_HERE = Path(__file__).resolve()
_PORT = _HERE.parents[1]
_DEVICE_PY = Path(_device.__file__).resolve()
_KERNELS = _PORT / "kernels"
_TORCH = Path(torch.__file__).resolve().parent
_MISSING = object()

# Tensor methods that read a value back to the host
_READS = ("cpu", "numpy", "item", "tolist",
          "__int__", "__float__", "__bool__", "__index__")


class SyncCounter:
    def __init__(self):
        self.d2h = 0
        self.h2d = 0
        self.sites: Dict[str, collections.Counter] = {
            "d2h": collections.Counter(), "h2d": collections.Counter()}


def _in_plain_version(f) -> bool:
    """True when a kernel's plain version is on the stack above ``f``."""
    while f is not None:
        if f.f_code.co_name.endswith("_ref") \
                and Path(f.f_code.co_filename).parent == _KERNELS:
            return True
        f = f.f_back
    return False


def _site(f) -> str:
    """``path:line (function)`` of the nearest frame from ``f`` up in the
    port outside this module and ``to_device``, else the nearest frame
    outside torch and this module."""
    fallback = None
    while f is not None:
        p = Path(f.f_code.co_filename)
        if p not in (_HERE, _DEVICE_PY) and _TORCH not in p.parents:
            if _PORT in p.parents:
                return f"{relpath(p)}:{f.f_lineno} ({f.f_code.co_name})"
            if fallback is None:
                fallback = f"{relpath(p)}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return fallback or "<unknown>"


def _target(args, kwargs) -> Optional[torch.device]:
    """The device a ``Tensor.to`` call moves to, or None (a dtype-only
    conversion)."""
    d = kwargs.get("device")
    if d is None and args:
        a0 = args[0]
        if isinstance(a0, (str, torch.device)):
            d = a0
        elif isinstance(a0, torch.Tensor):
            d = a0.device
        elif isinstance(a0, int) and not isinstance(a0, bool):
            d = a0
    return None if d is None else torch.device(d)


@contextlib.contextmanager
def sync_census():
    """Count host<->device transfers while the body runs (see the module
    docstring for what counts)."""
    c = SyncCounter()
    host: Dict[int, weakref.ref] = {}   # tensors that live in host memory

    def count(kind: str):
        f = sys._getframe(2)
        if _in_plain_version(f):
            return
        setattr(c, kind, getattr(c, kind) + 1)
        c.sites[kind][_site(f)] += 1

    def mark(t):
        if isinstance(t, torch.Tensor) and id(t) not in host:
            i = id(t)
            host[i] = weakref.ref(t, lambda _r, i=i: host.pop(i, None))
        return t

    def on_host(t) -> bool:
        r = host.get(id(t))
        return r is not None and r() is t

    T = torch.Tensor
    saved = {n: T.__dict__.get(n, _MISSING) for n in _READS + ("to",)}
    orig = {n: getattr(T, n) for n in _READS + ("to",)}
    saved_fns = {n: getattr(torch, n)
                 for n in ("from_numpy", "as_tensor", "tensor")}

    def reader(name):
        fn = orig[name]

        def read(t, *a, **k):
            if not on_host(t):
                count("d2h")
            out = fn(t, *a, **k)
            if name != "cpu":
                return out
            # on the CPU .cpu() hands the tensor itself back; a view of
            # it (same storage, as the alias was) is the host copy, and
            # the tensor stays a device tensor of the run
            return mark(out.view_as(out) if out is t else out)
        return read

    def to(t, *a, **k):
        dest = _target(a, k)
        out = orig["to"](t, *a, **k)
        if dest is None:
            return mark(out) if on_host(t) else out
        if on_host(t) or (t.device.type == "cpu" and dest.type != "cpu"):
            count("h2d")
        elif dest.type == "cpu" and t.device.type != "cpu":
            count("d2h")
            mark(out)                   # a copy: never the tensor itself
        return out

    def from_numpy(a):
        return mark(saved_fns["from_numpy"](a))

    def as_tensor(data, *a, **k):
        out = saved_fns["as_tensor"](data, *a, **k)
        if isinstance(data, torch.Tensor):
            return out
        if k.get("device") is not None or len(a) >= 2:
            count("h2d")
            return out
        return mark(out)

    def tensor(data, *a, **k):
        out = saved_fns["tensor"](data, *a, **k)
        return out if k.get("device") is not None else mark(out)

    for n in _READS:
        setattr(T, n, reader(n))
    T.to = to
    torch.from_numpy, torch.as_tensor, torch.tensor = (from_numpy, as_tensor,
                                                       tensor)
    try:
        yield c
    finally:
        for n, f in saved_fns.items():
            setattr(torch, n, f)
        for n, f in saved.items():
            if f is _MISSING:
                delattr(T, n)
            else:
                setattr(T, n, f)


def _result(c: SyncCounter, ticks: int) -> Dict:
    ticks = max(int(ticks), 1)
    return {"ticks": int(ticks), "d2h": int(c.d2h), "h2d": int(c.h2d),
            "d2h_per_tick": round(c.d2h / ticks, 4),
            "h2d_per_tick": round(c.h2d / ticks, 4),
            "sites": {k: dict(sorted(v.items()))
                      for k, v in c.sites.items()}}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# --------------------------------------------------------------------------
# per-fig workloads (fixed seeds, smoke scale)
# --------------------------------------------------------------------------

# benchmarks/fig10_dlrm.py's workload constants (the port imports
# nothing of the benchmarks)
N_DENSE, N_SPARSE, MOD = 13, 26, 100_000
REC_W = N_DENSE + N_SPARSE
MTU = 4096
RPP = (MTU // 4) // REC_W


def _shard_fn(n_pkts: int):
    from repro_torch.data import synthetic as syn
    return lambda i: syn.encode_dlrm_packets(
        syn.dlrm_shard(i, RPP * n_pkts, N_DENSE, N_SPARSE))


def census_fig6(n_senders: int = 4, message_bytes: int = 32768,
                engine: str = "batched", epoch_mode: Optional[str] = None,
                device: DeviceLike = None) -> Dict:
    """One epoch of ``step_network`` over a drop-tail incast — the
    canonical fig6 congestion workload, counted over the drain loop
    only (setup transfers like table creation are not the tick loop's
    debt).  ``epoch_mode='fused'`` drives the same world through
    ``run_network``'s fused epochs instead of per-tick stepping."""
    from repro_torch.core import netsim
    from repro_torch.core.rdma import (RdmaNode, network_pending,
                                       run_network, step_network)

    dev = resolve_device(device)
    cfg = netsim.FabricConfig(port_bandwidth=4, port_delay=2,
                              queue_capacity=32, seed=7)
    fabric = netsim.SwitchedFabric(n_senders + 1, cfg)
    recv = RdmaNode(0, fabric, rx_credits=64, engine=engine, device=dev)
    senders = [RdmaNode(i + 1, fabric, fc_window=16, engine=engine,
                        device=dev) for i in range(n_senders)]
    rng = np.random.default_rng(13)
    for s in senders:
        qpn, _, _ = s.init_rdma(message_bytes, recv)
        s.rdma_write(qpn, rng.integers(0, 256, message_bytes,
                                       dtype=np.uint8))
    nodes = [recv] + senders
    t0 = fabric.now
    with sync_census() as c:
        if epoch_mode:
            run_network(nodes, max_ticks=100_000, epoch_mode=epoch_mode)
        else:
            while network_pending(nodes) and fabric.now - t0 < 100_000:
                step_network(nodes)
        _sync(dev)
    return _result(c, fabric.now - t0)


def census_fig10(n_pkts: int = 8, n_replicas: int = 2, tile_pkts: int = 2,
                 epoch_mode: Optional[str] = None,
                 device: DeviceLike = None) -> Dict:
    """One streamed DLRM shard fetch (fig10's streaming arm).
    ``epoch_mode='fused'`` turns the per-tick advance inside the stream
    loop into watermark-bounded fused micro-epochs."""
    from repro_torch.core.ingest import (BalboaIngest, IngestConfig,
                                         make_dlrm_tile_decoder)

    dev = resolve_device(device)
    ing = BalboaIngest(
        IngestConfig(batch_bytes=n_pkts * MTU, n_storage_nodes=n_replicas,
                     link_bw_pkts_per_tick=1, tile_pkts=tile_pkts,
                     epoch_mode=epoch_mode),
        None, _shard_fn(n_pkts),
        tile_to_batch=make_dlrm_tile_decoder(N_DENSE, N_SPARSE, MOD),
        device=dev)
    with sync_census() as c:
        batch, rep = ing.fetch_shard_streaming(0)
        _sync(dev)
    return _result(c, rep.ticks)


def census_fig11(world: int = 3, n_elems: int = 256,
                 epoch_mode: Optional[str] = None,
                 device: DeviceLike = None) -> Dict:
    """One ring allreduce over the transport (fig11's ring arm)."""
    from repro_torch.core.collectives import make_ring_group

    dev = resolve_device(device)
    g = make_ring_group(world, max_bytes=n_elems * 4 + world * 4,
                        epoch_mode=epoch_mode, device=dev)
    rng = np.random.default_rng(17)
    xs = [rng.standard_normal(n_elems).astype(np.float32)
          for _ in range(world)]
    t0 = g.net.now
    with sync_census() as c:
        g.allreduce(xs)
        _sync(dev)
    return _result(c, g.net.now - t0)


def run_census(device: DeviceLike = None) -> Dict:
    """The full census document (``BENCH_sync_census.json``'s shape, each
    workload with its ``sites``) on ``device`` (default the card).  Each
    fig workload is counted twice: the per-tick arm and the fused-epoch
    arm."""
    dev = resolve_device(device)
    return {"mode": "smoke", "device": str(dev),
            "census": {
                "fig6": census_fig6(device=dev),
                "fig6_fused": census_fig6(epoch_mode="fused", device=dev),
                "fig10": census_fig10(device=dev),
                "fig10_fused": census_fig10(epoch_mode="fused", device=dev),
                "fig11": census_fig11(device=dev),
                "fig11_fused": census_fig11(epoch_mode="fused",
                                            device=dev)}}
