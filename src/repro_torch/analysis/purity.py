"""Trace-purity pass: what the reference's jaxpr walk becomes in PyTorch.

The reference traces every jitted data-plane entry point to a jaxpr
(``repro.analysis.purity``).  The port's entry points are eager PyTorch,
so this pass traces each one with ``torch._dynamo`` (``backend="eager"``,
``fullgraph=True``: nothing is compiled, so no C compiler is needed) on
small fixed-seed arguments on the CPU, and reports:

* ``graph-break`` — every place the trace leaves the graph, with
  dynamo's reason (a host read, a data-dependent branch, a call it
  cannot trace).  When the ``fullgraph`` trace fails, the breaks are
  enumerated with ``torch._dynamo.explain``, which traces on past each
  one.  This is the inventory a CUDA-graph capture of the engines
  starts from;
* ``f64-promotion`` — any float64 tensor in a captured graph;
* ``host-sync`` — the entry's calls that read a value back from the
  device (counted by ``census.sync_census`` while the entry runs);
* ``concretization`` — tracing raised an error that is not a graph
  break.

``host-callback`` and ``missing-donation`` have no meaning for an eager
entry (see ``violations.RULES``) and emit nothing.

The registry below IS the inventory of the port's data-plane entry
points: both RX engines in both rx modes, both TX engines, and the
plain versions of the kernels' wrappers (what a trace of the wrapper
sees on the host; the kernels themselves are CUDA and outside dynamo).
"""
from __future__ import annotations

import dataclasses
import inspect
import logging
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.violations import Violation, relpath

CPU = torch.device("cpu")


@dataclasses.dataclass
class EntryPoint:
    """One data-plane entry: ``fn(*args())`` must trace."""
    name: str
    fn: Callable
    args: Callable[[], Tuple[tuple, dict]]
    site: Optional[Callable] = None   # def site to report (when fn wraps)


def _def_site(fn: Callable) -> Tuple[str, int]:
    target = inspect.unwrap(fn)
    try:
        path = inspect.getsourcefile(target) or "<unknown>"
        _, line = inspect.getsourcelines(target)
    except (OSError, TypeError):
        return "<unknown>", 0
    return relpath(path), line


# --------------------------------------------------------------------------
# entry-point registry (small, fixed-seed example arguments, on the CPU)
# --------------------------------------------------------------------------

def _rx_args(sr: int):
    def build():
        from repro_torch.core import packet as pk
        from repro_torch.core import pipeline as pipe
        tables = pipe.make_rx_tables(4, device=CPU)
        if sr:
            tables = tables._replace(sr=torch.ones(4, dtype=torch.int32))
        pkts = [pk.Packet(opcode=pk.WRITE_ONLY, qpn=q, psn=0, dma_len=64,
                          payload=np.zeros(64, np.uint8), ack_req=True)
                for q in range(4)]
        batch = {k: v for k, v in pk.batch_from_packets(pkts).items()
                 if k != "payload"}
        return (tables, batch), {}
    return build


def _tx_args():
    from repro_torch.core import pipeline as pipe
    tables = pipe.make_tx_tables(4, device=CPU)
    cmds = {"qpn": torch.tensor([0, 1, 2, 3], dtype=torch.int32),
            "n_pkts": torch.tensor([2, 1, 3, 1], dtype=torch.int32)}
    return (tables, cmds), {}


def _payload(n=4, mtu=4096):
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, 256, (n, mtu), dtype=np.uint8))


def _round_keys():
    from repro_torch.kernels.ref import expand_key
    rng = np.random.default_rng(5)
    return expand_key(rng.integers(0, 256, 16, dtype=np.uint8))


def _dpi_params():
    from repro_torch.kernels.dpi_mlp import (dpi_params_from_numpy,
                                             init_dpi_params, ternarize)
    return dpi_params_from_numpy(ternarize(init_dpi_params(7, device=CPU)),
                                 device=CPU)


def registry() -> List[EntryPoint]:
    from repro_torch.core import pipeline as pipe
    from repro_torch.kernels import fused_chain, ops
    from repro_torch.kernels import reduce as red

    def aes_args():
        rng = np.random.default_rng(3)
        blocks = torch.from_numpy(rng.integers(0, 256, (8, 16),
                                               dtype=np.uint8))
        return (blocks, _round_keys()), {}

    def crc_args():
        # a 64-byte MTU: the plain version's byte loop unrolls in the
        # trace, so a 4 KiB row would take dynamo most of a minute
        return (_payload(mtu=64), torch.tensor([8, 16, 64, 1],
                                               dtype=torch.int32)), {}

    def dpi_args():
        return (_payload(), _dpi_params()), {}

    def preproc_args():
        rng = np.random.default_rng(9)
        return (torch.from_numpy(rng.integers(0, 1 << 20, (16, 39),
                                              dtype=np.int32)),), {}

    def fused_args():
        return (_payload(), _round_keys(), _dpi_params()), {}

    def fold_args():
        rng = np.random.default_rng(11)
        return (torch.from_numpy(
            rng.standard_normal((4, 512)).astype(np.float32)),), {}

    def chunk_args():
        rng = np.random.default_rng(12)
        return (torch.from_numpy(rng.integers(0, 256, (4, 512),
                                              dtype=np.uint8)),), {}

    return [
        EntryPoint("rx_pipeline[gbn]", pipe.rx_pipeline, _rx_args(0)),
        EntryPoint("rx_pipeline[sr]", pipe.rx_pipeline, _rx_args(1)),
        EntryPoint("rx_pipeline_batched[gbn]", pipe.rx_pipeline_batched,
                   _rx_args(0)),
        EntryPoint("rx_pipeline_batched[sr]", pipe.rx_pipeline_batched,
                   _rx_args(1)),
        EntryPoint("tx_pipeline", pipe.tx_pipeline, _tx_args),
        EntryPoint("tx_pipeline_batched", pipe.tx_pipeline_batched,
                   _tx_args),
        EntryPoint("kernels.aes_ecb[ref]",
                   lambda b, rk: ops.aes_ecb(b, rk, impl="ref"),
                   aes_args, site=ops.aes_ecb),
        EntryPoint("kernels.aes_ecb[ref,decrypt]",
                   lambda b, rk: ops.aes_ecb(b, rk, decrypt=True,
                                             impl="ref"),
                   aes_args, site=ops.aes_ecb),
        EntryPoint("kernels.crc32_int32[ref]",
                   lambda p, n: ops.crc32_int32(p, n, impl="ref"),
                   crc_args, site=ops.crc32_int32),
        EntryPoint("kernels.dpi_scores[ref]",
                   lambda p, w: ops.dpi_scores(p, w, impl="ref"),
                   dpi_args, site=ops.dpi_scores),
        # n_dense/modulus/tile_recs are Python-static config (callers
        # close over them) — trace them closed so only tensors are traced
        EntryPoint("kernels.preproc[ref]",
                   lambda r: ops.preproc(r, 13, 100_000, impl="ref"),
                   preproc_args, site=ops.preproc),
        EntryPoint("kernels.preproc_tile[ref]",
                   lambda r: ops.preproc_tile(r, 13, 100_000, tile_recs=32,
                                              impl="ref"),
                   preproc_args, site=ops.preproc_tile),
        EntryPoint("kernels.chunk_reduce[ref]",
                   lambda p: ops.chunk_reduce(p, impl="ref"),
                   chunk_args, site=ops.chunk_reduce),
        EntryPoint("kernels.reduce_fold_ref", red.reduce_fold_ref,
                   fold_args),
        EntryPoint("kernels.fused_decrypt_dpi[ref]",
                   lambda p, rk, w: fused_chain.fused_decrypt_dpi(
                       p, rk, w, impl="ref"),
                   fused_args, site=fused_chain.fused_decrypt_dpi),
        EntryPoint("kernels.fused_decrypt_dpi_tile[ref]",
                   lambda p, rk, w: fused_chain.fused_decrypt_dpi_tile(
                       p, rk, w, impl="ref"),
                   fused_args, site=fused_chain.fused_decrypt_dpi_tile),
    ]


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------

def _frame_of(reason) -> Tuple[str, int, str]:
    stack = getattr(reason, "user_stack", None) or []
    if not stack:
        return "<unknown>", 0, "<unknown>"
    fs = stack[-1]
    return relpath(fs.filename), fs.lineno, fs.name


def _f64_ops(graphs) -> List[str]:
    found = set()
    for gm in graphs:
        for node in gm.graph.nodes:
            val = node.meta.get("example_value")
            vals = val if isinstance(val, (tuple, list)) else (val,)
            if any(isinstance(v, torch.Tensor) and v.dtype == torch.float64
                   for v in vals):
                found.add(str(node.target) if node.op != "placeholder"
                          else f"input {node.name}")
    return sorted(found)


def _trace(ep: EntryPoint, args, kwargs):
    """(graphs, break reasons) of one entry: the ``fullgraph`` trace,
    and where it breaks, ``explain``'s enumeration of every break."""
    import torch._dynamo as dynamo
    graphs = []

    def collect(gm, example_inputs):
        graphs.append(gm)
        return gm.forward

    dynamo.reset()
    try:
        torch.compile(ep.fn, backend=collect, fullgraph=True)(*args,
                                                              **kwargs)
        return graphs, []
    except (dynamo.exc.Unsupported, dynamo.exc.UserError):
        pass                 # a break (or a data-dependent guard) ends it
    dynamo.reset()
    ex = dynamo.explain(ep.fn)(*args, **kwargs)
    return list(ex.graphs), list(ex.break_reasons)


def check_entry(ep: EntryPoint) -> List[Violation]:
    from repro_torch.analysis.census import sync_census
    path, line = _def_site(ep.site or ep.fn)
    out: List[Violation] = []
    try:
        args, kwargs = ep.args()
        graphs, breaks = _trace(ep, args, kwargs)
    except Exception as e:    # noqa: BLE001 (a tracing failure is a finding)
        return [Violation(
            "concretization", path, line,
            f"entry `{ep.name}` raised {type(e).__name__} during tracing")]

    seen = set()
    for b in breaks:
        bpath, bline, bfn = _frame_of(b)
        reason = str(b.reason).strip().splitlines()[0]
        msg = (f"entry `{ep.name}` breaks the graph in `{bfn}`: "
               f"{reason}")
        if (bpath, msg) in seen:
            continue
        seen.add((bpath, msg))
        out.append(Violation("graph-break", bpath, bline, msg))

    f64 = _f64_ops(graphs)
    if f64:
        out.append(Violation(
            "f64-promotion", path, line,
            f"entry `{ep.name}` carries float64 through {f64}"))

    args, kwargs = ep.args()
    with sync_census() as c:
        ep.fn(*args, **kwargs)
    if c.d2h:
        # "path:line (fn)" -> "path (fn)": fingerprints ignore lines
        sites = sorted({f"{s.split(':')[0]} {s.split(' ', 1)[1]}"
                        for s in c.sites["d2h"]})
        out.append(Violation(
            "host-sync", path, line,
            f"entry `{ep.name}` reads the device back {c.d2h} time(s) a "
            f"call at {sites}"))
    return out


def run(names: Optional[List[str]] = None) -> List[Violation]:
    out: List[Violation] = []
    log = logging.getLogger("torch._dynamo")
    level = log.level
    log.setLevel(logging.ERROR)       # dynamo logs every break it makes
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for ep in registry():
                if names is not None and ep.name not in names:
                    continue
                out.extend(check_entry(ep))
    finally:
        log.setLevel(level)
    return out
