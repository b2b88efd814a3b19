"""Step cost counter for the dry run — the port's counterpart of the
reference's ``repro.launch.hlo_analysis``.

The reference parses the compiled HLO of one SPMD partition.  The port
compiles no HLO: its step is eager PyTorch.  The dry run places every
argument of the step as a ``DTensor`` of ``meta`` blocks on the
production mesh, so DTensor's own sharding propagation partitions the
step, and ``count_step`` walks it under a ``TorchDispatchMode`` that sees
one rank's share: the local ops DTensor runs on its blocks, forward and
backward, and the collectives it issues to redistribute them.  It
counts:

  * flops — dot ops by ``torch.utils.flop_counter``'s formulas (2*M*N*K,
    the reference's ``_dot_flops``; also kept apart as ``dot_flops``),
    one FLOP per output element for the counterparts of the reference's
    ``ELEMENTWISE`` set, and one per operand element for reductions;
  * bytes — operand + result bytes of every op that moves data.  Eager
    runs no fusion, so this is an upper bound on the reference's
    post-fusion bytes;
  * collectives — every ``_c10d_functional`` op and DTensor's own
    all-to-all (DTensor's and the port's: the shard_map MoE's), bytes
    and elements by kind and group size, priced by the reference's ring
    model.  An all-reduce of an all-reduce's result (DTensor reduces a
    tensor partial over several mesh axes one axis at a time) counts as
    one all-reduce over the product group, as GSPMD emits it, and so,
    on a mesh with an axis cut into factors, does a collective DTensor
    issues over each factor in turn (``factor_batch``); an all-to-all
    that sends its whole block to one rank is a collective-permute;
  * reads — whether the step reads each argument's data
    (``Cost.read_of``), the dry run's count of XLA's arguments;
  * memory — the local blocks live after each op, as eager PyTorch
    assigns buffers (``Blocks``): ``Cost.peak_bytes``, the most live at
    once, arguments included, and ``Cost.temp_bytes``, the most held by
    blocks that are neither arguments nor outputs (XLA's
    ``temp_size_in_bytes``; ``Cost.held``);
  * with ``BY_SOURCE`` set (off by default), each kind's elements and
    the dot FLOPs split by the code that issued them (``Cost.by_source``,
    keyed ``"kind | source"``, ``_source``): the innermost frame of the
    port's model, train or optim code, ``bwd`` in the backward pass.

Under ``sharding.gspmd_partitioning`` a DTensor op may also be
partitioned as the reference's partitioner does it
(``sharding.weight_grad_slab``, ``sharding.reduced_product``).

Not counted: the ops DTensor's propagation runs once per new op at the
global shape to learn its output's shape (``_propagate_tensor_meta``).
An op DTensor has no sharding strategy for (or cannot redistribute
for: torch 2.11 on some nested shardings) runs on its inputs gathered to
``Replicate()``, and a view that cannot split a dimension it unflattens
(4 heads over 16 ranks) on its input gathered from that dimension on:
the gathers are counted and the op is named in ``replicated_ops``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
import sys
import threading
import traceback
import warnings
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.parallel import sharding as sh

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

# the aten counterparts of the reference's ELEMENTWISE HLO opcodes (and
# the activations XLA would lower to them): one FLOP an output element
ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "exp", "log", "log1p", "tanh", "rsqrt", "sqrt", "pow", "sigmoid",
    "sign", "floor", "ceil", "cos", "sin", "where", "eq", "ne", "lt", "le",
    "gt", "ge", "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "clamp",
    "clamp_min", "clamp_max", "_to_copy", "silu", "gelu", "log_sigmoid_forward",
    "reciprocal", "square", "erf", "round", "remainder", "fmod",
    "silu_backward", "gelu_backward", "sigmoid_backward", "tanh_backward",
    "threshold_backward", "log_sigmoid_backward", "lerp", "addcmul",
    "addcdiv",
}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
              "prod", "argmax", "argmin", "var", "std", "norm",
              "linalg_vector_norm", "_log_softmax", "_softmax", "cumsum",
              "_log_softmax_backward_data", "_softmax_backward_data"}
# ops that move no data: views, metadata, allocation
NO_TRAFFIC = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "slice", "select", "unsqueeze", "squeeze", "detach", "alias",
    "as_strided", "empty", "empty_like", "empty_strided", "new_empty",
    "split", "split_with_sizes", "unbind", "chunk", "narrow", "movedim",
    "unflatten", "flatten", "lift_fresh", "_reshape_alias", "view_as",
    "diagonal", "expand_as", "set_", "resize_", "zeros_like_", "wait_tensor",
}
# ops that allocate without writing, and ops whose result is their
# input's buffer (``Blocks.made``): a functional collective's autograd
# wrap of its result (its meta kernel allocates anew)
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty"}
_ALIASES = {"_wrap_tensor_autograd"}
COLLECTIVES = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all"}    # DTensor's own


# the dot ops: the reference's ``dot`` and ``convolution`` HLO opcodes
DOT_OPS = {"mm", "bmm", "addmm", "baddbmm", "convolution",
           "convolution_backward"}


# a block live at a peak: (bytes, the op that made it, its shape, dtype)
BlockAtPeak = Tuple[int, str, Tuple[int, ...], str]


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_traffic: float = 0.0      # ring-model per-device traffic
    dot_flops: float = 0.0         # the share of ``flops`` in dot ops
    # ops with no DTensor sharding strategy, run replicated: name -> runs
    replicated_ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the elements beside the bytes of ``coll_bytes``, key by key: the
    # data moved, whatever its dtype
    coll_elements: Dict[str, float] = dataclasses.field(default_factory=dict)
    # (mesh axis, factors): the first view that needed that axis cut
    # into factors (``sharding.split_factors``), run gathered here; the
    # dry run walks the step again on a mesh so cut
    axis_cut: Optional[tuple] = None
    # the storages of the watched tensors (``CostMode.watch``) read
    read: set = dataclasses.field(default_factory=set)
    # with ``BY_SOURCE``: "kind | source" -> elements (a collective's) or
    # FLOPs ("dot | source")
    by_source: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the blocks the walk held (``Blocks``), and from them (``held``) the
    # most bytes live at once, arguments included, and the most held by
    # blocks that are neither arguments nor outputs
    blocks: Optional["Blocks"] = None
    peak_bytes: int = 0
    temp_bytes: int = 0
    # the arguments' and outputs' blocks (``held``)
    kept: set = dataclasses.field(default_factory=set)

    def read_of(self, t: torch.Tensor) -> bool:
        """Whether the walk read the watched ``t``'s data (a DTensor's
        block's, or a view's of it)."""
        return storage_key(_block(t)) in self.read

    def held(self, outputs: Sequence[torch.Tensor]) -> None:
        """``peak_bytes`` and ``temp_bytes`` from ``blocks``, the step's
        outputs ``outputs`` (DTensors or their blocks) as the walk left
        them."""
        out = self.blocks.at_end(_block(t) for t in outputs)
        self.kept = self.blocks.arguments | out
        self.peak_bytes = self.blocks.peak()
        self.temp_bytes = self.blocks.peak(self.kept)

    def temp_blocks(self) -> List[BlockAtPeak]:
        """The blocks that make up ``temp_bytes`` (after ``held``),
        largest first: ``Blocks.at_peak`` of the blocks that are neither
        arguments nor outputs."""
        return self.blocks.at_peak(self.kept)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.dot_flops += other.dot_flops * mult
        self.bytes += other.bytes * mult
        self.coll_traffic += other.coll_traffic * mult
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * mult
        for k, v in other.coll_elements.items():
            self.coll_elements[k] = self.coll_elements.get(k, 0.0) + v * mult
        for k, v in other.by_source.items():
            self.by_source[k] = self.by_source.get(k, 0.0) + v * mult

    def add_collective(self, kind: str, g: int, result_bytes: float,
                       elements: float, w: float = 1.0,
                       source: Optional[str] = None):
        key = f"{kind}(g={g})"
        self.coll_bytes[key] = self.coll_bytes.get(key, 0.0) \
            + w * result_bytes
        self.coll_elements[key] = self.coll_elements.get(key, 0.0) \
            + w * elements
        self.coll_traffic += w * _collective_traffic(kind, result_bytes, g)
        if not self.coll_bytes[key]:
            del self.coll_bytes[key], self.coll_elements[key]
        if source is not None:
            self.note_source(f"{key} | {source}", w * elements)

    def note_source(self, key: str, amount: float) -> None:
        self.by_source[key] = self.by_source.get(key, 0.0) + amount
        if not self.by_source[key]:
            del self.by_source[key]


class Blocks:
    """The local blocks one rank's step holds, as eager PyTorch assigns
    buffers: a block is allocated when an op returns it on a storage of
    its own and freed when that storage dies (a finalizer on the
    storage; a view shares its base's).  ``log`` holds (block, +bytes)
    at each allocation and (block, -bytes) at each free, in order; the
    arguments are live from the start.

    A scan step that stands for ``n`` (``count_as``) is one ``_Scan``:
      * each block it made and still live at its end counts ``n`` times
        (the loop holds every step's copy: ``stand_for``);
      * the state it passes on (``carry``) and what dies with it (its
        graph) keep their other copies until the scan's backward is done
        where the loop's next step would keep them: the graph always, the
        state's data if the step saved the state it took (``_settle``);
      * its backward stands for the loop's second step back: one copy of
        each block is gone when it starts (``backward``), a block that
        dies frees one more, the rest go when it is done (``done``);
      * a gradient that leaves it has the loop's running sum beside it
        (``summed``);
      * a rematerialized step's first run kept nothing (``recomputed``).
    """

    def __init__(self):
        self.log: List[Tuple[int, int]] = []
        # storage key -> [block, bytes, its scan's copies of it, scan,
        #                 the storages it lives under]
        self.live: Dict[int, list] = {}
        self.arguments: set = set()
        self.made_so_far = 0        # the id the next block takes
        self.device: Optional[torch.device] = None
        self.open = True
        self._dying: list = []      # (block, copies, scan): died in a
        #                             scan's forward since the last op
        self._gone: set = set()     # blocks whose free is logged already
        self._sums: list = []       # gradients to sum before the next op
        self._probes: set = set()   # blocks no op has moved data in yet
        # block -> (the op that made it, its shape, its dtype)
        self.what: Dict[int, Tuple[str, Tuple[int, ...], str]] = {}

    def argument(self, t: torch.Tensor) -> None:
        if self.device is None:
            self.device = t.device
        if storage_key(t) not in self.live:
            self.arguments.add(self._new(t))

    def made(self, name: str, ins: Sequence[torch.Tensor],
             outs: Sequence[torch.Tensor]) -> None:
        """Op ``name``'s inputs and results on the step's device (its
        arguments', else its first op's): a storage not yet live is a new
        block, made by the op (a result) or just before it, outside any
        op (an input: ``torch.tensor`` on the device).  A block an
        allocation (``empty``) makes counts from the first op that moves
        data in it: one that none does is a shape probe (a stride, a
        global shape), no rank's memory."""
        if self._sums:
            self._add_sums()
        if self._dying:
            self._settle()
        probe = name in _ALLOCATIONS
        if name in _ALIASES and ins:
            self._alias(_unwrap(ins[0]), outs)
        for t, by in (*((t, "input") for t in ins),
                      *((t, name) for t in outs)):
            t = _unwrap(t)
            if self.device is None:
                self.device = t.device
            if t.device != self.device:
                continue
            entry = self.live.get(storage_key(t))
            if entry is None:
                self._new(t, probe, by)
            elif entry[0] in self._probes and name not in NO_TRAFFIC:
                self._probes.discard(entry[0])
                self.log.append((entry[0], entry[1]))

    def _alias(self, t: torch.Tensor, outs: Sequence[torch.Tensor]) -> None:
        """``outs``: ``t``'s buffer under other storages (the meta kernel
        of an op that returns its input wrapped allocates anew)."""
        entry = self.live.get(storage_key(t))
        for o in outs:
            k = storage_key(o)
            if entry is not None and k not in self.live:
                self.live[k] = entry
                entry[4] += 1
                weakref.finalize(o.untyped_storage(), self._died, k,
                                 entry[0]).atexit = False

    def _entries(self) -> List[list]:
        """The live blocks, each once (an aliased one has several
        storage keys)."""
        return list({id(e): e for e in self.live.values()}.values())

    def _new(self, t: torch.Tensor, probe: bool = False,
             name: str = "argument") -> int:
        st, b = t.untyped_storage(), self.made_so_far
        self.made_so_far += 1
        self.what[b] = (name, tuple(t.shape), str(t.dtype))
        self.live[st._cdata] = [b, st.nbytes(), 0, None, 1]
        if probe:
            self._probes.add(b)
        else:
            self.log.append((b, st.nbytes()))
        weakref.finalize(st, self._died, st._cdata, b).atexit = False
        return b

    def _died(self, key: int, b: int) -> None:
        entry = self.live.get(key)
        if not self.open or entry is None or entry[0] != b:
            return
        del self.live[key]
        entry[4] -= 1
        if entry[4]:
            return          # its buffer lives on under another storage
        _, size, copies, scan, _ = entry
        if b in self._gone or b in self._probes:
            self._probes.discard(b)
            return
        if scan is not None and scan.state == "backward":
            scan.held.append((b, copies, None))
            size -= copies
        elif scan is not None and scan.state == "forward" and copies:
            self._dying.append((b, copies, scan))
        self.log.append((b, -size))

    def _settle(self) -> None:
        """The blocks of a scan that died together since the last op,
        where the state the step passes on died with them: the loop's
        later steps keep their other copies (``_Scan.kept``: the state's
        own data only if saved) until the scan's backward is done."""
        dying, self._dying = self._dying, []
        with_state = {scan for b, _, scan in dying if b in scan.state_out}
        for b, copies, scan in dying:
            if scan in with_state and (b not in scan.state_out
                                       or b in scan.kept):
                scan.held.append((b, copies, len(self.log)))
                self.log.append((b, copies))

    def _add(self, entry: list, extra: int) -> None:
        entry[1] += extra
        self.log.append((entry[0], extra))

    def _of(self, ts: Sequence[torch.Tensor]) -> List[Optional[int]]:
        return [self.live.get(storage_key(_block(t)), [None])[0]
                for t in ts]

    def stand_for(self, scan: "_Scan", since: int,
                  state_in: Sequence[torch.Tensor],
                  state_out: Sequence[torch.Tensor], saved: set) -> None:
        """The step's end: each block made from ``since`` on and live now
        counts ``scan.n`` times what it counted, but ``state_out``, the
        state passed on, only where the step saved ``state_in``'s (in
        ``saved``: ``_saving``): the loop's later steps keep it."""
        for t_in, b in zip(state_in, self._of(state_out)):
            if b is not None:
                scan.state_out.add(b)
                if _block(t_in)._cdata in saved:
                    scan.kept.add(b)
        for entry in self._entries():
            if entry[0] >= since and entry[0] not in self.arguments \
                    and entry[0] not in self._probes \
                    and (entry[0] not in scan.state_out
                         or entry[0] in scan.kept):
                extra = int(entry[1] * (scan.n - 1))
                entry[2], entry[3] = entry[2] + extra, scan
                self._add(entry, extra)
        if scan.state == "forward":
            # the state it took, should its first run turn out to have
            # saved nothing (``recomputed``): gone here
            for b in self._of(state_in):
                if b is not None and b not in self.arguments:
                    scan.took.append((b, len(self.log)))
                    self.log.append((b, 0))

    def recomputed(self, scan: "_Scan") -> None:
        """The step is recomputed for its backward: its first run (a
        rematerialized block's) kept nothing, so the copies its state
        held and the state it took went at its end."""
        self._settle()
        for b, copies, at in scan.held:
            if at is not None:
                self.log[at] = (b, 0)
        scan.held = [h for h in scan.held if h[2] is None]
        for b, at in scan.took:
            entry = next((e for e in self._entries() if e[0] == b), None)
            if entry is not None:
                self.log[at] = (b, -entry[1])
                self._gone.add(b)
        scan.took = []

    def summed(self, scan: "_Scan", t: torch.Tensor, into_grad: bool
               ) -> None:
        """``t``, a step's gradient that leaves it: the loop sums its
        steps' into one buffer, out of place (as under any dispatch
        mode), so the running sum and the new sum are live beside it for
        a moment — when the engine adds it, before the next op; the
        running sum stays until the scan's backward is done, but where
        ``t`` goes into a ``.grad`` (``into_grad``), which ``t`` itself
        then stands for."""
        entry = self.live.get(storage_key(t))
        if entry is not None and entry[0] not in self.arguments:
            self._sums.append((entry[0], entry[1], into_grad, scan))

    def _add_sums(self) -> None:
        sums, self._sums = self._sums, []
        for b, size, into_grad, scan in sums:
            self.log.append((b, 2 * size))
            self.log.append((b, -2 * size if into_grad else -size))
            if into_grad:
                continue
            if scan.state == "done":
                self.log.append((b, -size))
            else:
                scan.held.append((b, size, None))

    def backward(self, scan: "_Scan") -> None:
        """The scan's backward starts: the walk's step stands for the
        loop's second step back, the last step's copies already gone."""
        self._settle()
        scan.state = "backward"
        if not self.open or scan.n <= 1:
            return
        for entry in self._entries():
            if entry[3] is scan and entry[2]:
                one = int(entry[2] / (scan.n - 1))
                entry[2] -= one
                self._add(entry, -one)
        for i, (b, copies, at) in enumerate(scan.held):
            one = int(copies / (scan.n - 1))
            scan.held[i] = (b, copies - one, at)
            self.log.append((b, -one))

    def done(self, scan: "_Scan") -> None:
        """The scan's backward is done: the copies its blocks held go."""
        self._settle()
        if scan.state == "backward" and self.open:
            for b, copies, _ in scan.held:
                self.log.append((b, -copies))
            scan.held = []
        scan.state = "done"

    def close(self) -> None:
        self._add_sums()
        self._settle()
        self.open = False

    def at_end(self, ts) -> set:
        """The blocks of ``ts`` live when the log was closed."""
        return {self.live[storage_key(t)][0] for t in ts
                if storage_key(t) in self.live}

    def peak(self, leave_out=frozenset()) -> int:
        """The most bytes live at once, the blocks ``leave_out`` apart."""
        live = peak = 0
        for b, n in self.log:
            if b not in leave_out:
                live += n
                peak = max(peak, live)
        return peak

    def at_peak(self, leave_out=frozenset()) -> List[BlockAtPeak]:
        """The blocks live at ``peak(leave_out)``'s first reading, largest
        first: a cell's working memory split by block."""
        log = [(b, n) for b, n in self.log if b not in leave_out]
        live = peak = end = 0
        for i, (b, n) in enumerate(log):
            live += n
            if live > peak:
                peak, end = live, i + 1
        held: Dict[int, int] = {}
        for b, n in log[:end]:
            held[b] = held.get(b, 0) + n
        return sorted(((n, *self.what.get(b, ("?", (), "?")))
                       for b, n in held.items() if n > 0), reverse=True)


class _Scan:
    """One ``count_as`` step's scan, for ``Blocks``: its trip count; its
    state ("forward", "backward" once a node of its backward runs,
    "done"); the copies (block, copies, the log's place of their keeping
    in the forward) held until its backward is done; the blocks of the
    state it passes on, and those of them kept; the state it took."""

    def __init__(self, n: float):
        self.n, self.state, self.held, self.left = n, "forward", [], 0
        self.state_out: set = set()
        self.kept: set = set()
        self.took: list = []


def _collective_traffic(kind: str, result_bytes: float, g: int) -> float:
    """Per-device ring-model traffic for one collective."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return result_bytes
    return result_bytes


def _tensors(tree) -> List[torch.Tensor]:
    out = []
    for x in (tree if isinstance(tree, (list, tuple)) else (tree,)):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def _nbytes(ts: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(args) -> int:
    import torch.distributed.distributed_c10d as c10d
    return c10d._resolve_process_group(_group_name(args)).size()


class _Quiet(threading.local):
    depth = 0


_QUIET = _Quiet()


def _quiet(fn):
    """``fn`` with counting off: DTensor's propagation runs each new op
    once at the global shape to learn its output's shape; that run is
    no rank's work."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        _QUIET.depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _QUIET.depth -= 1
    run.quiet_of = fn
    return run


def _propagator():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    return ShardingPropagator


# split each collective kind's elements and the dot FLOPs by the code
# that issued them (``Cost.by_source``); off unless set, as
# ``tests/_dryrun_survey.py --sources`` sets it
BY_SOURCE = False

# the port's layers below the model whose frames name no source
_INFRA = ("/parallel/", "/launch/")
_FRAME = re.compile(r'File "([^"]+)", line \d+, in (\S+)')


def _model_frame(frames) -> Optional[str]:
    """``"models/moe.py:_moe_flat"``: the innermost of ``frames`` ((file,
    function) pairs, outermost first) in ``repro_torch``, its parallel
    and launch layers apart (a live frame's function by its qualified
    name, as the reference's HLO names it; a recorded one's by its
    name)."""
    for path, fn in reversed(list(frames)):
        path = path.replace("\\", "/")
        if "/repro_torch/" in path and not any(i in path for i in _INFRA):
            return f"{path.split('/repro_torch/')[-1]}:{fn}"
    return None


def _source() -> str:
    """The code that issued the running op: in the backward pass, the
    innermost model frame (``_model_frame``) of the autograd node being
    run (anomaly mode records where it was made), else the innermost
    one live on the stack; ``bwd `` before it in the backward pass,
    ``?`` where neither names one."""
    node = torch._C._current_autograd_node()
    where = None
    if node is not None:
        where = _model_frame(_FRAME.search(line).groups()
                             for line in node.metadata.get("traceback_", ())
                             if _FRAME.search(line))
    if where is None:
        frames, f = [], sys._getframe(1)
        while f is not None:
            frames.append((f.f_code.co_filename, f.f_code.co_qualname))
            f = f.f_back
        where = _model_frame(reversed(frames))
    return ("bwd " if node is not None else "") + (where or "?")


class CostMode(TorchDispatchMode):
    """Counts every aten op run under it into ``self.cost``, each weighted
    by ``self.weight`` (``count_as`` raises it for one step of a scan
    that stands for many).  An op on DTensors is left to DTensor's
    dispatch, whose local ops and collectives come back here.
    ``by_source``: split the collectives and dot FLOPs by ``_source``."""

    def __init__(self, by_source: bool = False):
        super().__init__()
        self.cost = Cost(blocks=Blocks())
        self.by_source = by_source
        self.weight = 1.0
        self.stack: List[float] = []
        self._pass: Optional[Callable] = None
        self._reduced = None      # (weakref to the result, g, bytes,
        #                           elements, weight, source) all-reduce,
        #                           for chaining
        # the storages of the tensors whose reads are watched: an
        # argument's kept alive, so that no other storage takes its key,
        # another's (``watch(..., tag)``) until it dies, read as its tag
        self.watched: Dict[int, object] = {}
        # the collectives of an op or a redistribution on a mesh with a
        # factored axis, held to be merged (``factor_batch``): [the axis
        # of each factor's group, chains, the chain each storage derives
        # from]
        self._batch: Optional[list] = None

    def watch(self, ts: Sequence[torch.Tensor], tag=None) -> None:
        """Record from now on whether the walk reads the data of each of
        ``ts`` (a DTensor's block) or of a view of it: ``Cost.read_of``;
        with ``tag``, a tensor the step makes, not held (its read puts
        ``tag`` in ``Cost.read``)."""
        for t in ts:
            t = _block(t)
            k = storage_key(t)
            if tag is None:
                self.watched[k] = t
            else:
                self.watched[k] = tag
                weakref.finalize(t.untyped_storage(), self.watched.pop, k,
                                 None).atexit = False

    def __enter__(self):
        _MODES.append(self)
        prop = _propagator()
        if len(_MODES) == 1:
            prop._propagate_tensor_meta_non_cached = _quiet(
                prop._propagate_tensor_meta_non_cached)
            for mod in _redistributors():
                mod.redistribute_local_tensor = _batched(
                    mod.redistribute_local_tensor)
        return super().__enter__()

    def __exit__(self, *exc):
        _MODES.remove(self)
        prop = _propagator()
        if not _MODES:
            prop._propagate_tensor_meta_non_cached = \
                prop._propagate_tensor_meta_non_cached.quiet_of
            for mod in _redistributors():
                mod.redistribute_local_tensor = \
                    mod.redistribute_local_tensor.batched_of
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _QUIET.depth:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            if self._pass is func:
                self._pass = None
                return NotImplemented
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _dtensor_op(self, func, args, kwargs):
        """DTensor's dispatch of ``func`` (or, under
        ``sharding.gspmd_partitioning``, a weight gradient's slab), with
        this mode active again so that its local ops and collectives are
        counted; a product's partial sums reduced where it makes them
        (``sharding.reduced_product``)."""
        x = next((a for a in _tensors(list(args) + list(kwargs.values()))
                  if isinstance(a, DTensor)), None)
        with factor_batch(getattr(x, "device_mesh", None)):
            return self._dtensor_op_on(func, args, kwargs)

    def _dtensor_op_on(self, func, args, kwargs):
        with _reentered(self):
            out = sh.weight_grad_slab(func, args)
            if out is None:
                out = sh.product_into_chunks(func, args)
            if out is None:
                out = sh.involuntary_full_remat(func, args)
            if out is None:
                out = sh.rows_regrouped_pointwise(func, args)
            if out is None and func.__name__ in sh.OWN_RULES:
                out = sh.gspmd_fallback(func, args, kwargs)
            if out is None:
                out = sh.split_view(func, args)
            if out is None:
                out = sh.split_kept(func, args)
            if out is None:
                out = sh.cat_kept(func, args)
            if out is None:
                out = sh.slice_backward_kept(func, args)
            if out is None:
                out = sh.local_pointwise(func, args, kwargs)
            if out is None:
                out = sh.masked_gather(func, args)
            if out is None:
                out = sh.partial_scatter_add(func, args)
            if out is None:
                out = sh.uneven_cat(func, args)
            if out is None:
                out = sh.halo_slice(func, args)
        if out is None:
            out = self._dispatched(func, args, kwargs)
        with _reentered(self):
            return sh.reduced_product(func, out)

    def _dispatched(self, func, args, kwargs):
        """DTensor's dispatch of ``func``; an op it has no sharding
        strategy for runs replicated, and a view that cannot split a
        dimension it unflattens runs on its input gathered there."""
        self._pass = func
        with _reentered(self):
            try:
                return func(*args, **kwargs)
            except NotImplementedError as e:
                if "sharding strategy" not in str(e):
                    raise
                self._pass = None
                out = sh.gspmd_fallback(func, args, kwargs)
                return self._replicated(func, args, kwargs) \
                    if out is None else out
            except IndexError as e:
                # torch 2.11's redistribution planner fails on some
                # nested shardings: the op runs replicated
                if not traceback.extract_tb(e.__traceback__)[-1] \
                        .filename.endswith("_redistribute.py"):
                    raise
                self._pass = None
                return self._replicated(func, args, kwargs)
            except RuntimeError as e:
                if not any(m in str(e) for m in _UNSPLIT_VIEW):
                    raise
                self._pass = None
                x, shape = args[0], args[1]
                if self.cost.axis_cut is None:
                    # the walk goes on: an exception out of a
                    # rematerialized block's forward leaves torch 2.11's
                    # checkpoint state broken
                    self.cost.axis_cut = sh.split_factors(x, shape)
                first = next((i for i, (a, b) in enumerate(zip(
                    x.shape, shape)) if a != b), min(len(shape), x.ndim))
                want = [Replicate() if q.is_shard() and q.dim >= first
                        else q for q in x.placements]
                self._note_replicated(func)
                self._pass = func
                return func(x.redistribute(x.device_mesh, want),
                            *args[1:], **kwargs)

    def _note_replicated(self, func):
        rep, name = self.cost.replicated_ops, func.overloadpacket.__name__
        rep[name] = rep.get(name, 0) + 1

    def _replicated(self, func, args, kwargs):
        """``func`` on its DTensor inputs gathered to ``Replicate()`` (the
        collectives counted), its result replicated."""
        from torch.utils._pytree import tree_map
        if func is torch.ops.aten.detach_.default:
            # moves nothing (torch 2.11 has no strategy for it)
            func(args[0].to_local())
            return args[0]
        if func._schema.is_mutable:
            raise NotImplementedError(
                f"{func}: an in-place op with no sharding strategy")
        mesh = next(a.device_mesh for a in _tensors(list(args)
                    + list(kwargs.values())) if isinstance(a, DTensor))
        repl = [Replicate()] * mesh.ndim

        def whole(a):
            return (a.redistribute(mesh, repl).to_local()
                    if isinstance(a, DTensor) else a)

        out = func(*tree_map(whole, args), **tree_map(whole, kwargs))
        self._note_replicated(func)
        return tree_map(lambda t: DTensor.from_local(
            t, mesh, repl, run_check=False)
            if isinstance(t, torch.Tensor) else t, out)

    def _count(self, func, args, kwargs, out):
        packet = func.overloadpacket
        name = packet.__name__.rstrip("_")
        c, w = self.cost, self.weight
        ins, outs = _tensors(list(args) + list(kwargs.values())), _tensors(out)
        if c.blocks.open:
            c.blocks.made(name, ins, outs)
        if packet in flop_registry:
            f = w * flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += f
            if name in DOT_OPS:
                c.dot_flops += f
                if self.by_source:
                    c.note_source(f"dot | {_source()}", f)
        elif name in ELEMENTWISE:
            c.flops += w * sum(t.numel() for t in outs)
        elif name in REDUCTIONS and ins:
            c.flops += w * ins[0].numel()
        if func.namespace == "_c10d_functional" \
                or func.namespace == "_dtensor" and name in COLLECTIVES:
            self._collective(name, args, outs)
        if name not in NO_TRAFFIC:
            c.bytes += w * (_nbytes(ins) + _nbytes(outs))
            if self.watched:
                self._note_reads(name, args, ins)
        if self._batch is not None and name not in COLLECTIVES:
            chain = next((self._batch[2][k] for k in map(storage_key, ins)
                          if k in self._batch[2]), None)
            if chain is not None:
                for t in outs:
                    self._batch[2][storage_key(t)] = chain

    def _note_reads(self, name, args, ins):
        """The watched storages an op that moves data reads: each input,
        but for the destination of a pure write (``copy_``, ``fill_``,
        ``zero_``) that covers its whole storage — a write into part of
        a buffer keeps the rest, as XLA's dynamic-update-slice reads its
        operand."""
        dest = args[0] if name in _WRITES else None
        for t in ins:
            if t is dest and t.numel() * t.element_size() \
                    == t.untyped_storage().nbytes():
                continue
            k = storage_key(t)
            if k in self.watched:
                w = self.watched[k]
                self.cost.read.add(k if isinstance(w, torch.Tensor) else w)

    def _collective(self, name, args, outs):
        c, w = self.cost, self.weight
        last = self._reduced
        if name not in COLLECTIVES:
            # a wait or a wrap of the last all-reduce's result is that
            # result
            if last is not None and outs and _unwrap(args[0]) is last[0]():
                self._reduced = (weakref.ref(outs[0]),) + last[1:]
            return
        kind, g, rb = COLLECTIVES[name], _group_size(args), _nbytes(outs)
        ne = sum(t.numel() for t in outs)
        src = _source() if self.by_source else None
        if name == "all_to_all_single" and sum(map(bool, args[2])) == 1:
            kind = "collective-permute"     # its whole block to one rank
        self._reduced = None
        if kind != "all-reduce" and self._batch is not None:
            self._hold(kind, g, rb, ne, w, _group_name(args), args, outs,
                       src)
            return
        if kind == "all-reduce":
            if last is not None and _unwrap(args[0]) is last[0]() \
                    and last[4] == w:
                # one reduction over several mesh axes: one collective
                c.add_collective(kind, last[1], -last[2], -last[3], w,
                                 last[5])
                g *= last[1]
            self._reduced = (weakref.ref(outs[0]), g, rb, ne, w, src)
        c.add_collective(kind, g, rb, ne, w, src)


    def _hold(self, kind, g, rb, ne, w, group, args, outs, source=None):
        """A collective of the open batch: one over a factor of a mesh
        axis, of the result of one over another factor of that axis
        (through the local ops between them), of the same kind, joins
        its chain — DTensor moves a split over each mesh dim in turn,
        GSPMD in one collective over the whole axis, of the last one's
        result."""
        factor_of, chains, lineage = self._batch
        axis = factor_of.get(group)
        src = next((lineage[k] for k in map(storage_key, _tensors(args))
                    if k in lineage), None)
        if axis is not None and src is not None:
            c = chains[src]
            if c["kind"] == kind and c["w"] == w and c["axis"] == axis \
                    and group not in c["groups"]:
                c["groups"].add(group)
                c.update(g=c["g"] * g, rb=rb, ne=ne)
                for t in outs:
                    lineage[storage_key(t)] = src
                return
        chains.append({"kind": kind, "g": g, "rb": rb, "ne": ne, "w": w,
                       "axis": axis, "groups": {group}, "src": source})
        for t in outs:
            lineage[storage_key(t)] = len(chains) - 1


@contextlib.contextmanager
def factor_batch(mesh):
    """The collectives issued inside, on a mesh with a factored axis, held
    by each active mode and merged at its end (``CostMode._hold``); a
    batch already open holds them."""
    axes = sh.factored_axes(mesh)
    if not axes or _QUIET.depth or not _MODES \
            or _MODES[-1]._batch is not None:
        yield
        return
    factor_of = {mesh.get_group(m).group_name: a
                 for a, ms in axes.items() if len(ms) > 1 for m in ms}
    for m in _MODES:
        m._batch = [factor_of, [], {}]
    try:
        yield
    finally:
        for m in _MODES:
            _, chains, _ = m._batch
            m._batch = None
            for c in chains:
                m.cost.add_collective(c["kind"], c["g"], c["rb"], c["ne"],
                                      c["w"], c["src"])


def _redistributors():
    """The modules of DTensor that call ``redistribute_local_tensor`` by
    their own name for it."""
    import importlib
    mods = []
    for name in ("_redistribute", "_dispatch", "_api"):
        mod = importlib.import_module(f"torch.distributed.tensor.{name}")
        if hasattr(mod, "redistribute_local_tensor"):
            mods.append(mod)
    return mods


def _batched(fn):
    """DTensor's ``redistribute_local_tensor`` in a ``factor_batch``."""
    @functools.wraps(fn)
    def run(local, current, target, *args, **kwargs):
        with factor_batch(current.mesh):
            return fn(local, current, target, *args, **kwargs)
    run.batched_of = fn
    return run


def _group_name(args) -> str:
    return next(a for a in args if isinstance(a, str)
                and a not in ("sum", "avg", "max", "min"))


# ops that write their first argument without reading it
_WRITES = {"copy", "fill", "zero"}


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage, shared by every view of it."""
    return t.untyped_storage()._cdata


def _block(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


# DTensor's refusals to view a split dimension as several (torch 2.13's
# wording, then 2.11's), torch 2.11's to merge a split dimension into
# the one before it (2.13 splits the merged dim strided), and the local
# view DTensor sizes wrongly where a dim split over two mesh dims is
# cut into dims the pair cannot split (the chunked MoE's rows on the
# 2x16x16 mesh)
_UNSPLIT_VIEW = ("unevenly sharded",
                 "split the sharded dimension",
                 "Attempted to flatten multiple dimensions",
                 "is invalid for input of size")


@contextlib.contextmanager
def _reentered(mode: TorchDispatchMode):
    """``mode`` pushed again inside its own ``__torch_dispatch__``."""
    from torch.utils._python_dispatch import _pop_mode, _push_mode
    _push_mode(mode)
    try:
        yield
    finally:
        _pop_mode()


def _unwrap(t):
    """A functional collective's result may come wrapped (an
    ``AsyncCollectiveTensor``) into the op that uses it."""
    return getattr(t, "elem", t)


_MODES: List[CostMode] = []


def _push_weight(n: float) -> None:
    for m in _MODES:
        m.stack.append(m.weight)
        m.weight *= n


def _pop_weight() -> None:
    for m in _MODES:
        m.weight = m.stack.pop()


class _Hoist(threading.local):
    depth = 0


_HOIST = _Hoist()


def hoisting() -> bool:
    """Whether the forward of a scan step counted by ``count_as(...,
    hoist=True)`` is running."""
    return _HOIST.depth > 0


@contextlib.contextmanager
def loop_invariant():
    """What runs inside counted once for the innermost ``count_as`` (at
    the weight before its step's), as XLA hoists a loop-invariant
    instruction — a collective of a weight — out of the while loop."""
    saved = [(m, m.weight) for m in _MODES]
    for m in _MODES:
        if m.stack:
            m.weight = m.stack[-1]
    try:
        yield
    finally:
        for m, w in saved:
            m.weight = w


def count_as(n: int, fn: Callable, inputs: Sequence[torch.Tensor],
             hoist: bool = False, carry: int = 0):
    """Run ``fn()`` — one step of a scan whose ``n`` steps are alike — and
    count it, forward and backward, as ``n`` steps, as the reference's
    HLO analysis multiplies a while body by its trip count.  Its
    backward: the autograd nodes ``fn`` created (those between its
    outputs and ``inputs``) run under the same weight.  ``hoist``: the
    step's weight reads are loop-invariant (``hoisting``; the MoE's
    chunks: XLA hoists their collectives out of the scan).  ``carry``:
    the last ``carry`` of ``inputs`` are the state the step takes, the
    last ``carry`` of its outputs the state it passes on (for the
    blocks the loop holds: ``Blocks``)."""
    _push_weight(n)
    _HOIST.depth += hoist
    since = [(m.cost.blocks, m.cost.blocks.made_so_far) for m in _MODES]
    saved: set = set()
    try:
        with _saving(saved) if _MODES else contextlib.nullcontext():
            out = fn()
    finally:
        _HOIST.depth -= hoist
        _pop_weight()
    if not _MODES:
        return out
    recompute = torch._C._current_graph_task_id() != -1 \
        and bool(_SCANS.get(fn.__code__))
    if recompute:
        # a rematerialized step, recomputed for its backward: its blocks
        # are the ones the scan's backward frees
        scans = _SCANS[fn.__code__].pop()
        for blocks, scan in scans:
            blocks.recomputed(scan)
    else:
        scans = [(blocks, _Scan(n)) for blocks, _ in since]
        if torch.is_grad_enabled():
            _SCANS.setdefault(fn.__code__, []).append(scans)
    state_in = list(inputs[len(inputs) - carry:]) if carry else []
    state_out = _tensors(out)[-carry:] if carry else []
    for (blocks, first), (_, scan) in zip(since, scans):
        if blocks.open:
            blocks.stand_for(scan, first, state_in, state_out, saved)
    if not torch.is_grad_enabled():
        return out
    stop = {t.grad_fn for t in inputs if t.grad_fn is not None}
    seen, todo = set(), [t.grad_fn for t in _tensors(out)]
    while todo:
        node = todo.pop()
        if node is None or node in seen or node in stop \
                or type(node).__name__ == "AccumulateGrad":
            continue
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
    if not recompute:
        for _, scan in scans:
            scan.left = len(seen)
    # the state's gradient goes back step by step, out of the first one
    state = {id(t) for t in state_in} | {id(t.grad_fn) for t in state_in}
    for node in seen:
        node.register_prehook(functools.partial(_scan_node, scans, True))
        leaving = [(i, type(f).__name__ == "AccumulateGrad")
                   for i, (f, _) in enumerate(node.next_functions)
                   if f is not None and f not in seen and id(f) not in state
                   and id(getattr(f, "variable", None)) not in state]
        if leaving and n > 1:
            node.register_hook(functools.partial(_summed, scans, leaving))
        node.register_hook(functools.partial(_scan_node, scans, False))
    for node in stop:
        node.register_prehook(functools.partial(_scan_done, scans))
    return out


@contextlib.contextmanager
def _saving(saved: set):
    """The tensors autograd saves inside, and the bases of those that
    are views, into ``saved`` by identity (``_cdata``; a DTensor's by its
    block's), on top of whatever saved-tensor hooks are active (a
    rematerialized block's)."""
    outer = torch._C._autograd._top_saved_tensors_default_hooks(False)

    def pack(t):
        b = _block(_unwrap(t))
        saved.update(x._cdata for x in (b, b._base) if x is not None)
        return outer[0](t) if outer else t

    def unpack(x):
        return outer[1](x) if outer else x

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield


# the scans of the steps ``count_as`` ran with autograd on, by the step's
# code, latest last: the one a rematerialized step's recompute is of
_SCANS: Dict[object, list] = {}


def _scan_node(scans, starts: bool, *_):
    """A node of a ``count_as`` step's backward starts (its weight
    pushed) or ends (popped; the scan's backward is done with its last
    node)."""
    if starts:
        _push_weight(scans[0][1].n)
    else:
        _pop_weight()
    for blocks, scan in scans:
        if starts and scan.state == "forward":
            blocks.backward(scan)
        elif not starts:
            scan.left -= 1
            if not scan.left:
                blocks.done(scan)


def _scan_done(scans, *_):
    """A node past the step (an input's) starts: its backward is done."""
    for blocks, scan in scans:
        blocks.done(scan)


def _summed(scans, leaving, grads, _):
    """A step's gradients that leave it (``grads[i]``, ``(i, into a
    .grad)`` in ``leaving``): the loop sums its steps' into one buffer
    (``Blocks.summed``)."""
    for blocks, scan in scans:
        for i, into_grad in leaving:
            if grads[i] is not None and blocks.open:
                blocks.summed(scan, _block(grads[i]), into_grad)


def cut(axis_cut: tuple) -> None:
    """Ask the dry run to walk the step again on the mesh with the axis
    of ``axis_cut`` (``(mesh axis, factors)``) cut into those factors
    (``Cost.axis_cut``), unless an earlier op asked first."""
    for m in _MODES:
        if m.cost.axis_cut is None:
            m.cost.axis_cut = axis_cut


def watch(ts: Sequence[torch.Tensor], tag) -> None:
    """``CostMode.watch`` on every active mode of tensors the step makes,
    read as ``tag``."""
    for m in _MODES:
        m.watch(ts, tag)


def count_step(fn: Callable, watch: Sequence[torch.Tensor] = ()) -> Cost:
    """The cost of ``fn()`` (a step on ``meta`` tensors); ``read_of``
    answers, for each of ``watch`` and each tensor ``fn`` watches
    (``watch``), whether the step read its data.  With ``BY_SOURCE``,
    split by source (the autograd nodes record where they were made)."""
    nodes = contextlib.nullcontext()
    if BY_SOURCE:
        with warnings.catch_warnings():     # its cost is the point here
            warnings.simplefilter("ignore")
            nodes = torch.autograd.detect_anomaly(check_nan=False)
    _SCANS.clear()
    try:
        with nodes, CostMode(by_source=BY_SOURCE) as mode:
            mode.watch(watch)
            for t in watch:
                mode.cost.blocks.argument(_block(t))
            fn()
            mode.cost.blocks.close()
    finally:
        _SCANS.clear()
    return mode.cost
